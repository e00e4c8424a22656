"""Nodal H1 bases (numpy copy of the tensor-product, simplex, prism and
pyramid parts of ``cardiac_ablation_ecm2_tpu/fem/basis.py``).

* Tensor geometries (segment, square, cube): Gauss-Lobatto nodes per
  direction; only the 1D matrices ``B1 (nq1d, p+1)`` and ``G1`` are stored.
  Local dof ordering is lexicographic, i fastest: dof = i + n1d*(j + n1d*k).
* Simplices (triangle, tetrahedron): lattice nodes with the edge nodes at
  the 1D Gauss-Lobatto positions; dense ``B (nq, nd)`` / ``G (nq, nd, dim)``
  from a monomial Vandermonde solve.  Local order: lattice points with
  i + j (+ k) ≤ p, i fastest.
* Prisms: the triangle basis times the 1D Lagrange basis in z (MFEM's
  ``H1_WedgeElement``), dense, on the triangle rule times Gauss in z.
* Pyramids: the rational vertex functions at order 1 and their products at
  higher orders (``fem/pyramid2.py``, ``pyramid3.py``, ``pyramid_p.py``),
  dense, on the collapsed cube rule.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

from .geometry import DIMENSION, EDGES, IS_TENSOR, REF_VERTS, Geometry
from .intrules import gauss_legendre_1d, gauss_lobatto_1d, simplex_rule, tensor_rule


def lagrange_matrices(nodes: np.ndarray, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Lagrange basis through ``nodes`` evaluated at ``x``:
    ``B[q, i] = L_i(x_q)``, ``G[q, i] = L_i'(x_q)`` (monomial Vandermonde
    solve, as in the JAX package)."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    V = np.vander(nodes, n, increasing=True)
    C = np.linalg.solve(V, np.eye(n))
    P = np.vander(x, n, increasing=True)
    dP = np.zeros_like(P)
    dP[:, 1:] = P[:, :-1] * np.arange(1, n)
    return P @ C, dP @ C


@functools.lru_cache(maxsize=None)
def h1_nodes_1d(p: int) -> np.ndarray:
    """H1 nodal points on [0,1] for order p: Gauss-Lobatto (p+1 points)."""
    x, _ = gauss_lobatto_1d(p + 1)
    return x


@functools.lru_cache(maxsize=None)
def l2_nodes_1d(p: int) -> np.ndarray:
    """L2 (discontinuous) nodal points on [0,1]: Gauss-Legendre (p+1 points)."""
    x, _ = gauss_legendre_1d(p + 1)
    return x


def _require_supported(geom: Geometry):
    if geom not in IS_TENSOR:
        raise NotImplementedError(f"{geom!r}: the port covers segments, "
                                  "triangles, squares, tetrahedra, cubes, "
                                  "prisms and pyramids")


@functools.lru_cache(maxsize=None)
def lattice_multi_index(geom: Geometry, p: int) -> np.ndarray:
    """Integer lattice multi-indices of the local nodes, i fastest; shape
    (nd, dim), int64.  Tensor geometries: all of [0,p]^dim; simplices: the
    indices with sum ≤ p; prisms: the triangle's times [0,p] in z; the
    order-1 pyramid: its vertices (a pyramid of order ≥ 2 has no lattice,
    its nodes are ``fem/pyramid_p.py``'s tables)."""
    _require_supported(geom)
    if IS_TENSOR[geom]:
        rng = np.arange(p + 1)
        grids = np.meshgrid(*([rng] * DIMENSION[geom]), indexing="ij")
        return np.stack([g.ravel(order="F") for g in grids], axis=1)
    if geom == Geometry.TRIANGLE:
        out = [(i, j) for j in range(p + 1) for i in range(p + 1 - j)]
    elif geom == Geometry.TETRAHEDRON:
        out = [(i, j, k) for k in range(p + 1) for j in range(p + 1 - k)
               for i in range(p + 1 - j - k)]
    elif geom == Geometry.PRISM:
        out = [(i, j, k) for k in range(p + 1) for j in range(p + 1)
               for i in range(p + 1 - j)]
    else:
        if p != 1:
            raise NotImplementedError(
                "pyramid node layout is not a lattice at p >= 2; "
                "see fem/pyramid_p.py")
        return np.rint(REF_VERTS[geom]).astype(np.int64)
    return np.array(out, dtype=np.int64)


@functools.lru_cache(maxsize=None)
def h1_nodes(geom: Geometry, p: int) -> np.ndarray:
    """Reference coordinates of the local H1 nodes, lex-ordered (nd, dim)."""
    if geom == Geometry.PYRAMID and p >= 2:
        # the rational pyramid's nodes are entity tables, not a lattice
        if p == 2:
            from .pyramid2 import PYRAMID_P2_NODES

            return PYRAMID_P2_NODES
        if p == 3:
            from .pyramid3 import PYRAMID_P3_NODES

            return PYRAMID_P3_NODES
        from .pyramid_p import pyramid_nodes

        return pyramid_nodes(p)
    mi = lattice_multi_index(geom, p)
    if IS_TENSOR[geom]:
        return h1_nodes_1d(p)[mi]
    if geom == Geometry.PRISM:
        # the (edge-warped) triangle nodes, Gauss-Lobatto in z
        tri_mi = lattice_multi_index(Geometry.TRIANGLE, p)
        tri_pts = h1_nodes(Geometry.TRIANGLE, p)
        tmap = {tuple(r): i for i, r in enumerate(tri_mi)}
        xy = np.stack([tri_pts[tmap[(i, j)]] for (i, j, _k) in mi])
        z = h1_nodes_1d(p)[mi[:, 2]]
        return np.concatenate([xy, z[:, None]], axis=1)
    if geom == Geometry.PYRAMID:
        return mi.astype(np.float64)
    # simplices: equispaced lattice with the edge nodes moved to the 1D
    # Gauss-Lobatto positions, so edge traces match the tensor elements'
    pts = mi.astype(np.float64) / max(p, 1)
    if p >= 2:
        rv = REF_VERTS[geom]
        latt_v = np.rint(rv * p).astype(np.int64)
        gll = h1_nodes_1d(p)
        for (la, lb) in EDGES[geom]:
            A, B = latt_v[la], latt_v[lb]
            for t in range(1, p):
                latt = tuple((A * (p - t) + B * t) // p)
                n = np.nonzero((mi == np.array(latt)).all(axis=1))[0]
                if len(n):
                    pts[n[0]] = rv[la] + gll[t] * (rv[lb] - rv[la])
    return pts


@dataclasses.dataclass(frozen=True, eq=False)
class DofToQuad:
    """Basis evaluation data at a quadrature rule, all float64: the rule's
    points (nq, dim) and weights (nq,), plus either the 1D factors
    ``B1``/``G1`` (nq1d, n1d) of a tensor basis (``tensor``) or the dense
    ``B (nq, nd)`` / ``G (nq, nd, dim)``."""

    geom: Geometry
    order: int
    tensor: bool
    points: np.ndarray
    weights: np.ndarray
    B1: Optional[np.ndarray] = None
    G1: Optional[np.ndarray] = None
    B: Optional[np.ndarray] = None
    G: Optional[np.ndarray] = None

    @property
    def dim(self) -> int:
        return DIMENSION[self.geom]

    def full_B(self) -> np.ndarray:
        """The dense (nq, nd) value matrix (the tensor factors' Kronecker
        product, lex order)."""
        if not self.tensor:
            return self.B
        return _lex_kron(self.B1, self.dim, deriv_axis=None)

    def full_G(self) -> np.ndarray:
        """The dense (nq, nd, dim) gradient matrix."""
        if not self.tensor:
            return self.G
        return np.stack([_lex_kron(self.B1, self.dim, deriv_axis=d, G1=self.G1)
                         for d in range(self.dim)], axis=-1)


def _lex_kron(B1: np.ndarray, dim: int, deriv_axis, G1=None) -> np.ndarray:
    """Kronecker product of 1D factors in lex (i fastest) order: entry
    [(qx, qy, qz), (i, j, k)] = Fx[qx, i] Fy[qy, j] Fz[qz, k], with G1 in
    place of B1 along ``deriv_axis``."""
    fac = [G1 if d == deriv_axis else B1 for d in reversed(range(dim))]
    return functools.reduce(np.kron, fac)


@functools.lru_cache(maxsize=None)
def make_dof_to_quad(geom: Geometry, p: int, nq1d: int = None,
                     nodes: str = "h1") -> DofToQuad:
    """Order-p DofToQuad.  Tensor geometries take ``nq1d`` Gauss points
    per direction (default p+2) and their 1D nodes from ``nodes``: "h1"
    Gauss-Lobatto, "l2" Gauss-Legendre; simplices a rule exact to degree
    2·nq1d − 1 (their lattice nodes either way, as the JAX package);
    prisms the triangle's rule times ``nq1d`` Gauss points in z (``nodes``
    choosing the z nodes); pyramids the collapsed ``nq1d``³ cube rule."""
    _require_supported(geom)
    if nq1d is None:
        nq1d = p + 2
    nodes_1d = h1_nodes_1d(p) if nodes == "h1" else l2_nodes_1d(p)
    if geom == Geometry.PRISM:
        pts, wts = prism_rule(nq1d)
        B, G = prism_basis_matrices(p, pts, nodes_1d)
        return DofToQuad(geom=geom, order=p, tensor=False, points=pts,
                         weights=wts, B=B, G=G)
    if geom == Geometry.PYRAMID:
        pts, wts = pyramid_rule(nq1d)
        if p == 2:
            from .pyramid2 import pyramid_p2_basis_matrices

            B, G = pyramid_p2_basis_matrices(pts)
        elif p == 3:
            from .pyramid3 import pyramid_p3_basis_matrices

            B, G = pyramid_p3_basis_matrices(pts)
        elif p >= 4:
            from .pyramid_p import pyramid_p_basis_matrices

            B, G = pyramid_p_basis_matrices(p, pts)
        else:
            B, G = pyramid_basis_matrices(p, pts)
        return DofToQuad(geom=geom, order=p, tensor=False, points=pts,
                         weights=wts, B=B, G=G)
    if IS_TENSOR[geom]:
        xq, _ = gauss_legendre_1d(nq1d)
        B1, G1 = lagrange_matrices(nodes_1d, xq)
        pts, wts = tensor_rule(DIMENSION[geom], nq1d)
        return DofToQuad(geom=geom, order=p, tensor=True, points=pts,
                         weights=wts, B1=B1, G1=G1)
    pts, wts = simplex_rule(DIMENSION[geom], 2 * nq1d - 1)
    B, G = simplex_basis_matrices(geom, p, pts)
    return DofToQuad(geom=geom, order=p, tensor=False, points=pts,
                     weights=wts, B=B, G=G)


def simplex_basis_matrices(geom: Geometry, p: int,
                           pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dense nodal basis of a triangle/tet at ``pts`` by a monomial
    Vandermonde solve: B (npts, nd), G (npts, nd, dim)."""
    dim = DIMENSION[geom]
    mi = lattice_multi_index(geom, p)  # polynomial powers = lattice indices
    nodes = h1_nodes(geom, p)

    def vand(x):
        V = np.ones((len(x), len(mi)))
        for d in range(dim):
            V *= x[:, d][:, None] ** mi[:, d][None, :]
        return V

    C = np.linalg.solve(vand(nodes), np.eye(len(mi)))
    B = vand(pts) @ C
    G = np.zeros((len(pts), len(mi), dim))
    for d in range(dim):
        dmi = mi.copy()
        pw = dmi[:, d].copy()
        dmi[:, d] = np.maximum(pw - 1, 0)
        dV = np.ones((len(pts), len(mi)))
        for e in range(dim):
            dV *= pts[:, e][:, None] ** dmi[:, e][None, :]
        dV *= pw[None, :]
        G[:, :, d] = dV @ C
    return B, G


@functools.lru_cache(maxsize=None)
def prism_rule(nq1d: int):
    """Wedge quadrature: the triangle rule exact to degree 2·nq1d − 1 times
    ``nq1d`` Gauss points in z (nq2·nq1d points, z slowest)."""
    p2, w2 = simplex_rule(2, 2 * nq1d - 1)
    z, wz = gauss_legendre_1d(nq1d)
    nq2, nq1 = len(p2), len(z)
    pts = np.zeros((nq2 * nq1, 3))
    wts = np.zeros(nq2 * nq1)
    for k in range(nq1):
        pts[k * nq2:(k + 1) * nq2, :2] = p2
        pts[k * nq2:(k + 1) * nq2, 2] = z[k]
        wts[k * nq2:(k + 1) * nq2] = w2 * wz[k]
    return pts, wts


def prism_basis_matrices(p: int, pts: np.ndarray, nodes_1d: np.ndarray):
    """Dense wedge nodal basis, the triangle's times the 1D Lagrange basis
    through ``nodes_1d`` in z (MFEM's ``H1_WedgeElement``): B (npts, nd),
    G (npts, nd, 3)."""
    Bt, Gt = simplex_basis_matrices(Geometry.TRIANGLE, p, pts[:, :2])
    Bz, Gz = lagrange_matrices(nodes_1d, pts[:, 2])
    mi = lattice_multi_index(Geometry.PRISM, p)
    tmap = {tuple(r): i for i, r in enumerate(
        lattice_multi_index(Geometry.TRIANGLE, p))}
    B = np.zeros((len(pts), len(mi)))
    G = np.zeros((len(pts), len(mi), 3))
    for n, (i, j, k) in enumerate(mi):
        t = tmap[(i, j)]
        B[:, n] = Bt[:, t] * Bz[:, k]
        G[:, n, 0] = Gt[:, t, 0] * Bz[:, k]
        G[:, n, 1] = Gt[:, t, 1] * Bz[:, k]
        G[:, n, 2] = Bt[:, t] * Gz[:, k]
    return B, G


@functools.lru_cache(maxsize=None)
def pyramid_rule(nq1d: int):
    """Pyramid quadrature: the cube's Gauss rule mapped (x, y, z) →
    ((1−z)x, (1−z)y, z), weights times the Jacobian (1−z)²; every point is
    interior, so the rational basis is regular at each."""
    pc, wc = tensor_rule(3, nq1d)
    z = pc[:, 2]
    pts = np.stack([(1 - z) * pc[:, 0], (1 - z) * pc[:, 1], z], axis=1)
    return pts, wc * (1 - z) ** 2


def pyramid_basis_matrices(p: int, pts: np.ndarray):
    """The rational vertex basis of the linear pyramid (MFEM's
    ``LinearPyramidFiniteElement``): with s = 1 − z, N0 = (s−x)(s−y)/s,
    N1 = x(s−y)/s, N2 = xy/s, N3 = (s−x)y/s, N4 = z.  B (npts, 5),
    G (npts, 5, 3)."""
    assert p == 1
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    s = 1.0 - z
    B = np.stack([
        (s - x) * (s - y) / s, x * (s - y) / s, x * y / s, (s - x) * y / s, z,
    ], axis=1)
    G = np.zeros((len(pts), 5, 3))
    # N0 = s − x − y + xy/s; N1 = x − xy/s; N2 = xy/s; N3 = y − xy/s;
    # N4 = z; ds/dz = −1, so d(xy/s)/dz = xy/s²
    G[:, 0, 0] = -1.0 + y / s
    G[:, 0, 1] = -1.0 + x / s
    G[:, 0, 2] = -1.0 + x * y / s**2
    G[:, 1, 0] = 1.0 - y / s
    G[:, 1, 1] = -x / s
    G[:, 1, 2] = -x * y / s**2
    G[:, 2, 0] = y / s
    G[:, 2, 1] = x / s
    G[:, 2, 2] = x * y / s**2
    G[:, 3, 0] = -y / s
    G[:, 3, 1] = 1.0 - x / s
    G[:, 3, 2] = -x * y / s**2
    G[:, 4, 2] = 1.0
    return B, G
