"""Nodal H1 bases (numpy copy of the tensor-product and simplex parts of
``cardiac_ablation_ecm2_tpu/fem/basis.py``).

* Tensor geometries (segment, square, cube): Gauss-Lobatto nodes per
  direction; only the 1D matrices ``B1 (nq1d, p+1)`` and ``G1`` are stored.
  Local dof ordering is lexicographic, i fastest: dof = i + n1d*(j + n1d*k).
* Simplices (triangle, tetrahedron): lattice nodes with the edge nodes at
  the 1D Gauss-Lobatto positions; dense ``B (nq, nd)`` / ``G (nq, nd, dim)``
  from a monomial Vandermonde solve.  Local order: lattice points with
  i + j (+ k) ≤ p, i fastest.
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
                                  "triangles, squares, tetrahedra and cubes")


@functools.lru_cache(maxsize=None)
def lattice_multi_index(geom: Geometry, p: int) -> np.ndarray:
    """Integer lattice multi-indices of the local nodes, i fastest; shape
    (nd, dim), int64.  Tensor geometries: all of [0,p]^dim; simplices: the
    indices with sum ≤ p."""
    _require_supported(geom)
    if IS_TENSOR[geom]:
        rng = np.arange(p + 1)
        grids = np.meshgrid(*([rng] * DIMENSION[geom]), indexing="ij")
        return np.stack([g.ravel(order="F") for g in grids], axis=1)
    if geom == Geometry.TRIANGLE:
        out = [(i, j) for j in range(p + 1) for i in range(p + 1 - j)]
    else:
        out = [(i, j, k) for k in range(p + 1) for j in range(p + 1 - k)
               for i in range(p + 1 - j - k)]
    return np.array(out, dtype=np.int64)


@functools.lru_cache(maxsize=None)
def h1_nodes(geom: Geometry, p: int) -> np.ndarray:
    """Reference coordinates of the local H1 nodes, lex-ordered (nd, dim)."""
    mi = lattice_multi_index(geom, p)
    if IS_TENSOR[geom]:
        return h1_nodes_1d(p)[mi]
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
    2·nq1d − 1 (their lattice nodes either way, as the JAX package)."""
    _require_supported(geom)
    if nq1d is None:
        nq1d = p + 2
    if IS_TENSOR[geom]:
        xq, _ = gauss_legendre_1d(nq1d)
        nodes_1d = h1_nodes_1d(p) if nodes == "h1" else l2_nodes_1d(p)
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
