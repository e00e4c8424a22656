"""Order-2 H1 pyramid elements — the 14-node rational pyramid (counterpart
of ``cardiac_ablation_ecm2_tpu/fem/pyramid2.py``: the basis and
``PyramidP2Space`` are numpy copies; ``pyramid_p2_operator`` applies on the
space's ``ElementRestriction``, one gather and one segment-sum an apply).

Reference analog: the higher-order pyramid program of ``fem/fe/fe_pyramid``
(Fuentes–Keith bases).  Construction here: the span of pairwise products
of the 5 rational order-1 vertex functions λᵢ is EXACTLY 14-dimensional
(the lone dependency is λ₁λ₃ = λ₀λ₂), contains all of P₂, and restricts
to Q₂ on the quad base and P₂ on the triangular faces — so the nodal set
{5 vertices, 8 edge midpoints, base-face center} is unisolvent (Vandermonde
condition ≈ 22) and conforming against order-2 hexes and tets.  Midpoint
nodes make every shared dof orientation-free.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh.mesh import Mesh, unique_edges
from ..utils.config import real_t, resolve_device
from .basis import pyramid_basis_matrices
from .geometry import EDGES, FACES, REF_VERTS, Geometry

_PAIRS = [(i, j) for i in range(5) for j in range(i, 5)]
_PAIRS.remove((1, 3))                     # dependent: λ₁λ₃ = λ₀λ₂

_RV = REF_VERTS[Geometry.PYRAMID].astype(np.float64)
_EDGE_LIST = EDGES[Geometry.PYRAMID]

PYRAMID_P2_NODES = np.concatenate([
    _RV,
    np.stack([0.5 * (_RV[a] + _RV[b]) for (a, b) in _EDGE_LIST]),
    np.array([[0.5, 0.5, 0.0]]),
])                                         # (14, 3)


def _nudge_apex(pts: np.ndarray) -> np.ndarray:
    """The rational λᵢ are 0/0 at the apex (removable); evaluate nodal
    points there along the center line just below it."""
    p = np.array(pts, dtype=np.float64)
    hi = p[:, 2] > 1 - 1e-12
    p[hi, 2] = 1 - 1e-12
    p[hi, 0] *= 1e-12
    p[hi, 1] *= 1e-12
    return p


def _products(pts: np.ndarray):
    B, G = pyramid_basis_matrices(1, _nudge_apex(pts))
    P = np.stack([B[:, i] * B[:, j] for (i, j) in _PAIRS], axis=1)
    Gp = np.stack([G[:, i] * B[:, j, None] + B[:, i, None] * G[:, j]
                   for (i, j) in _PAIRS], axis=1)
    return P, Gp


_C = np.linalg.inv(_products(PYRAMID_P2_NODES)[0])


def pyramid_p2_basis_matrices(pts: np.ndarray):
    """(B (n, 14), G (n, 14, 3)) of the nodal order-2 pyramid basis."""
    P, Gp = _products(pts)
    return P @ _C, np.einsum("pmc,mn->pnc", Gp, _C)


@dataclasses.dataclass(eq=False)
class PyramidP2Space:
    """Conforming order-2 H1 space on a pyramid mesh (vertex + edge-mid +
    base-face-center dofs)."""

    mesh: Mesh

    def __post_init__(self):
        mesh = self.mesh
        assert mesh.geom == Geometry.PYRAMID
        edges, elem_edge = unique_edges(mesh)
        self._edges = edges
        nv, nedge = mesh.nv, len(edges)

        # quad base faces keyed by sorted vertex 4-tuple (local face 0)
        base_key = {}
        elem_base = np.zeros(mesh.ne, dtype=np.int64)
        quad = FACES[Geometry.PYRAMID][0]
        for e in range(mesh.ne):
            key = tuple(sorted(int(v) for v in mesh.elements[e, list(quad)]))
            elem_base[e] = base_key.setdefault(key, len(base_key))
        self._base_key = base_key
        nbase = len(base_key)
        self.ndof = nv + nedge + nbase
        self.ndof_scalar = self.ndof

        gm = np.zeros((mesh.ne, 14), dtype=np.int64)
        gm[:, :5] = mesh.elements
        gm[:, 5:13] = nv + elem_edge
        gm[:, 13] = nv + nedge + elem_base
        self.gather_map = gm
        self._nedge = nedge

    @property
    def nd_elem(self):
        return 14

    def dof_coords(self) -> np.ndarray:
        B1, _ = pyramid_basis_matrices(1, _nudge_apex(PYRAMID_P2_NODES))
        phys = np.einsum("nk,eks->ens", B1,
                         self.mesh.vertices[self.mesh.elements])
        X = np.zeros((self.ndof, 3))
        X[self.gather_map.reshape(-1)] = phys.reshape(-1, 3)
        # vertex dofs exactly (the apex nudge perturbs them by ~1e-9)
        X[: self.mesh.nv] = self.mesh.vertices
        return X

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        mesh = self.mesh
        ekey = {tuple(sorted(map(int, r))): i
                for i, r in enumerate(self._edges)}
        nv = mesh.nv
        out = set()
        for row, a in zip(mesh.boundary, mesh.bdr_attributes):
            if bdr_marker is not None and int(a) not in set(bdr_marker):
                continue
            vs = [int(v) for v in row]
            out.update(vs)
            k = len(vs)
            for i in range(k):
                eid = ekey.get(tuple(sorted((vs[i], vs[(i + 1) % k]))))
                if eid is not None:
                    out.add(nv + eid)
            if k == 4:
                bid = self._base_key.get(tuple(sorted(vs)))
                if bid is not None:
                    out.add(nv + self._nedge + bid)
        return np.array(sorted(out), dtype=np.int64)


def pyramid_p2_operator(sp: PyramidP2Space, diffusion_coeff=1.0,
                        mass_coeff=None, nq1d=4, dtype=None, device=None):
    """Matrix-free (κ∇u,∇v) [+ (m u,v)] on ``device`` (``None``: the card):
    (mult, diagonal) closures.  An apply is the restriction's L→E gather,
    the per-element products and its E→L segment-sum."""
    from ..fem.restriction import ElementRestriction
    from .basis import make_dof_to_quad
    from .fespace import element_node_coords
    from .geom_factors import adjugate, compute_geometric_factors

    device = resolve_device(device)
    rt = real_t(dtype)
    mesh = sp.mesh
    d2q = make_dof_to_quad(Geometry.PYRAMID, 1, nq1d)
    gf = compute_geometric_factors(element_node_coords(mesh, 1), d2q, dtype,
                                   device)
    B, G = pyramid_p2_basis_matrices(np.asarray(d2q.points))
    B = torch.as_tensor(B, dtype=rt, device=device)
    A = adjugate(gf.jac)
    Gphys = torch.einsum("eqab,qna->eqnb", A / gf.det[..., None, None],
                         torch.as_tensor(G, dtype=rt, device=device))
    qd_k = diffusion_coeff * gf.wdet
    qd_m = None if mass_coeff is None else mass_coeff * gf.wdet
    R = ElementRestriction(sp.gather_map, sp.ndof, device)

    def mult(x):
        e = R.mult(x)
        g = torch.einsum("eqnc,en->eqc", Gphys, e)
        y = torch.einsum("eqnc,eqc->en", Gphys, qd_k[..., None] * g)
        if qd_m is not None:
            u = torch.einsum("qn,en->eq", B, e)
            y = y + torch.einsum("qn,eq->en", B, qd_m * u)
        return R.mult_transpose(y)

    def diagonal():
        d = torch.einsum("eqnc,eq,eqnc->en", Gphys, qd_k, Gphys)
        if qd_m is not None:
            d = d + torch.einsum("qn,eq,qn->en", B, qd_m, B)
        return R.mult_transpose(d)

    return mult, diagonal
