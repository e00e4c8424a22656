"""Order-3 H1 pyramid elements — the 30-node rational pyramid (numpy copy
of ``cardiac_ablation_ecm2_tpu/fem/pyramid3.py``).

Reference analog: the order-p pyramid program of ``fem/fe/fe_pyramid.cpp``
(Fuentes–Keith bases).  Construction here extends the pairwise-product idea
of ``fem/pyramid2.py`` one degree up: the span of TRIPLE products of the 5
rational order-1 vertex functions λᵢ.  Of the 35 multiset products, the base
relation λ₀λ₂ = λ₁λ₃ multiplied by each λᵢ gives exactly 5 dependencies, so
dropping {λ₁λ₃λᵢ} leaves an independent 30-dimensional space which (verified
numerically to 1e-13):

* contains all of P₃  → optimal O(h⁴) L2 approximation;
* restricts to Q₃ (dim 16) on the quad base and P₃ (dim 10) on the
  triangular faces, cubics on edges → the canonical nodal set
  {5 vertices, 2 GLL nodes per edge, 4 tri-face centroids, 4 quad-face
  GLL×GLL interior nodes, 1 cell node} is trace-unisolvent, giving H1
  conformity against order-3 hexes and tets by the trace-dimension
  argument (Vandermonde condition ≈ 179).

Edge and quad-face nodes sit at the 1D GLL positions so shared-entity node
POSITIONS coincide with the hex (``h1_nodes_1d``) and GLL-warped tet
lattices — the same convention that makes the rest of the mixed machinery
conforming (``fem/basis.py h1_nodes``).
"""

from __future__ import annotations

import numpy as np

from .basis import h1_nodes_1d, pyramid_basis_matrices
from .geometry import EDGES, FACES, REF_VERTS, Geometry

_RV = REF_VERTS[Geometry.PYRAMID].astype(np.float64)
_EDGE_LIST = EDGES[Geometry.PYRAMID]
_FACE_LIST = FACES[Geometry.PYRAMID]

_TRIPS = [
    (i, j, k)
    for i in range(5)
    for j in range(i, 5)
    for k in range(j, 5)
]
for _dep in [(0, 1, 3), (1, 1, 3), (1, 2, 3), (1, 3, 3), (1, 3, 4)]:
    _TRIPS.remove(_dep)                    # λ₁λ₃λᵢ = λ₀λ₂λᵢ

_GLL = h1_nodes_1d(3)
_A = float(_GLL[1])                        # ≈ 0.2763932 (interior GLL)

#: interior cell node on the base-center→apex line (z chosen for Vandermonde
#: conditioning ≈ 179; flat in z over [0.2, 0.4])
_ZC = 0.25


def _build_nodes() -> np.ndarray:
    nodes = [list(_RV[i]) for i in range(5)]
    for (la, lb) in _EDGE_LIST:            # 2 GLL nodes per edge, t = α, 1−α
        for t in (_A, 1.0 - _A):
            nodes.append(list(_RV[la] * (1 - t) + _RV[lb] * t))
    for f in _FACE_LIST[1:]:               # tri-face centroids
        nodes.append(list(_RV[list(f)].mean(axis=0)))
    base = _FACE_LIST[0]
    L0 = _RV[base[0]]
    du = _RV[base[1]] - L0                 # u along fverts[0]→fverts[1]
    dv = _RV[base[3]] - L0                 # v along fverts[0]→fverts[3]
    for v in (_A, 1.0 - _A):               # (u,v) index order (1,1),(2,1),(1,2),(2,2)
        for u in (_A, 1.0 - _A):
            nodes.append(list(L0 + u * du + v * dv))
    nodes.append([0.5 * (1 - _ZC), 0.5 * (1 - _ZC), _ZC])
    return np.asarray(nodes, dtype=np.float64)


PYRAMID_P3_NODES = _build_nodes()          # (30, 3)


def _nudge_apex(pts: np.ndarray) -> np.ndarray:
    """The rational λᵢ are 0/0 at the apex (removable); evaluate there just
    below it on the center line (same trick as fem/pyramid2.py)."""
    p = np.array(pts, dtype=np.float64)
    hi = p[:, 2] > 1 - 1e-12
    p[hi, 2] = 1 - 1e-12
    p[hi, 0] *= 1e-12
    p[hi, 1] *= 1e-12
    return p


def _products(pts: np.ndarray):
    B, G = pyramid_basis_matrices(1, _nudge_apex(pts))
    P = np.stack(
        [B[:, i] * B[:, j] * B[:, k] for (i, j, k) in _TRIPS], axis=1
    )
    Gp = np.stack(
        [
            G[:, i] * (B[:, j] * B[:, k])[:, None]
            + G[:, j] * (B[:, i] * B[:, k])[:, None]
            + G[:, k] * (B[:, i] * B[:, j])[:, None]
            for (i, j, k) in _TRIPS
        ],
        axis=1,
    )
    return P, Gp


_C = np.linalg.inv(_products(PYRAMID_P3_NODES)[0])


def pyramid_p3_basis_matrices(pts: np.ndarray):
    """(B (n, 30), G (n, 30, 3)) of the nodal order-3 pyramid basis."""
    P, Gp = _products(pts)
    return P @ _C, np.einsum("pmc,mn->pnc", Gp, _C)
