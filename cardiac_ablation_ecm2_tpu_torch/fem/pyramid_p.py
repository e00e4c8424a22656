"""Arbitrary-order H1 pyramid elements — the rational product pyramid
(numpy copy of ``cardiac_ablation_ecm2_tpu/fem/pyramid_p.py``).

Reference analog: the order-p H1 pyramid program of ``fem/fe/fe_pyramid.cpp``
(Fuentes–Keith bases).  This module generalizes the pairwise/triple-product
construction of ``fem/pyramid2.py`` / ``fem/pyramid3.py`` to any order p:
the space is the span of all degree-p multiset products of the 5 rational
order-1 vertex functions λᵢ, modulo the relations generated by the base
identity λ₀λ₂ = λ₁λ₃.

Dimension count: C(p+4,4) degree-p multisets over 5 symbols, minus the
C(p+2,4) dependent ones (the identity times every degree-(p−2) multiset) —
realized by dropping every multiset containing BOTH a 1 and a 3.  That
equals the canonical conforming pyramid dof count

    5 + 8(p−1) + 4·(p−1)(p−2)/2 + (p−1)² + (p−1)(p−2)(2p−3)/6

for every p (p=2: 14, p=3: 30, p=4: 55, p=5: 91, p=6: 140).  Verified
numerically: the span is unisolvent on the nodal
set below (Vandermonde cond ≈ 2.3e3 / 4e4 / 7e5 at p = 4/5/6 — benign in
the float64 setup path), contains all of P_p (optimal O(h^{p+1}) L2
approximation), off-face basis traces vanish IDENTICALLY on each face, and
face traces lie in Q_p (quad base) / P_p (tri faces) — so traces agree
with order-p hex and tet neighbors by unisolvence of the shared face nodes,
giving H1 conformity on mixed meshes.

Node layout (lex order used by ``fespace._pyramid_p_keys``):

* 5 vertices (``REF_VERTS`` order);
* 8 edges × (p−1) interior nodes at the 1D GLL positions (t = 1..p−1
  measured from the edge's first local vertex) — matching hex edges and
  GLL-warped tet edges;
* 4 triangular faces × (p−1)(p−2)/2 interior nodes at the equispaced
  barycentric lattice (b₀ from 1, then b₁; b₂ = p−b₀−b₁) — matching the
  tet face-interior convention (``basis.h1_nodes``: simplex faces are
  equispaced, only edges GLL-warped);
* quad base face: (p−1)² interior nodes at GLL×GLL (u along
  fverts[0]→fverts[1], v along fverts[0]→fverts[3], u outer loop);
* (p−1)(p−2)(2p−3)/6 cell-interior nodes: horizontal level ℓ = 1..p−2 at
  height z = gll_p[ℓ] carrying an m×m grid, m = p−1−ℓ, at the interior
  GLL nodes of order m+1 scaled into the cross-section square [0, 1−z]².
"""

from __future__ import annotations

from itertools import combinations_with_replacement
from typing import Dict, Tuple

import numpy as np

from .basis import h1_nodes_1d, pyramid_basis_matrices
from .geometry import EDGES, FACES, REF_VERTS, Geometry
# The rational λᵢ are 0/0 at the apex (removable); _nudge_apex evaluates
# there just below it on the center line.  Single source of truth in
# fem/pyramid2.py.
from .pyramid2 import _nudge_apex

_RV = REF_VERTS[Geometry.PYRAMID].astype(np.float64)
_EDGE_LIST = EDGES[Geometry.PYRAMID]
_FACE_LIST = FACES[Geometry.PYRAMID]


def pyramid_num_dofs(p: int) -> int:
    return (5 + 8 * (p - 1) + 2 * (p - 1) * (p - 2) + (p - 1) ** 2
            + (p - 1) * (p - 2) * (2 * p - 3) // 6)


def _multisets(p: int):
    """Independent degree-p multisets: all but those containing both 1, 3."""
    return [t for t in combinations_with_replacement(range(5), p)
            if not (1 in t and 3 in t)]


def pyramid_nodes(p: int) -> np.ndarray:
    """Reference nodal coordinates, (pyramid_num_dofs(p), 3)."""
    gll = h1_nodes_1d(p)
    out = [list(_RV[i]) for i in range(5)]
    for (la, lb) in _EDGE_LIST:
        for t in range(1, p):
            out.append(list(_RV[la] + gll[t] * (_RV[lb] - _RV[la])))
    for f in _FACE_LIST[1:]:
        for b0 in range(1, p):
            for b1 in range(1, p - b0):
                b2 = p - b0 - b1
                if b2 < 1:
                    continue
                out.append(list((b0 * _RV[f[0]] + b1 * _RV[f[1]]
                                 + b2 * _RV[f[2]]) / p))
    base = _FACE_LIST[0]
    L0, du, dv = _RV[base[0]], _RV[base[1]] - _RV[base[0]], \
        _RV[base[3]] - _RV[base[0]]
    for u in range(1, p):
        for v in range(1, p):
            out.append(list(L0 + gll[u] * du + gll[v] * dv))
    for ell in range(1, p - 1):
        m = p - 1 - ell
        z = gll[ell]
        g = h1_nodes_1d(m + 1)[1:-1]
        for j in range(m):
            for i in range(m):
                out.append([(1 - z) * g[i], (1 - z) * g[j], z])
    nodes = np.asarray(out, dtype=np.float64)
    assert len(nodes) == pyramid_num_dofs(p)
    return nodes


def _products(p: int, pts: np.ndarray):
    """Raw product span values/gradients: (n, nd), (n, nd, 3)."""
    B, G = pyramid_basis_matrices(1, _nudge_apex(pts))
    ms = _multisets(p)
    n = len(pts)
    P = np.empty((n, len(ms)))
    Gp = np.empty((n, len(ms), 3))
    for col, t in enumerate(ms):
        prod = np.ones(n)
        for i in t:
            prod = prod * B[:, i]
        P[:, col] = prod
        g = np.zeros((n, 3))
        for k in range(len(t)):
            q = np.ones(n)
            for j in range(len(t)):
                if j != k:
                    q = q * B[:, t[j]]
            g += G[:, t[k]] * q[:, None]
        Gp[:, col] = g
    return P, Gp


_COEF: Dict[int, np.ndarray] = {}


def _coef(p: int) -> np.ndarray:
    C = _COEF.get(p)
    if C is None:
        P = _products(p, pyramid_nodes(p))[0]
        # The product-span Vandermonde's condition number grows ~20× per
        # order (≈7e5 at p=6, 2e8 at p=8); nodal/PoU error stays ~1e-14
        # through p=8 (tested), but float64 headroom runs out beyond that.
        cond = np.linalg.cond(P)
        if cond > 1e12:
            import warnings

            warnings.warn(
                f"order-{p} pyramid Vandermonde condition {cond:.1e} "
                "threatens float64 nodal accuracy (validated through p=8)",
                stacklevel=2)
        C = np.linalg.solve(P, np.eye(P.shape[0]))
        _COEF[p] = C
    return C


def pyramid_p_basis_matrices(p: int, pts: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(B (n, nd), G (n, nd, 3)) of the nodal order-p pyramid basis."""
    C = _coef(p)
    P, Gp = _products(p, pts)
    return P @ C, np.einsum("pmc,mn->pnc", Gp, C)
