"""Off-grid point location + field evaluation.

Numpy copy of ``cardiac_ablation_ecm2_tpu/mesh/point_eval.py``.

Reference analog: ``FindPointsGSLIB::Setup/FindPoints/Interpolate``
(``fem/gslib.hpp:72,122``) — here a kd-tree candidate search over element
centroids plus Newton inversion of the (multi)linear geometry map
(SURVEY.md §2.6 item 9), evaluated host-side in numpy (setup/probe path, not
a device hot loop).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..fem.geometry import DIMENSION, Geometry


def _q1(geom, pts):
    from ..fem.fespace import _q1_eval_matrix  # deferred: avoids import cycle

    return _q1_eval_matrix(geom, pts)


def locate_points(mesh, pts: np.ndarray, tol: float = 1e-10,
                  k_candidates: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    """Find (element, reference coords) for each query point.

    Returns (elem (np,) int64 — -1 if not found, ref (np, dim)).
    """
    from scipy.spatial import cKDTree

    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    cent = mesh.vertices[mesh.elements].mean(axis=1)
    tree = cKDTree(cent)
    k = min(k_candidates, mesh.ne)
    _, cand = tree.query(pts, k=k)
    cand = np.atleast_2d(cand)
    dim = mesh.dim
    geom = mesh.geom

    elem = np.full(len(pts), -1, dtype=np.int64)
    ref = np.zeros((len(pts), dim))

    V_all = mesh.vertices[mesh.elements]      # (ne, nv, sdim)

    for i, p in enumerate(pts):
        for e in cand[i]:
            V = V_all[e]
            ok, xi = _invert_map(geom, V, p, tol)
            if ok:
                elem[i] = e
                ref[i] = xi
                break
    return elem, ref


def _invert_map(geom: Geometry, V: np.ndarray, p: np.ndarray, tol: float):
    dim = DIMENSION[geom]
    if geom in (Geometry.TRIANGLE, Geometry.TETRAHEDRON):
        # affine: solve J xi = p - v0
        J = (V[1: dim + 1] - V[0]).T
        try:
            xi = np.linalg.solve(J, p - V[0])
        except np.linalg.LinAlgError:
            return False, None
        inside = np.all(xi >= -tol) and xi.sum() <= 1 + tol
        return inside, np.clip(xi, 0.0, 1.0)
    # multilinear: Newton
    xi = np.full(dim, 0.5)
    for _ in range(30):
        B = _q1(geom, xi[None, :])[0]          # (nv,)
        x = B @ V
        r = x - p
        if np.linalg.norm(r) < 1e-13 + tol * 0:
            break
        # Jacobian dx/dxi via finite differences of the Q1 map (exact enough)
        J = np.zeros((V.shape[1], dim))
        h = 1e-7
        for d in range(dim):
            xib = xi.copy(); xib[d] += h
            J[:, d] = (_q1(geom, xib[None, :])[0] @ V - x) / h
        try:
            dxi = np.linalg.lstsq(J, r, rcond=None)[0]
        except np.linalg.LinAlgError:
            return False, None
        xi = xi - dxi
        if np.linalg.norm(dxi) < 1e-13:
            break
    inside = np.all(xi >= -1e-8) and np.all(xi <= 1 + 1e-8)
    B = _q1(geom, np.clip(xi, 0, 1)[None, :])[0]
    err = np.linalg.norm(B @ V - p)
    scale = np.linalg.norm(V.max(axis=0) - V.min(axis=0)) + 1e-300
    return inside and err < 1e-7 * scale, np.clip(xi, 0.0, 1.0)


def evaluate_at_points(fes, u: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """u_h at arbitrary physical points (Interpolate analog).  Points outside
    the mesh evaluate to 0."""
    from ..fem.faces import _eval_volume_basis

    mesh = fes.mesh
    elem, ref = locate_points(mesh, pts)
    u = np.asarray(u)
    out = np.zeros(len(ref), dtype=u.dtype)
    found = elem >= 0
    if found.any():
        B = _eval_volume_basis(mesh.geom, fes.order, ref[found])  # (m, nd)
        dofs = u[fes.gather_map[elem[found]]]                     # (m, nd)
        out[found] = np.sum(B * dofs, axis=1)
    return out
