"""Geometric factors at quadrature points (counterpart of
``cardiac_ablation_ecm2_tpu/fem/geom_factors.py``): volume elements and
the boundary faces of 3D meshes.

The geometry E-vector (element node coordinates) goes through
``quadinterp.eval_grad``; determinant and adjugate are closed-form 2×2 and
3×3 formulas, and an embedded face Jacobian (3×2) gets the surface
measure sqrt(det(JᵀJ)).  Jacobian convention: ``J[e, q, s, d] = ∂x_s/∂ξ_d``.  The same
code serves tensor (hex) and dense (tet) bases.  Straight-sided simplices
also get their constant per-element Jacobians and affine factors on the
host in float64 (:func:`affine_element_jacobians`,
:func:`affine_packed_factors`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.config import real_t
from .basis import DofToQuad
from .quadinterp import device_basis, eval_grad, eval_values


@dataclasses.dataclass(frozen=True, eq=False)
class GeometricFactors:
    """Per-quadrature-point geometry data."""

    x: torch.Tensor       # (ne, nq, sdim) physical coordinates
    jac: torch.Tensor     # (ne, nq, sdim, dim)
    det: torch.Tensor     # (ne, nq) signed det J (a face's surface measure)
    w: torch.Tensor       # (nq,) reference quadrature weights

    @property
    def wdet(self) -> torch.Tensor:
        """w_q · detJ — the volume measure at each quadrature point."""
        return self.det * self.w[None, :]


def _det2(J):
    return J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]


def _det3(J):
    return (
        J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1])
        - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 0])
        + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0])
    )


def determinant(J: torch.Tensor) -> torch.Tensor:
    """det of square Jacobians (..., d, d); for embedded ones (sdim > dim,
    boundary faces) the surface measure sqrt(det(JᵀJ))."""
    s, d = J.shape[-2], J.shape[-1]
    if s == d:
        return J[..., 0, 0] if d == 1 else (_det2(J) if d == 2 else _det3(J))
    JtJ = torch.einsum("...sd,...se->...de", J, J)
    if d == 1:
        return torch.sqrt(JtJ[..., 0, 0])
    return torch.sqrt(_det2(JtJ) if d == 2 else _det3(JtJ))


def adjugate(J: torch.Tensor) -> torch.Tensor:
    """adj(J) by the reference dimension d = J.shape[-1], with
    J @ adj(J) = det(J) I for square J; on an embedded (sdim × 2) face
    Jacobian it is the adjugate of the leading 2×2 block, as in the JAX
    package (no boundary integrator reads it)."""
    d = J.shape[-1]
    if d == 1:
        return torch.ones_like(J)
    if d == 2:
        a, b, c, e = J[..., 0, 0], J[..., 0, 1], J[..., 1, 0], J[..., 1, 1]
        return torch.stack([torch.stack([e, -b], dim=-1),
                            torch.stack([-c, a], dim=-1)], dim=-2)
    rows = [
        [J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1],
         J[..., 0, 2] * J[..., 2, 1] - J[..., 0, 1] * J[..., 2, 2],
         J[..., 0, 1] * J[..., 1, 2] - J[..., 0, 2] * J[..., 1, 1]],
        [J[..., 1, 2] * J[..., 2, 0] - J[..., 1, 0] * J[..., 2, 2],
         J[..., 0, 0] * J[..., 2, 2] - J[..., 0, 2] * J[..., 2, 0],
         J[..., 0, 2] * J[..., 1, 0] - J[..., 0, 0] * J[..., 1, 2]],
        [J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0],
         J[..., 0, 1] * J[..., 2, 0] - J[..., 0, 0] * J[..., 2, 1],
         J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def affine_element_jacobians(mesh) -> Optional[np.ndarray]:
    """Constant per-element Jacobians (ne, dim, dim), float64 host numpy,
    for meshes whose geometry map is affine by construction: straight-sided
    simplices with no curved ``nodes`` field.  None for tensor (hex) meshes,
    curved meshes and embedded (surface) meshes.

    The affine apply (``ops/lanemajor.py``) wants per-element factors
    adj(J)·adj(J)ᵀ/detJ.  Detecting that the qdata separate from float32
    qdata fails on sliver tets (the adjugate's rounding reaches ~1e-3 of
    the factor), so on meshes that are affine by construction the factors
    are computed here in float64 from the vertices, as the JAX package
    does."""
    from .basis import simplex_basis_matrices
    from .geometry import Geometry

    if getattr(mesh, "nodes", None) is not None:
        return None
    if mesh.geom not in (Geometry.TRIANGLE, Geometry.TETRAHEDRON):
        return None
    dim = 2 if mesh.geom == Geometry.TRIANGLE else 3
    if mesh.vertices.shape[1] != dim:      # embedded/surface mesh
        return None
    # the P1 geometry gradient at one point (it is constant); the convention
    # of compute_geometric_factors: J[e, s, d] = Σ_n G[n, d] X[e, n, s]
    ref = np.full((1, dim), 1.0 / (dim + 1))
    _B, G = simplex_basis_matrices(mesh.geom, 1, ref)
    G = np.asarray(G, np.float64).reshape(-1, dim + 1, dim)[0]   # (nv, dim)
    X = np.asarray(mesh.vertices, np.float64)[mesh.elements]     # (ne, nv, s)
    return np.einsum("nd,ens->esd", G, X)


def _np_det_adj(J: np.ndarray):
    """Float64 host det and adjugate of (ne, d, d), d in {2, 3}."""
    d = J.shape[-1]
    if d == 2:
        det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        adj = np.empty_like(J)
        adj[:, 0, 0], adj[:, 0, 1] = J[:, 1, 1], -J[:, 0, 1]
        adj[:, 1, 0], adj[:, 1, 1] = -J[:, 1, 0], J[:, 0, 0]
        return det, adj
    c = np.empty_like(J)
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            c[:, j, i] = (J[:, i1, j1] * J[:, i2, j2]
                          - J[:, i1, j2] * J[:, i2, j1])
    det = (J[:, 0, 0] * c[:, 0, 0] + J[:, 0, 1] * c[:, 1, 0]
           + J[:, 0, 2] * c[:, 2, 0])
    return det, c


def affine_packed_factors(J: np.ndarray):
    """Per-element affine qdata factors from constant Jacobians (float64
    host): ``(det, dk)`` with ``det`` (ne,) = detJ, the mass factor (mass
    qdata is w_q·detJ·coeff), and ``dk`` (3|6, ne) the packed-symmetric
    diffusion factors adj(J)·adj(J)ᵀ/detJ (diffusion qdata is
    w_q·dk·coeff), in the packing order of ``ops.diffusion.pack_sym``.
    The det is signed, as in the per-point qdata (``determinant``), so the
    affine and the per-point paths agree for every orientation."""
    det, A = _np_det_adj(J)
    d = J.shape[-1]
    pairs = ([(0, 0), (1, 1), (0, 1)] if d == 2 else
             [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)])
    dk = np.stack(
        [np.einsum("eb,eb->e", A[:, a], A[:, c]) / det for a, c in pairs],
        axis=0,
    )
    return det, dk


def compute_geometric_factors(node_coords, d2q: DofToQuad, dtype=None,
                              device=None) -> GeometricFactors:
    """GeometricFactors from element node coordinates (ne, nd, sdim), with
    the tensor or the dense basis of ``d2q``; ``device=None`` is the card."""
    db = device_basis(d2q, dtype, device)
    X = torch.as_tensor(node_coords, dtype=real_t(dtype), device=db.W.device)
    xq = eval_values(db, X)                      # (ne, nq, sdim)
    J = eval_grad(db, X).transpose(2, 3)         # (ne, nq, sdim, dim)
    return GeometricFactors(x=xq, jac=J, det=determinant(J), w=db.W)
