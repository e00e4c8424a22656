"""Geometric factors at quadrature points (counterpart of
``cardiac_ablation_ecm2_tpu/fem/geom_factors.py``, 3D).

The geometry E-vector (element node coordinates) goes through
``quadinterp.eval_grad``; determinant and adjugate are closed-form 3×3
formulas.  Jacobian convention: ``J[e, q, s, d] = ∂x_s/∂ξ_d``.  The same
code serves tensor (hex) and dense (tet) bases.
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
    det: torch.Tensor     # (ne, nq) signed det J
    w: torch.Tensor       # (nq,) reference quadrature weights

    @property
    def wdet(self) -> torch.Tensor:
        """w_q · detJ — the volume measure at each quadrature point."""
        return self.det * self.w[None, :]


def determinant(J: torch.Tensor) -> torch.Tensor:
    """det of square 3×3 Jacobians (..., 3, 3)."""
    return (
        J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1])
        - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 0])
        + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0])
    )


def adjugate(J: torch.Tensor) -> torch.Tensor:
    """adj(J) of (..., 3, 3), with J @ adj(J) = det(J) I."""
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
    """Constant per-element Jacobians for meshes that are affine by
    construction.  In the JAX package only straight-sided simplices are,
    and the port runs simplices only through the assembled-ELL apply,
    which needs no affine factors; so this returns None and, on hexes, the
    numerical separability check (``ops/lanemajor.separable_collapse``)
    decides, as it does in the JAX package."""
    return None


def compute_geometric_factors(node_coords, d2q: DofToQuad, dtype=None,
                              device=None) -> GeometricFactors:
    """GeometricFactors from element node coordinates (ne, nd, sdim), with
    the tensor or the dense basis of ``d2q``; ``device=None`` is the card."""
    db = device_basis(d2q, dtype, device)
    X = torch.as_tensor(node_coords, dtype=real_t(dtype), device=db.W.device)
    xq = eval_values(db, X)                      # (ne, nq, sdim)
    J = eval_grad(db, X).transpose(2, 3)         # (ne, nq, sdim, dim)
    return GeometricFactors(x=xq, jac=J, det=determinant(J), w=db.W)
