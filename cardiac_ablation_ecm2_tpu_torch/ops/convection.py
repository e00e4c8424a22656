"""Convection integrator (v·∇u, w), partial assembly (counterpart of
``cardiac_ablation_ecm2_tpu/ops/convection.py``; MFEM's
``ConvectionIntegrator``): qdata maps the velocity through the adjugate so
the apply is ``Bᵀ (qdata · (G u))``."""

from __future__ import annotations

import torch

from ..fem.geom_factors import GeometricFactors, adjugate
from ..fem.quadinterp import DeviceBasis, contract_q_to_e, eval_grad, eval_values_t


def setup(gf: GeometricFactors, coeff_q=None, vel_q=None) -> torch.Tensor:
    """qdata[e, q, b] = w · (adj(J) v)_b · coeff → (ne, nq, dim).

    (v·∇_x u, w): ∇_x u = J⁻ᵀ ∇_ξ u, so v·∇_x u detJ = (adj(J) v)·∇_ξ u.
    ``vel_q`` is the (ne, nq, dim) physical velocity at the points."""
    if vel_q is None:
        raise ValueError("convection requires a vector velocity coefficient")
    qd = torch.einsum("eqba,eqa->eqb", adjugate(gf.jac), vel_q)
    qd = qd * gf.w[None, :, None]
    if coeff_q is not None:
        qd = qd * coeff_q[..., None]
    return qd


def apply(db: DeviceBasis, qdata: torch.Tensor, u_e: torch.Tensor) -> torch.Tensor:
    """(ne, nd[, c]) → (ne, nd[, c])."""
    return eval_values_t(db, torch.einsum("eqd,eqd...->eq...", qdata,
                                          eval_grad(db, u_e)))


def diagonal(db: DeviceBasis, qdata: torch.Tensor) -> torch.Tensor:
    """diag(Bᵀ qd·G) per element: Σ_q B[q,n] qd[q,d] G_d[q,n] → (ne, nd)."""
    if not db.tensor:
        return torch.einsum("qn,eqd,qnd->en", db.B, qdata, db.G)
    B, G = db.B1, db.G1
    BB, BG = B * B, B * G
    out = None
    for d in range(db.dim):
        facs = tuple(BG if a == d else BB for a in range(db.dim))
        term = contract_q_to_e(facs, qdata[:, :, d])
        out = term if out is None else out + term
    return out
