"""Mass integrator, partial assembly (counterpart of
``cardiac_ablation_ecm2_tpu/ops/mass.py``): qdata is ``w_q · detJ_q ·
coeff_q`` (ne, nq) and the apply is ``Bᵀ (qdata ∘ (B u))``."""

from __future__ import annotations

import torch

from ..fem.geom_factors import GeometricFactors
from ..fem.quadinterp import (
    DeviceBasis,
    contract_q_to_e,
    eval_values,
    eval_values_t,
)


def setup(gf: GeometricFactors, coeff_q=None) -> torch.Tensor:
    """qdata = w · detJ · coeff at each quadrature point → (ne, nq)."""
    qd = gf.wdet
    if coeff_q is not None:
        qd = qd * coeff_q
    return qd


def apply(db: DeviceBasis, qdata: torch.Tensor, u_e: torch.Tensor) -> torch.Tensor:
    """(ne, nd) → (ne, nd): Bᵀ diag(qdata) B u."""
    return eval_values_t(db, eval_values(db, u_e) * qdata)


def diagonal(db: DeviceBasis, qdata: torch.Tensor) -> torch.Tensor:
    """diag(Bᵀ diag(qdata) B) per element → (ne, nd)."""
    if not db.tensor:
        return torch.einsum("qn,eq,qn->en", db.B, qdata, db.B)
    Bsq = db.B1 * db.B1
    return contract_q_to_e((Bsq,) * db.dim, qdata)
