"""Diffusion integrator, partial assembly (counterpart of
``cardiac_ablation_ecm2_tpu/ops/diffusion.py``, 3D).

Per quadrature point ``D = (w/detJ) · adj(J) · C · adj(J)ᵀ``.  A scalar
coefficient gives packed symmetric qdata (6, ne, nq) in the order
[D00, D11, D22, D01, D02, D12], whose apply ``Gᵀ (D ∘ (G u))`` on a tensor
(hex) basis is ``ops/fused_diffusion.diffusion_apply`` (the hand-written
kernel on the card, the einsum chain on the CPU) and on a dense (simplex)
basis the einsum chain on any device, as the JAX package's ``apply`` is
plain XLA.  A matrix coefficient (ne, nq, 3, 3) gives full (ne, nq, 3, 3)
qdata, applied by the einsum chain on any device, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..fem.geom_factors import GeometricFactors, adjugate
from ..fem.quadinterp import DeviceBasis, contract_q_to_e, eval_grad, eval_grad_t
from .fused_diffusion import diffusion_apply, diffusion_apply_plain

#: packed index of each (a, b) component
_PIDX = {(0, 0): 0, (1, 1): 1, (2, 2): 2, (0, 1): 3, (1, 0): 3,
         (0, 2): 4, (2, 0): 4, (1, 2): 5, (2, 1): 5}


def setup(gf: GeometricFactors, coeff_q=None) -> torch.Tensor:
    """Full qdata (ne, nq, 3, 3); ``coeff_q`` None, (ne, nq) scalar or
    (ne, nq, 3, 3) matrix conductivity."""
    A = adjugate(gf.jac)
    w_over_det = gf.w[None, :] / gf.det
    if coeff_q is not None and coeff_q.dim() == 4:
        D = torch.einsum("eqab,eqbc,eqdc->eqad", A, coeff_q, A)
    else:
        D = torch.einsum("eqab,eqcb->eqac", A, A)
        if coeff_q is not None:
            D = D * coeff_q[..., None, None]
    return D * w_over_det[..., None, None]


def setup_packed(gf: GeometricFactors, coeff_q=None) -> torch.Tensor:
    """Packed-symmetric qdata computed elementwise → (6, ne, nq); equal to
    ``pack_sym(setup(gf, coeff_q))`` up to rounding."""
    A = adjugate(gf.jac)
    w_over_det = gf.w[None, :] / gf.det
    if coeff_q is not None:
        w_over_det = w_over_det * coeff_q

    def dot_rows(a, c):
        s = A[..., a, 0] * A[..., c, 0]
        for b in range(1, 3):
            s = s + A[..., a, b] * A[..., c, b]
        return s * w_over_det

    return torch.stack(
        [dot_rows(0, 0), dot_rows(1, 1), dot_rows(2, 2),
         dot_rows(0, 1), dot_rows(0, 2), dot_rows(1, 2)], dim=0
    )


def pack_sym(D: torch.Tensor) -> torch.Tensor:
    """(ne, nq, 3, 3) symmetric → packed (6, ne, nq)."""
    return torch.stack(
        [D[..., 0, 0], D[..., 1, 1], D[..., 2, 2],
         D[..., 0, 1], D[..., 0, 2], D[..., 1, 2]], dim=0
    )


def is_packed(qdata: torch.Tensor) -> bool:
    return qdata.dim() == 3 and qdata.shape[0] == 6


def apply(db: DeviceBasis, qdata: torch.Tensor, u_e: torch.Tensor) -> torch.Tensor:
    """(ne, nd) → (ne, nd): Gᵀ (D ∘ (G u)).  Packed qdata (6, ne|1, nq):
    the fused kernel on a tensor basis, the einsum chain on a dense one;
    full (ne, nq, 3, 3) qdata: the einsum chain."""
    if not is_packed(qdata):
        return eval_grad_t(db, torch.einsum("eqab,eqb->eqa", qdata,
                                            eval_grad(db, u_e)))
    if db.tensor:
        return diffusion_apply(db, qdata, u_e)
    return diffusion_apply_plain(db, qdata, u_e)


def diagonal(db: DeviceBasis, qdata: torch.Tensor) -> torch.Tensor:
    """diag(Gᵀ D G) per element → (ne, nd) from packed or full qdata.  Dense basis:
    Σ_ab G_a ∘ D_ab ∘ G_b per component.  Tensor basis: component (a, b)
    contracts with (G∘G) along the axis equal to a and b, (B∘G) along an
    axis equal to one of them, (B∘B) otherwise."""
    if not is_packed(qdata):
        if not db.tensor:
            return torch.einsum("qna,eqab,qnb->en", db.G, qdata, db.G)

        def comp(a, b):
            return qdata[:, :, a, b]
    else:
        def comp(a, b):
            return qdata[_PIDX[(a, b)]]
    if not db.tensor:
        out = None
        for a in range(3):
            for b in range(3):
                t = torch.einsum("qn,eq,qn->en", db.G[:, :, a],
                                 comp(a, b), db.G[:, :, b])
                out = t if out is None else out + t
        return out
    B, G = db.B1, db.G1
    BB, BG, GG = B * B, B * G, G * G
    out = None
    for a in range(3):
        for b in range(3):
            facs = []
            for d in range(3):
                if d == a and d == b:
                    facs.append(GG)
                elif d == a or d == b:
                    facs.append(BG)
                else:
                    facs.append(BB)
            term = contract_q_to_e(tuple(facs), comp(a, b))
            out = term if out is None else out + term
    return out
