"""Diffusion integrator, partial assembly (counterpart of
``cardiac_ablation_ecm2_tpu/ops/diffusion.py``, 2D and 3D).

Per quadrature point ``D = (w/detJ) · adj(J) · C · adj(J)ᵀ``.  A scalar
coefficient gives packed symmetric qdata: (6, ne, nq) in 3D in the order
[D00, D11, D22, D01, D02, D12], (3, ne, nq) in 2D as [D00, D11, D01].  The
apply ``Gᵀ (D ∘ (G u))`` of 3D packed qdata on a tensor (hex) basis is
``ops/fused_diffusion.diffusion_apply`` (the hand-written kernel on the
card, the einsum chain on the CPU); 2D packed qdata and any dense
(simplex) basis take the einsum chain on every device, as the JAX
package's ``apply`` is plain XLA and its Pallas kernel is 3D only.  A
matrix coefficient (ne, nq, d, d) gives full (ne, nq, d, d) qdata, applied
by the einsum chain on any device, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..fem.geom_factors import GeometricFactors, adjugate
from ..fem.quadinterp import DeviceBasis, contract_q_to_e, eval_grad, eval_grad_t
from .fused_diffusion import diffusion_apply, diffusion_apply_plain
from .lanemajor import PAIRS

#: packed index of each (a, b) component, by the number of components
_PIDX = {len(pairs): {**{p: i for i, p in enumerate(pairs)},
                      **{p[::-1]: i for i, p in enumerate(pairs)}}
         for pairs in PAIRS.values()}


def setup(gf: GeometricFactors, coeff_q=None) -> torch.Tensor:
    """Full qdata (ne, nq, d, d); ``coeff_q`` None, (ne, nq) scalar or
    (ne, nq, d, d) matrix conductivity."""
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
    """Packed-symmetric qdata computed elementwise → (3|6, ne, nq); equal to
    ``pack_sym(setup(gf, coeff_q))`` up to rounding."""
    A = adjugate(gf.jac)
    d = A.shape[-1]
    w_over_det = gf.w[None, :] / gf.det
    if coeff_q is not None:
        w_over_det = w_over_det * coeff_q

    def dot_rows(a, c):
        s = A[..., a, 0] * A[..., c, 0]
        for b in range(1, d):
            s = s + A[..., a, b] * A[..., c, b]
        return s * w_over_det

    return torch.stack([dot_rows(a, c) for a, c in PAIRS[d]], dim=0)


def pack_sym(D: torch.Tensor) -> torch.Tensor:
    """(ne, nq, d, d) symmetric → packed (3|6, ne, nq)."""
    return torch.stack([D[..., a, c] for a, c in PAIRS[D.shape[-1]]], dim=0)


def is_packed(qdata: torch.Tensor) -> bool:
    return qdata.dim() == 3 and qdata.shape[0] in (3, 6)


def apply(db: DeviceBasis, qdata: torch.Tensor, u_e: torch.Tensor) -> torch.Tensor:
    """(ne, nd) → (ne, nd): Gᵀ (D ∘ (G u)).  Packed 3D qdata (6, ne|1, nq)
    on a tensor basis: the fused kernel; other packed qdata: the einsum
    chain; full (ne, nq, d, d) qdata: the einsum chain."""
    if not is_packed(qdata):
        return eval_grad_t(db, torch.einsum("eqab,eqb->eqa", qdata,
                                            eval_grad(db, u_e)))
    if db.tensor and db.dim == 3:
        return diffusion_apply(db, qdata, u_e)
    return diffusion_apply_plain(db, qdata, u_e)


def diagonal(db: DeviceBasis, qdata: torch.Tensor) -> torch.Tensor:
    """diag(Gᵀ D G) per element → (ne, nd) from packed or full qdata.  Dense
    basis: Σ_ab G_a ∘ D_ab ∘ G_b per component.  Tensor basis: component
    (a, b) contracts with (G∘G) along the axis equal to a and b, (B∘G)
    along an axis equal to one of them, (B∘B) otherwise."""
    dim = db.dim
    if not is_packed(qdata):
        if not db.tensor:
            return torch.einsum("qna,eqab,qnb->en", db.G, qdata, db.G)

        def comp(a, b):
            return qdata[:, :, a, b]
    else:
        pidx = _PIDX[qdata.shape[0]]

        def comp(a, b):
            return qdata[pidx[(a, b)]]
    if not db.tensor:
        out = None
        for a in range(dim):
            for b in range(dim):
                t = torch.einsum("qn,eq,qn->en", db.G[:, :, a],
                                 comp(a, b), db.G[:, :, b])
                out = t if out is None else out + t
        return out
    B, G = db.B1, db.G1
    BB, BG, GG = B * B, B * G, G * G
    out = None
    for a in range(dim):
        for b in range(dim):
            facs = []
            for d in range(dim):
                if d == a and d == b:
                    facs.append(GG)
                elif d == a or d == b:
                    facs.append(BG)
                else:
                    facs.append(BB)
            term = contract_q_to_e(tuple(facs), comp(a, b))
            out = term if out is None else out + term
    return out
