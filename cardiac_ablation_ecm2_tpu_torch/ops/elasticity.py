"""Linear elasticity integrator, partial assembly (counterpart of
``cardiac_ablation_ecm2_tpu/ops/elasticity.py``; MFEM's
``ElasticityIntegrator``):

    a(u, v) = ∫ λ (div u)(div v) + 2μ ε(u):ε(v)

qdata = (adj(J), w·λ/det, w·μ/det).  The apply pulls reference gradients to
physical space through adj(J), forms the stress and pulls back:

    H = adjᵀ g,   S = λ* tr(H) I + μ* (H + Hᵀ),   W = adj · S,   y = Gᵀ W.

E-vectors carry vdim == dim components: (ne, nd, dim).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..fem.geom_factors import GeometricFactors, adjugate
from ..fem.quadinterp import DeviceBasis, contract_q_to_e, eval_grad, eval_grad_t


def setup(gf: GeometricFactors, lam_q=None, mu_q=None) -> Tuple:
    """qdata (adj, w·λ/det, w·μ/det); λ, μ None (1) or (ne, nq)."""
    w_over_det = gf.w[None, :] / gf.det
    lam = 1.0 if lam_q is None else lam_q
    mu = 1.0 if mu_q is None else mu_q
    return (adjugate(gf.jac), lam * w_over_det, mu * w_over_det)


def apply(db: DeviceBasis, qdata: Tuple, u_e: torch.Tensor) -> torch.Tensor:
    A, lam, mu = qdata
    g = eval_grad(db, u_e)                           # (ne, nq, dim, vdim)
    H = torch.einsum("eqsa,eqsc->eqac", A, g)        # det-scaled ∇u
    trH = torch.diagonal(H, dim1=2, dim2=3).sum(-1)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    S = (lam[..., None, None] * trH[..., None, None] * eye
         + mu[..., None, None] * (H + H.transpose(2, 3)))
    return eval_grad_t(db, torch.einsum("eqra,eqac->eqrc", A, S))


def diagonal(db: DeviceBasis, qdata: Tuple) -> torch.Tensor:
    """(ne, nd, vdim): for φ_n e_c the energy density is
    (λ* + 2μ*) h_c² + μ* Σ_{a≠c} h_a², h = adjᵀ g_n: per-component
    quadratic forms K_c[r, s] contracted as the diffusion diagonal is."""
    A, lam, mu = qdata
    dim = A.shape[-1]
    C = torch.einsum("eqra,eqsa->eqars", A, A)       # (ne, nq, a, r, s)
    diags = []
    for c in range(dim):
        K = (lam + 2.0 * mu)[..., None, None] * C[:, :, c]
        for a in range(dim):
            if a != c:
                K = K + mu[..., None, None] * C[:, :, a]
        diags.append(_diag_quadform(db, K))
    return torch.stack(diags, dim=-1)


def _diag_quadform(db: DeviceBasis, K: torch.Tensor) -> torch.Tensor:
    """diag_n = Σ_q Σ_rs K[r, s] (g_n)_r (g_n)_s."""
    if not db.tensor:
        return torch.einsum("qnr,eqrs,qns->en", db.G, K, db.G)
    B, G = db.B1, db.G1
    BB, BG, GG = B * B, B * G, G * G
    dim = db.dim
    out = None
    for r in range(dim):
        for s in range(dim):
            facs = tuple(GG if d == r and d == s else
                         BG if d == r or d == s else BB for d in range(dim))
            term = contract_q_to_e(facs, K[:, :, r, s])
            out = term if out is None else out + term
    return out
