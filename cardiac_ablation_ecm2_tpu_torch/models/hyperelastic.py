"""Quasi-static compressible neo-Hookean hyperelasticity, MFEM's ex10
(counterpart of ``cardiac_ablation_ecm2_tpu/models/hyperelastic.py``).

Only the stored energy is written,

    E(u) = Σ_q w·detJ · W(F(u)) − (b, u),   F = I + ∇ₓu,

through the partial-assembly pipeline: L→E by ``restr.mult`` a component
at a time (the restriction's gather kernel on the card), reference
gradients by ``eval_grad`` (scalar contractions), the pull-back through
adj(J)/det(J) as elementwise products (no batched 3×3 matmuls, which
dominated the jvp of the residual on the CPU) and the closed-form 3×3 /
2×2 determinant of ``fem/geom_factors.py``.  The
residual is ``torch.func.grad`` of E, through the restriction's autograd
Functions (the segment-sum kernel is the gather's adjoint), with the
essential rows replaced by u.  Newton's tangent (``tangent``) builds the
gradient's graph once a Newton step (``create_graph``) and applies the
Hessian by one backward pass through it per Krylov apply, the essential
rows the identity: JAX's ``jax.linearize`` of the residual, which runs
the primal once a step.  ``linalg/newton.jacobian_action`` (a jvp of
the residual, the primal re-run each apply) computes the same action.  The Jacobi preconditioner is the
small-strain elasticity diagonal with λ = κ − 2μ/d, as in the JAX package.
``device=None`` is the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.fespace import FESpace
from ..fem.geom_factors import adjugate, determinant
from ..fem.quadinterp import eval_grad
from ..linalg.newton import gradient_tangent, newton
from ..ops.bilinearform import BilinearForm
from ..ops.linearform import boundary_lf_vector
from ..utils.config import real_t, resolve_device


def neo_hookean_W(F: torch.Tensor, mu: float, kappa: float) -> torch.Tensor:
    """Compressible neo-Hookean stored energy (NeoHookeanModel):
    W = μ/2 (J^{-2/d}·I₁ − d) + κ/2 (J−1)², J = det F (closed form)."""
    d = F.shape[-1]
    J = determinant(F)
    I1 = torch.einsum("...ab,...ab->...", F, F)
    Js = torch.clamp_min(J, 1e-8)
    return 0.5 * mu * (Js ** (-2.0 / d) * I1 - d) + 0.5 * kappa * (J - 1.0) ** 2


@dataclasses.dataclass(eq=False)
class HyperelasticProblem:
    """min E(u) subject to u = 0 on ``fixed_bdr``, with a dead surface load
    ``force`` (default (0, …, −0.05)) on ``force_bdr``."""

    fes: FESpace                     # vector space (vdim == dim)
    mu: float = 1.0
    kappa: float = 10.0
    fixed_bdr: Sequence[int] = (1,)
    force_bdr: Sequence[int] = (2,)
    force: Optional[np.ndarray] = None
    dtype: object = None
    device: object = None

    def __post_init__(self):
        fes = self.fes
        dim = fes.mesh.dim
        assert fes.vdim == dim
        dev = self.device = resolve_device(self.device)
        self.restr = restriction_for(fes, dev)
        self.db = basis_for(fes, self.dtype, dev)
        self.gf = geom_factors_for(fes, dtype=self.dtype, device=dev)
        self.Ainv = adjugate(self.gf.jac) / self.gf.det[..., None, None]
        ess_s = fes.essential_dofs(self.fixed_bdr).astype(np.int64)
        ess = np.concatenate([ess_s + c * fes.ndof_scalar for c in range(dim)])
        self.ess = torch.as_tensor(ess, device=dev)
        is_ess = torch.zeros(fes.ndof, dtype=torch.bool, device=dev)
        is_ess[self.ess] = True
        self.is_ess = is_ess
        self.free = (~is_ess).to(real_t(self.dtype))
        if self.force is None:
            f = np.zeros(dim)
            f[-1] = -0.05
            self.force = f
        self.b = boundary_lf_vector(fes, self.force, bdr_marker=self.force_bdr,
                                    dtype=self.dtype, device=dev)
        self.dim = dim
        # fixed Jacobi preconditioner from the small-strain (linearized)
        # elasticity diagonal, spectrally close to the consistent tangent
        lam_eff = self.kappa - 2.0 * self.mu / dim
        dlin = (BilinearForm(fes, dev)
                .add_domain_integrator("elasticity", coeff=(lam_eff, self.mu))
                .assemble(self.dtype).diagonal())
        dlin[self.ess] = 1.0
        self._prec_inv = 1.0 / dlin

    # -- energy through the PA pipeline --------------------------------
    def deformation_gradient(self, u_flat: torch.Tensor) -> torch.Tensor:
        us = u_flat.view(self.dim, -1)
        g = torch.stack([eval_grad(self.db, self.restr.mult(us[c]))
                         for c in range(self.dim)], dim=-1)   # (ne, nq, dref, dim)
        # ∇ₓu[a,c] = Σ_r Jinv[r,a] g[r,c]
        H = (self.Ainv[..., :, :, None] * g[..., :, None, :]).sum(-3)
        return H + torch.eye(self.dim, dtype=H.dtype, device=H.device)

    def energy(self, u_flat: torch.Tensor) -> torch.Tensor:
        W = neo_hookean_W(self.deformation_gradient(u_flat), self.mu, self.kappa)
        return torch.sum(self.gf.wdet * W) - torch.dot(self.b, u_flat)

    def residual(self, u_flat: torch.Tensor) -> torch.Tensor:
        """∂E/∂u with the essential rows replaced by u."""
        r = torch.func.grad(self.energy)(u_flat)
        return torch.where(self.is_ess, u_flat, r)

    def tangent(self, u_flat: torch.Tensor):
        """v ↦ J(u) v for the residual (``gradient_tangent``: the Hessian of
        E through the gradient's graph, built once; the essential rows the
        identity)."""
        return gradient_tangent(self.energy, u_flat, self.free)

    def solve(self, rel_tol=1e-9, max_iter=30, linear_max_iter=800):
        u0 = torch.zeros(self.fes.ndof, dtype=real_t(self.dtype),
                         device=self.device)
        inv = self._prec_inv
        return newton(self.residual, u0, rel_tol=rel_tol, max_iter=max_iter,
                      linear_rel_tol=1e-8, linear_max_iter=linear_max_iter,
                      line_search=12, precond=lambda u: (lambda r: inv * r),
                      tangent=self.tangent)

    def displacement(self, u_flat: torch.Tensor) -> np.ndarray:
        return u_flat.detach().cpu().numpy().reshape(self.dim, self.fes.ndof_scalar).T
