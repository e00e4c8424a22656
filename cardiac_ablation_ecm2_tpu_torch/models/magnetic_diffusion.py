"""Transient magnetic diffusion on H(curl), the magnetic-diffusion substep
of MFEM's ``joule`` miniapp (counterpart of
``cardiac_ablation_ecm2_tpu/models/magnetic_diffusion.py``):

    σ ∂A/∂t + curl(ν curl A) = J_s,   n × A = 0 on the PEC attributes.

A TimeDependentOperator on the ND space for ``linalg/ode.RKSolver``: the
implicit SDIRK stages solve (σM + γ CC) k = J_s − CC A with Jacobi-PCG,
run eagerly (one host read per iteration).  Both operators are
``ops/vecfe`` applies, so every gather and scatter is the ND space's
restriction kernels; B = curl A stays divergence-free through
``discrete_curl`` / ``discrete_divergence``.  Each solve appends its CG
count to ``cg_iterations``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..linalg.solvers import cg
from ..ops.vecfe import build_nd_operator, vecfe_linear_form
from ..utils.config import real_t, resolve_device


@dataclasses.dataclass(eq=False)
class MagneticDiffusionOperator:
    """σ dA/dt = −curl(ν curl A) + J_s, PEC on ``ess_bdr``; ``source`` is
    J_s(x) of host numpy points (a linear form's callable) or None;
    ``device=None`` is the card."""

    nd_space: object
    sigma: float = 1.0
    nu: float = 1.0
    source: object = None
    ess_bdr: Optional[Sequence[int]] = None
    nq1d: int = 3
    rel_tol: float = 1e-10
    max_iter: int = 2000
    dtype: object = None
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        rt = real_t(self.dtype)
        sp = self.nd_space
        kw = dict(nq1d=self.nq1d, dtype=self.dtype, device=self.device)
        self.M = build_nd_operator(sp, mass_coeff=self.sigma, curlcurl_coeff=None, **kw)
        self.CC = build_nd_operator(sp, mass_coeff=None, curlcurl_coeff=self.nu, **kw)
        self.b = (vecfe_linear_form(self.M, self.source) / self.sigma
                  if self.source is not None
                  else torch.zeros(self.M.ndof, dtype=rt, device=self.device))
        ess = sp.essential_dofs(self.ess_bdr) if self.ess_bdr else np.zeros(0, np.int32)
        mask = np.ones(self.M.ndof)
        mask[ess] = 0.0
        self.mask = torch.as_tensor(mask, dtype=rt, device=self.device)
        self.dM = self.M.diagonal() * self.mask + (1 - self.mask)
        self.dCC = self.CC.diagonal()
        self.cg_iterations = []

    def residual(self, A):
        return (self.b - self.CC.mult(A)) * self.mask

    def _solve(self, lhs, rhs, dg):
        x, info = cg(lhs, rhs, M=lambda r: r / dg, rel_tol=self.rel_tol,
                     max_iter=self.max_iter)
        self.cg_iterations.append(info.iterations)
        return x * self.mask

    def mult(self, t, A):
        """dA/dt = M⁻¹ (J_s − CC A)."""
        m = self.mask

        def Mc(v):
            z = v * m
            return self.M.mult(z) * m + (v - z)

        return self._solve(Mc, self.residual(A), self.dM)

    def implicit_solve(self, gamma, t, A):
        """(M + γ CC) k = J_s − CC A."""
        m = self.mask

        def lhs(v):
            z = v * m
            return (self.M.mult(z) + gamma * self.CC.mult(z)) * m + (v - z)

        return self._solve(lhs, self.residual(A), self.dM + gamma * self.dCC * m)
