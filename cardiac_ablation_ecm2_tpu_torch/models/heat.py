"""Nonlinear heat conduction, the ex16 slice (counterpart of
``cardiac_ablation_ecm2_tpu/models/heat.py``; MFEM's ``examples/ex16.cpp``
``ConductionOperator``): du/dt = M⁻¹(−K(u)u) with κ(u) = κ₀ + α·u, and the
SDIRK stage solve (M + γK(u)) k = −K(u)u with κ frozen at the stage's base
state (the reference's linearization, ex16.cpp:327-356).

K(u)'s qdata are recomputed from the current solution's values at the
quadrature points each solve; its apply is ``ops/diffusion.apply`` (the
``fused_diffusion`` kernel on the card) between the restriction's gather
and segment-sum, the mass apply the einsum chain of ``ops/mass.py``.  The
solves are Jacobi-PCG, run eagerly (one host read per iteration).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.fespace import FESpace
from ..fem.quadinterp import eval_values
from ..linalg.solvers import cg
from ..ops import diffusion, mass
from ..utils.config import real_t, resolve_device


@dataclasses.dataclass(eq=False)
class ConductionOperator:
    """TimeDependentOperator for du/dt = M⁻¹(−K(u)u) (ex16.cpp:52) on
    ``device`` (``None``: the card).  Each stage solve appends its CG
    iteration count to ``cg_iterations``."""

    fes: FESpace
    kappa: float = 0.5
    alpha: float = 0.01
    ess_bdr: object = ()            # boundary attributes with fixed temperature
    rel_tol: float = 1e-10
    max_iter: int = 500
    dtype: object = None
    device: object = None

    def __post_init__(self):
        fes = self.fes
        self.device = dev = resolve_device(self.device)
        self.restr = restriction_for(fes, dev)
        self.db = basis_for(fes, self.dtype, dev)
        self.gf = geom_factors_for(fes, None, self.dtype, dev)
        self.mass_qd = mass.setup(self.gf)
        self.mass_diag = self.restr.mult_transpose(mass.diagonal(self.db,
                                                                 self.mass_qd))
        ess = (fes.essential_dofs(self.ess_bdr) if self.ess_bdr
               else np.zeros(0, dtype=np.int32))
        self.has_ess = len(ess) > 0
        m = np.ones(fes.ndof, dtype=np.float64)
        m[np.asarray(ess, np.int64)] = 0.0
        self.ess_mask = torch.as_tensor(m, dtype=real_t(self.dtype), device=dev)
        self.cg_iterations = []

    def _zero_ess(self, v):
        return v * self.ess_mask if self.has_ess else v

    # -- internals -------------------------------------------------------
    def _kappa_q(self, u):
        """κ(u) = κ₀ + α·u at the quadrature points."""
        uq = eval_values(self.db, self.restr.mult(u))
        return self.kappa + self.alpha * uq

    def _K_apply(self, qd, v):
        e = self.restr.mult(v)
        return self.restr.mult_transpose(diffusion.apply(self.db, qd, e))

    def _M_apply(self, v):
        e = self.restr.mult(v)
        return self.restr.mult_transpose(mass.apply(self.db, self.mass_qd, e))

    def _jacobi(self, diag):
        if self.has_ess:
            diag = diag * self.ess_mask + (1.0 - self.ess_mask)
        inv = 1.0 / diag
        return lambda r: inv * r

    # -- TimeDependentOperator protocol -----------------------------------
    def mult(self, t, u):
        """du/dt = M⁻¹(−K(u)u) by CG on the mass matrix (ex16.cpp:317-325)."""
        qd = diffusion.setup_packed(self.gf, self._kappa_q(u))
        rhs = self._zero_ess(-self._K_apply(qd, u))

        def Mc(v):
            z = self._zero_ess(v)
            return self._zero_ess(self._M_apply(z)) + (v - z)

        x, _ = cg(Mc, rhs, M=self._jacobi(self.mass_diag), rel_tol=self.rel_tol,
                  max_iter=self.max_iter)
        return self._zero_ess(x)

    def implicit_solve(self, gamma, t, u):
        """Solve (M + γK(u)) k = −K(u)u (ex16.cpp:327-356)."""
        qd = diffusion.setup_packed(self.gf, self._kappa_q(u))

        def T_apply(v):
            z = self._zero_ess(v)
            y = self._M_apply(z) + gamma * self._K_apply(qd, z)
            return self._zero_ess(y) + (v - z)

        rhs = self._zero_ess(-self._K_apply(qd, u))
        kdiag = diffusion.diagonal(self.db, qd)
        diag = self.mass_diag + gamma * self.restr.mult_transpose(kdiag)
        k, info = cg(T_apply, rhs, M=self._jacobi(diag), rel_tol=self.rel_tol,
                     max_iter=self.max_iter)
        self.cg_iterations.append(info.iterations)
        return self._zero_ess(k)


def make_stepper(op: ConductionOperator, solver) -> Callable:
    """``(u, t, dt) -> (u', t')`` for one step of ``solver`` on ``op``."""

    def step(u, t, dt):
        return solver.step(op, u, t, dt)

    return step
