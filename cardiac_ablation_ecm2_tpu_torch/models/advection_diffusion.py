"""IMEX advection–diffusion on DG, the ex41 operator (counterpart of
``cardiac_ablation_ecm2_tpu/models/advection_diffusion.py``): the nonstiff
upwind DG advection integrated explicitly and the stiff SIPG diffusion
implicitly, with the IMEX solvers of ``linalg/ode.py``.

    du/dt = −v·∇u + ε Δu
    f_ex(u) = M⁻¹ K_adv u (upwind DG)      — explicit part
    implicit_solve(γ): (M + γ A_sipg) k = −A_sipg u   (Jacobi-PCG)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..fem.build import basis_for, geom_factors_for
from ..fem.fespace import L2FESpace
from ..fem.quadinterp import eval_values, eval_values_t
from ..linalg.solvers import cg
from ..ops import mass as mmod
from ..ops.dg_advection import DGAdvection
from ..ops.dg_diffusion import DGDiffusion
from ..utils.config import real_t, resolve_device


@dataclasses.dataclass(eq=False)
class DGAdvectionDiffusion:
    """IMEX time-dependent operator: explicit upwind advection, implicit
    SIPG diffusion; ``device=None`` is the card.  ``cg_iterations`` records
    the CG count of every solve."""

    fes: L2FESpace
    velocity: Callable
    epsilon: float = 1e-2
    inflow: Optional[Callable] = None
    rel_tol: float = 1e-10
    max_iter: int = 500
    dtype: object = None
    device: object = None

    def __post_init__(self):
        fes = self.fes
        self.device = dev = resolve_device(self.device)
        self.dtype = rt = real_t(self.dtype)
        self.adv = DGAdvection(fes, self.velocity, inflow=self.inflow,
                               dtype=rt, device=dev)
        self.dif = DGDiffusion(fes, kappa=self.epsilon, dtype=rt, device=dev)
        self.db = basis_for(fes, rt, dev)
        self.mass_qd = mmod.setup(geom_factors_for(fes, None, rt, dev))
        self.mass_diag = mmod.diagonal(self.db, self.mass_qd).reshape(-1)
        self.dif_diag = self.dif.diagonal()
        self.ne, self.nd = fes.mesh.ne, fes.nd_elem
        self.cg_iterations = []

    def _M_apply(self, v):
        e = v.reshape(self.ne, self.nd)
        return eval_values_t(self.db, self.mass_qd * eval_values(self.db, e)).reshape(-1)

    def _solve(self, A, rhs, diag):
        k, info = cg(A, rhs, M=lambda r: r / diag, rel_tol=self.rel_tol,
                     max_iter=self.max_iter)
        self.cg_iterations.append(info.iterations)
        return k

    # -- IMEX protocol -------------------------------------------------
    def mult_explicit(self, t, u):
        return self.adv.mult(t, u)

    def implicit_solve(self, gamma, t, u):
        return self._solve(lambda v: self._M_apply(v) + gamma * self.dif.mult(v),
                           -self.dif.mult(u), self.mass_diag + gamma * self.dif_diag)

    def mult(self, t, u):
        """Full explicit evaluation (for small-dt reference runs)."""
        k = self._solve(self._M_apply, -self.dif.mult(u), self.mass_diag)
        return self.adv.mult(t, u) + k
