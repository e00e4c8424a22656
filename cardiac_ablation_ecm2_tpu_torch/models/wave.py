"""The second-order wave equation, MFEM's ex23 (counterpart of
``cardiac_ablation_ecm2_tpu/models/wave.py``): d²u/dt² = c²Δu with
homogeneous Dirichlet conditions, semidiscrete M a = −c² K u, the mass
solve and the implicit (M + c0 K) solve by Jacobi-PCG, driven by the
``linalg/ode2.py`` integrators.

The stiffness qdata are packed (``diffusion.setup_packed``), so on a 3D
tensor (hex) basis every K apply is the fused diffusion kernel on the
card; the JAX package applies full (ne, nq, d, d) qdata by einsums, equal
up to rounding.  The restriction's gather and segment-sum kernels carry
L→E and E→L.  Each solve's SolveInfo is kept (``mass_info``,
``implicit_info``).  ``device=None`` is the card.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.fespace import FESpace
from ..linalg.solvers import cg
from ..ops import diffusion, mass
from ..utils.config import resolve_device


@dataclasses.dataclass(eq=False)
class WaveOperator:
    """SecondOrderTimeDependentOperator for the wave equation."""

    fes: FESpace
    c2: float = 1.0                     # wave speed squared
    ess_bdr: object = None              # None ⇒ all boundary attributes
    rel_tol: float = 1e-11
    max_iter: int = 500
    dtype: object = None
    device: object = None

    def __post_init__(self):
        fes = self.fes
        dev = self.device = resolve_device(self.device)
        self.restr = restriction_for(fes, dev)
        self.db = basis_for(fes, self.dtype, dev)
        self.gf = geom_factors_for(fes, dtype=self.dtype, device=dev)
        self.M_qd = mass.setup(self.gf)
        self.K_qd = diffusion.setup_packed(self.gf) * self.c2
        self.M_diag = self.restr.mult_transpose(mass.diagonal(self.db, self.M_qd))
        self.K_diag = self.restr.mult_transpose(
            diffusion.diagonal(self.db, self.K_qd))
        self.ess = torch.as_tensor(fes.essential_dofs(self.ess_bdr), device=dev)
        self.mass_info = self.implicit_info = None

    def _apply(self, qd_m, qd_k, v, cm=1.0, ck=1.0):
        """Rᵀ(cm·M_e + ck·K_e)R v; a term whose coefficient is the number
        0 is skipped (the JAX package adds it times 0)."""
        e = self.restr.mult(v)
        out = 0.0
        if not (isinstance(cm, float) and cm == 0.0):
            out = cm * mass.apply(self.db, qd_m, e)
        if not (isinstance(ck, float) and ck == 0.0):
            out = out + ck * diffusion.apply(self.db, qd_k, e)
        return self.restr.mult_transpose(out)

    def _z(self, v):
        v = v.clone()
        v[self.ess] = 0.0
        return v

    def _solve(self, op, rhs, d):
        d = d.clone()
        d[self.ess] = 1.0
        a, info = cg(op, rhs, M=lambda r: r / d, rel_tol=self.rel_tol,
                     max_iter=self.max_iter)
        return self._z(a), info

    def mult(self, t, u, v):
        """a = M⁻¹(−K u)."""
        rhs = self._z(-self._apply(self.M_qd, self.K_qd, self._z(u), 0.0, 1.0))

        def Mop(w):
            z = self._z(w)
            return self._z(self._apply(self.M_qd, self.K_qd, z, 1.0, 0.0)) + (w - z)

        a, self.mass_info = self._solve(Mop, rhs, self.M_diag)
        return a

    def implicit_solve(self, c0, c1, t, u, v):
        """Solve a = −M⁻¹K(u + c0·a)  ⇒  (M + c0 K) a = −K u."""
        rhs = self._z(-self._apply(self.M_qd, self.K_qd, self._z(u), 0.0, 1.0))

        def Top(w):
            z = self._z(w)
            return self._z(self._apply(self.M_qd, self.K_qd, z, 1.0, c0)) + (w - z)

        a, self.implicit_info = self._solve(Top, rhs, self.M_diag + c0 * self.K_diag)
        return a

    def energy(self, u, v) -> float:
        """The discrete energy ½(v, Mv) + ½(u, Ku) on the constrained
        vectors (the quantity Newmark β = 1/4 conserves)."""
        uz = self._z(u)
        Ku = self._apply(self.M_qd, self.K_qd, uz, 0.0, 1.0)
        Mv = self._apply(self.M_qd, self.K_qd, self._z(v), 1.0, 0.0)
        return 0.5 * float(torch.dot(v, Mv)) + 0.5 * float(torch.dot(uz, Ku))


def make_stepper(op: WaveOperator, solver):
    """(u, v, t, dt) → (u, v, t + dt) by ``solver`` (``select2``)."""

    def step(u, v, t, dt):
        return solver.step(op, u, v, t, dt)

    return step
