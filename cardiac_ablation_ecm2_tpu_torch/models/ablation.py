"""Coupled RF cardiac ablation: electrostatic Laplace → SAR Joule heating →
Pennes bioheat → Arrhenius lesion (counterpart of
``cardiac_ablation_ecm2_tpu/models/ablation.py``, BASELINE.json config 4).

Per simulation:
  1. Solve ∇·(σ∇Φ) = 0 (``rf_laplace.solve``).  With ``sigma_T`` and
     ``resolve_every`` = N the potential is re-solved every N steps with
     σ(T), warm-started from the previous Φ (joule.cpp's coupling loop).
  2. Q_rf = σ|∇Φ|² enters the Pennes right-hand side.
  3. Implicit SDIRK steps of T; with ``k_T`` the conductivity k(T) is
     re-evaluated from the step-start temperature every step (lagged).
  4. Arrhenius damage Ω(t) = ∫ A·exp(−Eₐ/(R·T)) dt, trapezoidal, at the
     quadrature points; the lesion is {Ω ≥ 1} (63% cell death).

The steps run eagerly (the JAX package jits ``step`` and ``step_coupled``).
The RF solve, the bioheat operator and the damage share one restriction,
basis and set of geometric factors (``fem/build.py``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.fespace import FESpace
from ..fem.quadinterp import eval_values, eval_values_t
from ..linalg import ode
from ..ops import diffusion, mass
from ..utils.config import elapsed, real_t, resolve_device
from . import bioheat, rf_laplace

R_GAS = 8.314462618        # J/(mol K)


@dataclasses.dataclass(eq=False)
class AblationSim:
    """Coupled simulation: setup (RF solve, bioheat operator) and steppers.
    ``setup_seconds`` splits the setup into the space, the RF solve (its
    partial assembly, CG and SAR) and the operators.  ``device=None`` is the
    card."""

    mesh: object
    order: int = 2
    # RF
    sigma: float = 0.54                 # S/m
    voltage: float = 30.0               # V
    electrode_bdr: Sequence[int] = (1,)
    ground_bdr: Sequence[int] = (2,)
    # tissue thermal
    rho_c: float = 3.6e6                # J/(m³K)
    k_th: float = 0.54                  # W/(mK)
    w_cb: float = 20000.0               # perfusion ω_b c_b [W/(m³K)]
    T_a: float = 37.0
    q_met: float = 0.0
    body_bdr: Optional[Sequence[int]] = None   # fixed-T boundary
    # Arrhenius (cardiac tissue, Jacques-style parameters)
    arr_A: float = 7.39e39              # 1/s
    arr_Ea: float = 2.577e5             # J/mol
    solver: str = "sdirk33"
    rel_tol: float = 1e-10
    dtype: object = None
    #: (nx, ny, nz) to use the structured Cartesian space
    cartesian: object = None
    #: σ(T): callable on a (ne, nq) temperature Q-vector [°C] → σ Q-vector;
    #: with ``resolve_every`` > 0 the potential is re-solved with σ(T)
    sigma_T: object = None
    #: k(T): callable on a temperature Q-vector → conductivity Q-vector,
    #: re-evaluated (lagged at the step start) every step
    k_T: object = None
    #: re-run the electrostatic solve every N steps (0 = never); needs sigma_T
    resolve_every: int = 0
    device: object = None

    def __post_init__(self):
        if self.resolve_every and self.sigma_T is None:
            raise ValueError("resolve_every > 0 requires sigma_T")
        self.device = dev = resolve_device(self.device)
        self.setup_seconds = {}
        t0 = time.perf_counter()
        if self.cartesian is not None:
            from ..fem.cartesian import CartesianFESpace

            fes = CartesianFESpace(self.mesh, self.order, tuple(self.cartesian))
        else:
            fes = FESpace(self.mesh, self.order)
        t0 = self._lap("space", t0)
        self.rf = rf_laplace.solve(
            self.mesh, self.order, self.sigma, self.electrode_bdr,
            self.ground_bdr, self.voltage, dtype=self.dtype, fes=fes, device=dev)
        t0 = self._lap("rf_solve", t0)
        self.fes = fes
        self.op = bioheat.BioheatOperator(
            fes, rho_c=self.rho_c, k=self.k_th, w_cb=self.w_cb, T_a=self.T_a,
            q_met=self.q_met, q_rf=self.rf.sar_q, ess_bdr=self.body_bdr,
            rel_tol=self.rel_tol, dtype=self.dtype, device=dev)
        self._solver = ode.select(self.solver)
        self._gf = geom_factors_for(fes, None, self.dtype, dev)
        self._restr = restriction_for(fes, dev)
        self._db = basis_for(fes, self.dtype, dev)
        self._log_A = math.log(self.arr_A)
        if self.resolve_every:
            self.rf_op = rf_laplace.RFOperator(
                fes=fes, electrode_bdr=self.electrode_bdr,
                ground_bdr=self.ground_bdr, voltage=self.voltage,
                rel_tol=min(self.rel_tol, 1e-8), dtype=self.dtype, device=dev)
        self._lap("operator", t0)

    def _lap(self, name, t0):
        """Record the seconds since ``t0`` (the card synchronized) under
        ``setup_seconds[name]``; returns the new start."""
        self.setup_seconds[name] = elapsed(t0, self.device)
        return t0 + self.setup_seconds[name]

    def _Tq(self, T):
        return eval_values(self._db, self._restr.mult(T))

    def rate(self, T: torch.Tensor) -> torch.Tensor:
        """Arrhenius damage rate at the quadrature points (T in °C):
        exp(log(A) − Eₐ/(R·(T + 273.15))).

        The JAX package computes ``A * exp(-Ea / (R_GAS * (Tq + 273.15)))``
        (``cardiac_ablation_ecm2_tpu/models/ablation.py:103`` and ``:144``),
        equal in exact arithmetic.  In float32 that form fails: A = 7.39e39
        (``:59``) is above float32's largest 3.4e38 and becomes inf, and
        below ~81 °C exp(−Eₐ/RT) is subnormal, which XLA flushes to 0, so
        the rate is inf·0 = NaN there and inf above.  Here A enters through
        log(A) ≈ 91.8, and the rate (2.94e-4 s⁻¹ at 37 °C) is a normal
        float32; in float64 the two forms agree to round-off."""
        return torch.exp(self._log_A
                         - self.arr_Ea / (R_GAS * (self._Tq(T) + 273.15)))

    def step(self, T, omega_q, t, dt):
        """One step: (T, Ω, t) → (T', Ω', t + dt), the trapezoidal damage."""
        T2, t2 = self._solver.step(self.op, T, t, dt)
        omega_q = omega_q + 0.5 * dt * (self.rate(T) + self.rate(T2))
        return T2, omega_q, t2

    def _view(self, T, sar_q):
        """The operator with the step's SAR (and, with ``k_T``, k(T)) folded
        in, as the JAX package's ``_view`` (which drops ``q_met`` there)."""
        op, gf, restr, db = self.op, self._gf, self._restr, self._db
        q = op.Mw_qd * self.T_a + gf.wdet * sar_q
        kw = dict(b_const=restr.mult_transpose(eval_values_t(db, q)))
        if self.k_T is not None:
            K_qd = diffusion.setup_packed(gf, self.k_T(self._Tq(T)))
            kw["K_qd"] = K_qd
            kw["A_diag"] = restr.mult_transpose(
                diffusion.diagonal(db, K_qd) + mass.diagonal(db, op.Mw_qd))
        return op.override(**kw)

    def step_coupled(self, T, omega_q, t, dt, sar_q):
        """One step with the SAR Q-vector ``sar_q`` as the RF source (and
        k(T) with ``k_T``)."""
        T2, t2 = self._solver.step(self._view(T, sar_q), T, t, dt)
        omega_q = omega_q + 0.5 * dt * (self.rate(T) + self.rate(T2))
        return T2, omega_q, t2

    def _sigma_q(self, T):
        return self.sigma_T(self._Tq(T))

    def initial_state(self):
        T = torch.full((self.fes.ndof,), self.T_a, dtype=real_t(self.dtype),
                       device=self.device)
        return T, torch.zeros_like(self._gf.det)

    def run(self, t_final: float, dt: float, T=None, omega_q=None, t0=0.0):
        """Advance to t_final; returns (T, omega_q, t).

        With ``resolve_every`` > 0 the potential is re-solved every N steps
        with σ(T), warm-started from the previous Φ, and the new SAR feeds
        the thermal step; with ``k_T`` the conductivity follows the
        step-start temperature.  A coupled run starts from the setup's Φ and
        SAR and leaves its last ones in ``phi`` and ``sar_q``."""
        if T is None:
            T, omega_q = self.initial_state()
        t = t0
        n = int(round((t_final - t0) / dt))
        if not (self.resolve_every or self.k_T is not None):
            for _ in range(n):
                T, omega_q, t = self.step(T, omega_q, t, dt)
            return T, omega_q, t
        sar_q, phi = self.rf.sar_q, self.rf.phi
        for i in range(n):
            if self.resolve_every and i % self.resolve_every == 0:
                phi, sar_q, _ = self.rf_op.resolve(self._sigma_q(T), phi)
            T, omega_q, t = self.step_coupled(T, omega_q, t, dt, sar_q)
        self.phi, self.sar_q = phi, sar_q
        return T, omega_q, t

    def lesion_volume(self, omega_q) -> float:
        """Volume where Ω ≥ 1 (63% protein denaturation)."""
        return float(torch.sum(self._gf.wdet * (omega_q >= 1.0)))


def from_jax_state(sim: AblationSim, T, omega_q, phi=None, sar_q=None):
    """A JAX run's state as the port's: the numpy arrays T (ndof,), Ω
    (ne, nq) and, where given, Φ (ndof,) and the SAR (ne, nq) become
    tensors of ``sim``'s dtype on its device, returned as (T, Ω, Φ, SAR)
    (None for what was not given).  Continue with ``sim.step``, or with
    ``sim.rf_op.resolve`` (Φ) and ``sim.step_coupled`` (SAR).  The state
    counterpart of ``bioheat.from_jax_arrays``; the space's dof numbering
    equals the JAX package's."""
    ne, nq = sim._gf.det.shape
    want = {"T": (sim.fes.ndof,), "omega_q": (ne, nq), "phi": (sim.fes.ndof,),
            "sar_q": (ne, nq)}
    out = []
    for name, a in (("T", T), ("omega_q", omega_q), ("phi", phi), ("sar_q", sar_q)):
        if a is None:
            out.append(None)
            continue
        a = np.asarray(a)
        if a.shape != want[name]:
            raise ValueError(f"{name} has shape {a.shape}, the simulation "
                             f"{want[name]}")
        out.append(torch.tensor(a, dtype=real_t(sim.dtype), device=sim.device))
    return tuple(out)
