"""Second-order ODE integrators for d²u/dt² = f(t, u, du/dt) (counterpart
of ``cardiac_ablation_ecm2_tpu/linalg/ode2.py``, which imports no JAX; this
is the port's own copy): Newmark-β, the generalized-α family and the
symplectic SIA integrators, MFEM's ``linalg/ode2.cpp`` family behind ex23
(wave equation) and ex10 (hyperelastic dynamics).

Operator protocol:
* ``mult(t, u, v) -> a``  (explicit acceleration)
* ``implicit_solve(c0, c1, t, u, v) -> a`` solving
  ``a = f(t, u + c0·a, v + c1·a)`` (``SecondOrderTimeDependentOperator::
  ImplicitSolve(fac0, fac1, x, dxdt, k)``).

The integrators are plain arithmetic on whatever the operator returns
(tensors on any device, or numbers).  Newmark's implicit branch evaluates
``f.mult(t, u, v)`` once where the JAX source writes it twice (XLA merges
the two under ``jit``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NewmarkSolver:
    """Newmark-β (default: average acceleration, unconditionally stable,
    2nd order; β=0 γ=1/2 gives explicit central difference)."""

    beta: float = 0.25
    gamma: float = 0.5

    def step(self, f, u, v, t, dt):
        b, g = self.beta, self.gamma
        if b == 0.0:
            a = f.mult(t, u, v)
            u1 = u + dt * v + 0.5 * dt * dt * a
            a1 = f.mult(t + dt, u1, v)        # predictor for velocity update
            v1 = v + dt * ((1 - g) * a + g * a1)
            return u1, v1, t + dt
        a0 = f.mult(t, u, v)
        up = u + dt * v + (0.5 - b) * dt * dt * a0
        vp = v + (1 - g) * dt * a0
        a1 = f.implicit_solve(b * dt * dt, g * dt, t + dt, up, vp)
        u1 = up + b * dt * dt * a1
        v1 = vp + g * dt * a1
        return u1, v1, t + dt


@dataclasses.dataclass(frozen=True)
class GeneralizedAlpha2Solver:
    """Generalized-α for 2nd-order systems (Chung & Hulbert 1993).

    Reference analog: ``GeneralizedAlpha2Solver`` / ``HHTAlphaSolver`` /
    ``WBZAlphaSolver`` (``linalg/ode2.cpp``).  Convention: the intermediate
    state is x_{n+1-α} = (1-α)·x_{n+1} + α·x_n, so α_m weights the *old*
    acceleration.  ρ∞=1 recovers average-acceleration Newmark (no numerical
    dissipation); ρ∞=0 annihilates the highest frequency in one step.

    Stateful in the acceleration: ``step`` takes and returns ``a``;
    initialize with ``a0 = f.mult(t0, u0, v0)``.
    """

    alpha_m: float
    alpha_f: float
    beta: float
    gamma: float

    @classmethod
    def from_rho(cls, rho_inf: float = 1.0):
        r = float(rho_inf)
        am = (2.0 * r - 1.0) / (r + 1.0)
        af = r / (r + 1.0)
        return cls(am, af, 0.25 * (1.0 - am + af) ** 2, 0.5 - am + af)

    @classmethod
    def hht(cls, alpha: float = 0.1):
        """HHT-α (α∈[0,1/3]): α_m=0, β=(1+α)²/4, γ=1/2+α."""
        a = float(alpha)
        return cls(0.0, a, 0.25 * (1.0 + a) ** 2, 0.5 + a)

    @classmethod
    def wbz(cls, alpha_m: float = 0.1):
        """WBZ-α: α_f=0, β=(1-α_m)²/4, γ=1/2-α_m."""
        am = float(alpha_m)
        return cls(am, 0.0, 0.25 * (1.0 - am) ** 2, 0.5 - am)

    def init(self, f, u, v, t):
        return f.mult(t, u, v)

    def step(self, f, u, v, a, t, dt):
        am, af, b, g = self.alpha_m, self.alpha_f, self.beta, self.gamma
        w = 1.0 - af                       # weight on the new state
        r = am / (1.0 - am)
        # k = a_{n+1-αm}; the F-side states seen by implicit_solve are
        # u_{n+1-αf} = up + c0·k, v_{n+1-αf} = vp + c1·k
        c0 = w * b * dt * dt / (1.0 - am)
        c1 = w * g * dt / (1.0 - am)
        up = u + w * dt * v + w * dt * dt * ((0.5 - b) - b * r) * a
        vp = v + w * dt * ((1.0 - g) - g * r) * a
        k = f.implicit_solve(c0, c1, t + w * dt, up, vp)
        a1 = (k - am * a) / (1.0 - am)
        u1 = u + dt * v + dt * dt * ((0.5 - b) * a + b * a1)
        v1 = v + dt * ((1.0 - g) * a + g * a1)
        return u1, v1, a1, t + dt


def select2(name: str, **kw):
    """Registry for 2nd-order solvers (SecondOrderODESolver::Select analog).

    Newmark with (β=1/4, γ=1/2) = average acceleration (A-stable, 2nd order);
    (β=0, γ=1/2) = explicit central difference.  Generalized-α family via
    ``generalized_alpha`` (rho_inf=), ``hht`` (alpha=), ``wbz`` (alpha_m=)."""
    if name in ("newmark", "average_acceleration"):
        return NewmarkSolver()
    if name == "central_difference":
        return NewmarkSolver(beta=0.0, gamma=0.5)
    if name == "linear_acceleration":
        return NewmarkSolver(beta=1.0 / 6.0, gamma=0.5)
    if name == "generalized_alpha":
        return GeneralizedAlpha2Solver.from_rho(kw.get("rho_inf", 1.0))
    if name == "hht":
        return GeneralizedAlpha2Solver.hht(kw.get("alpha", 0.1))
    if name == "wbz":
        return GeneralizedAlpha2Solver.wbz(kw.get("alpha_m", 0.1))
    raise ValueError(name)


@dataclasses.dataclass(frozen=True)
class SIASolver:
    """Symplectic integration algorithm for separable systems
    q' = p/…, p' = F(q) (SIAVSolver analog, linalg/ode.hpp:SIA*).

    Operator protocol: ``f.force(t, q) -> dp/dt`` and
    ``f.velocity(t, p) -> dq/dt``.  Orders 1 (symplectic Euler),
    2 (velocity Verlet / leapfrog), 4 (Ruth/Forest).
    """

    order: int = 2

    _COEFFS = {
        1: ([1.0], [1.0]),
        2: ([0.5, 0.5], [1.0, 0.0]),
        4: (
            [0.675603595979829, -0.175603595979829,
             -0.175603595979829, 0.675603595979829],
            [1.351207191959658, -1.702414383919315, 1.351207191959658, 0.0],
        ),
    }

    def step(self, f, q, p, t, dt):
        a, b = self._COEFFS[self.order]
        for ai, bi in zip(a, b):
            q = q + (ai * dt) * f.velocity(t, p)
            if bi != 0.0:
                p = p + (bi * dt) * f.force(t, q)
        return q, p, t + dt
