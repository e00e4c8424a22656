"""ODE time integrators (copy of ``cardiac_ablation_ecm2_tpu/linalg/ode.py``;
MFEM's ``linalg/ode.hpp`` catalog): explicit RK (forward Euler, RK2,
RK3-SSP, RK4), DIRK (backward Euler, implicit midpoint, SDIRK23/33/34,
trapezoidal, ESDIRK32/33), the IMEX pairs, Adams–Bashforth 1–5 and
Adams–Moulton 1–4, selected by name or MFEM numeric id (``select``).

An operator is a duck-typed object with

* ``mult(t, u) -> du/dt``                        (explicit evaluation)
* ``implicit_solve(gamma, t, u) -> k``           solving k = f(t, u + γ·k)
* (IMEX) ``mult_explicit(t, u)`` for the non-stiff part, with
  ``implicit_solve`` applying only to the stiff part.

Every ``step(f, u, t, dt) -> (u_new, t_new)`` uses only ``+`` and ``*`` on
the state, so it runs on torch tensors unchanged; the multistep solvers
keep their history (the operator's own outputs) on the state's device,
one solver instance per trajectory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    a: np.ndarray   # (s, s)
    b: np.ndarray   # (s,)
    c: np.ndarray   # (s,)
    order: int
    name: str

    @property
    def stages(self) -> int:
        return len(self.b)

    @property
    def is_explicit(self) -> bool:
        return bool(np.allclose(np.triu(self.a), 0.0))


def _bt(a, b, c, order, name):
    return ButcherTableau(
        np.asarray(a, float), np.asarray(b, float), np.asarray(c, float),
        order, name,
    )


# --- explicit tableaus (linalg/ode.cpp explicit catalog) --------------------
FORWARD_EULER = _bt([[0.0]], [1.0], [0.0], 1, "forward_euler")
RK2 = _bt([[0, 0], [2 / 3, 0]], [1 / 4, 3 / 4], [0, 2 / 3], 2, "rk2")  # a=2/3 (MFEM default)
RK3_SSP = _bt(
    [[0, 0, 0], [1, 0, 0], [1 / 4, 1 / 4, 0]],
    [1 / 6, 1 / 6, 2 / 3],
    [0, 1, 1 / 2],
    3,
    "rk3_ssp",
)
RK4 = _bt(
    [[0, 0, 0, 0], [0.5, 0, 0, 0], [0, 0.5, 0, 0], [0, 0, 1, 0]],
    [1 / 6, 1 / 3, 1 / 3, 1 / 6],
    [0, 0.5, 0.5, 1],
    4,
    "rk4",
)

# --- DIRK tableaus ----------------------------------------------------------
BACKWARD_EULER = _bt([[1.0]], [1.0], [1.0], 1, "backward_euler")
IMPLICIT_MIDPOINT = _bt([[0.5]], [1.0], [0.5], 2, "implicit_midpoint")

_g23 = (3.0 + math.sqrt(3.0)) / 6.0
SDIRK23 = _bt(           # A-stable 2-stage order-3 (Crouzeix; SDIRK23Solver)
    [[_g23, 0.0], [1.0 - 2.0 * _g23, _g23]],
    [0.5, 0.5],
    [_g23, 1.0 - _g23],
    3,
    "sdirk23",
)

_g33 = 0.435866521508458999416019  # root of x^3-3x^2+3x/2-1/6 (L-stable)
_b1_33 = -1.5 * _g33**2 + 4.0 * _g33 - 0.25
_b2_33 = 1.5 * _g33**2 - 5.0 * _g33 + 1.25
SDIRK33 = _bt(           # L-stable 3-stage order-3 (Alexander; SDIRK33Solver)
    [[_g33, 0, 0], [(1.0 - _g33) / 2.0, _g33, 0], [_b1_33, _b2_33, _g33]],
    [_b1_33, _b2_33, _g33],
    [_g33, (1.0 + _g33) / 2.0, 1.0],
    3,
    "sdirk33",
)

_g34 = 0.5 + math.cos(math.pi / 18.0) / math.sqrt(3.0)
_d34 = 1.0 / (6.0 * (2.0 * _g34 - 1.0) ** 2)
SDIRK34 = _bt(           # A-stable 3-stage order-4 (Crouzeix; SDIRK34Solver)
    [[_g34, 0, 0], [0.5 - _g34, _g34, 0], [2.0 * _g34, 1.0 - 4.0 * _g34, _g34]],
    [_d34, 1.0 - 2.0 * _d34, _d34],
    [_g34, 0.5, 1.0 - _g34],
    4,
    "sdirk34",
)

TRAPEZOIDAL = _bt(       # Crank–Nicolson as ESDIRK (TrapezoidalRuleSolver)
    [[0, 0], [0.5, 0.5]], [0.5, 0.5], [0, 1], 2, "trapezoidal"
)

_ge32 = 1.0 - math.sqrt(2.0) / 2.0
ESDIRK32 = _bt(          # L-stable 3-stage order-2 (TR-BDF2 family)
    [[0, 0, 0], [_ge32, _ge32, 0],
     [math.sqrt(2.0) / 4.0, math.sqrt(2.0) / 4.0, _ge32]],
    [math.sqrt(2.0) / 4.0, math.sqrt(2.0) / 4.0, _ge32],
    [0.0, 2.0 * _ge32, 1.0],
    2,
    "esdirk32",
)

_ge33 = 0.435866521508458999416019
ESDIRK33 = _bt(          # 4-stage ESDIRK order 3 (Kennedy–Carpenter style)
    [
        [0, 0, 0, 0],
        [_ge33, _ge33, 0, 0],
        [0.257648246066427, -0.093514767574886, _ge33, 0],
        [0.187641024346724, -0.595297473576955, 0.971789927721772, _ge33],
    ],
    [0.187641024346724, -0.595297473576955, 0.971789927721772, _ge33],
    [0.0, 2 * _ge33, 0.6, 1.0],   # c_i = row sums of a
    3,
    "esdirk33",
)


@dataclasses.dataclass(frozen=True, eq=False)
class RKSolver:
    """Generic (D)IRK stepper from a Butcher tableau (ODESolver::Step analog,
    linalg/ode.hpp:170).  Diagonal entries a_ii > 0 use ``implicit_solve``;
    zero-diagonal stages evaluate explicitly."""

    tableau: ButcherTableau

    def step(self, f, u, t, dt):
        tab = self.tableau
        s = tab.stages
        ks = []
        for i in range(s):
            y = u
            for j in range(i):
                if tab.a[i, j] != 0.0:
                    y = y + (dt * float(tab.a[i, j])) * ks[j]
            ti = t + float(tab.c[i]) * dt
            if tab.a[i, i] != 0.0:
                k = f.implicit_solve(float(tab.a[i, i]) * dt, ti, y)
            else:
                k = f.mult(ti, y)
            ks.append(k)
        for i in range(s):
            if tab.b[i] != 0.0:
                u = u + (dt * float(tab.b[i])) * ks[i]
        return u, t + dt


@dataclasses.dataclass(frozen=True, eq=False)
class IMEXEuler:
    """First-order IMEX split: explicit Euler on f_ex, implicit Euler on f_im
    (IMEXExpImplEuler, linalg/ode.cpp)."""

    def step(self, f, u, t, dt):
        y = u + dt * f.mult_explicit(t, u)
        k = f.implicit_solve(dt, t + dt, y)
        return y + dt * k, t + dt


@dataclasses.dataclass(frozen=True, eq=False)
class IMEXRK2:
    """Second-order IMEX-SSP2(2,2,2) (Pareschi–Russo): implicit part
    L-stable SDIRK, explicit part SSP-RK2."""

    def step(self, f, u, t, dt):
        g = 1.0 - 1.0 / math.sqrt(2.0)
        # stage 1: y1 = u + g dt K1,  K1 = f_im(y1)
        k1 = f.implicit_solve(g * dt, t + g * dt, u)
        y1 = u + g * dt * k1
        e1 = f.mult_explicit(t, y1)
        # stage 2
        z = u + dt * e1 + (1.0 - 2.0 * g) * dt * k1
        k2 = f.implicit_solve(g * dt, t + (1.0 - g) * dt, z)
        y2 = z + g * dt * k2
        e2 = f.mult_explicit(t + dt, y2)
        return u + 0.5 * dt * (e1 + e2 + k1 + k2), t + dt


@dataclasses.dataclass(eq=False)
class AdamsBashforthSolver:
    """Explicit linear multistep AB1-AB5 (linalg/ode.cpp AB solvers).

    Carries its own history; bootstrap steps use RK4.  State is (u, t) like
    the RK steppers — history lives on the solver instance, so one instance
    per trajectory.
    """

    order: int = 4

    _COEFS = {
        1: [1.0],
        2: [1.5, -0.5],
        3: [23 / 12, -16 / 12, 5 / 12],
        4: [55 / 24, -59 / 24, 37 / 24, -9 / 24],
        5: [1901 / 720, -2774 / 720, 2616 / 720, -1274 / 720, 251 / 720],
    }

    def __post_init__(self):
        self._hist = []

    def step(self, f, u, t, dt):
        k = f.mult(t, u)
        self._hist.insert(0, k)
        if len(self._hist) < self.order:
            return RKSolver(RK4).step(f, u, t, dt)    # bootstrap
        self._hist = self._hist[: self.order]
        c = self._COEFS[self.order]
        for i, ci in enumerate(c):
            u = u + dt * ci * self._hist[i]
        return u, t + dt


@dataclasses.dataclass(eq=False)
class AdamsMoultonSolver:
    """Implicit Adams-Moulton AM1-AM4 in predictor-corrector (PECE) form
    with an AB predictor (linalg/ode.cpp AM solvers' role)."""

    order: int = 3

    _COEFS = {
        1: [0.5, 0.5],                                   # trapezoid
        2: [5 / 12, 8 / 12, -1 / 12],
        3: [9 / 24, 19 / 24, -5 / 24, 1 / 24],
        4: [251 / 720, 646 / 720, -264 / 720, 106 / 720, -19 / 720],
    }

    def __post_init__(self):
        self._hist = []

    def step(self, f, u, t, dt):
        k = f.mult(t, u)
        self._hist.insert(0, k)
        if len(self._hist) < self.order + 1:
            return RKSolver(RK4).step(f, u, t, dt)
        self._hist = self._hist[: self.order + 1]
        # predict with AB of same history, evaluate, correct
        ab = AdamsBashforthSolver._COEFS[min(self.order + 1, 5)]
        up = u
        for i, ci in enumerate(ab[: len(self._hist)]):
            up = up + dt * ci * self._hist[i]
        kp = f.mult(t + dt, up)
        c = self._COEFS[self.order]
        un = u + dt * c[0] * kp
        for i, ci in enumerate(c[1:]):
            un = un + dt * ci * self._hist[i]
        return un, t + dt


_REGISTRY = {
    "forward_euler": FORWARD_EULER,
    "rk2": RK2,
    "rk3_ssp": RK3_SSP,
    "rk4": RK4,
    "backward_euler": BACKWARD_EULER,
    "implicit_midpoint": IMPLICIT_MIDPOINT,
    "sdirk23": SDIRK23,
    "sdirk33": SDIRK33,
    "sdirk34": SDIRK34,
    "trapezoidal": TRAPEZOIDAL,
    "esdirk32": ESDIRK32,
    "esdirk33": ESDIRK33,
}

#: numeric ids mirroring ODESolver::Select (linalg/ode.cpp:41): <20 explicit,
#: ≥20 implicit (ex16 -s 23 → SDIRK33 etc.)
_IDS = {
    1: "forward_euler",
    2: "rk2",
    3: "rk3_ssp",
    4: "rk4",
    21: "backward_euler",
    22: "sdirk23",
    23: "sdirk33",
    24: "implicit_midpoint",
    25: "trapezoidal",
    32: "esdirk32",
    33: "esdirk33",
    34: "sdirk34",
}


def select(which) -> RKSolver:
    """ODESolver::Select analog: by name or MFEM-convention numeric id."""
    if isinstance(which, int):
        which = _IDS[which]
    if which == "imex_euler":
        return IMEXEuler()
    if which == "imex_rk2":
        return IMEXRK2()
    if which.startswith("ab"):
        return AdamsBashforthSolver(order=int(which[2:]))
    if which.startswith("am"):
        return AdamsMoultonSolver(order=int(which[2:]))
    return RKSolver(_REGISTRY[which])


@dataclasses.dataclass(frozen=True, eq=False)
class FunctionOperator:
    """Adapter: wrap plain f(t, u) (and optional implicit solver) as a
    TimeDependentOperator."""

    f: Callable
    solve_implicit: Optional[Callable] = None   # (gamma, t, u) -> k

    def mult(self, t, u):
        return self.f(t, u)

    def implicit_solve(self, gamma, t, u):
        if self.solve_implicit is not None:
            return self.solve_implicit(gamma, t, u)
        # fixed-point fallback for scalar tests
        k = self.f(t, u)
        for _ in range(50):
            k = self.f(t, u + gamma * k)
        return k
