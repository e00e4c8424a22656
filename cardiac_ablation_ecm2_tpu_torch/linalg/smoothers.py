"""Simple preconditioners and smoothers (``jacobi`` and ``chebyshev`` of
``cardiac_ablation_ecm2_tpu/linalg/smoothers.py``; OperatorJacobiSmoother and
OperatorChebyshevSmoother on the assembled partial-assembly diagonal)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .solvers import default_dot, power_method


def jacobi(diag: torch.Tensor, damping: float = 1.0) -> Callable:
    """M(r) = damping · r / diag."""
    inv = damping / diag

    def prec(r):
        return inv * r

    return prec


def chebyshev(
    A: Callable,
    diag: torch.Tensor,
    order: int = 4,
    eig_max=None,
    eig_ratio: float = 30.0,
    power_iters: int = 20,
    dot: Callable = default_dot,
    v0: Optional[torch.Tensor] = None,
) -> Callable:
    """Chebyshev-accelerated Jacobi smoother of polynomial order ``order``
    on the interval [eig_max/eig_ratio, 1.1·eig_max] of D⁻¹A.  Without
    ``eig_max`` it is estimated by ``power_iters`` steps of the power
    method on D⁻¹A, from ``v0`` or from the seeded start that
    ``power_method`` draws (on ``diag``'s device).

    The polynomial is negative above eig_max·(1.1 + 1/eig_ratio): if the
    spectrum reaches past that (a power estimate that falls short), the
    returned preconditioner is indefinite and a CG it preconditions can
    stop on a negative (r, z), as the JAX package's can."""
    dinv = 1.0 / diag

    def DinvA(v):
        return dinv * A(v)

    if eig_max is None:
        eig_max = power_method(DinvA, diag.shape[0], iters=power_iters,
                               dtype=diag.dtype, dot=dot, v0=v0,
                               device=diag.device)
    upper = 1.1 * eig_max
    lower = eig_max / eig_ratio
    theta = 0.5 * (upper + lower)
    delta = 0.5 * (upper - lower)
    sigma1 = theta / delta
    # the recurrence's scalars (Saad 12.1) do not depend on r: formed once
    c0 = 1.0 / theta
    coefs = []
    rho = 1.0 / sigma1
    for _ in range(order - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        coefs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new

    def prec(r):
        # preconditioned Chebyshev iteration for A x = r, x0 = 0; the last
        # pass's residual feeds no later update, so it is not formed (XLA
        # drops it from the JAX package's traced loop too)
        x = torch.zeros_like(r)
        d = c0 * (dinv * r)
        for a, b in coefs:
            x = x + d
            d = a * d + b * (dinv * (r - A(x)))
        return x + d

    return prec
