"""The spectral fractional Laplacian (−Δ)^s by sinc quadrature (counterpart
of ``cardiac_ablation_ecm2_tpu/linalg/fractional.py``; MFEM's ex33 problem):
the Bonito–Pasciak quadrature of the Balakrishnan integral,

    A^{-s} ≈ (k sin πs / π) Σ_l e^{(1−s) y_l} (e^{y_l} I + A)⁻¹,

which for the FEM pencil (A, M) is a sum of shifted SPD solves
(t_l M + A)⁻¹ M, each a Jacobi-PCG.  The JAX package scans the shifts
with ``lax.scan``; here they are a Python loop, one CG each.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .solvers import cg


def sinc_weights(s: float, lam_min: float, lam_max: float,
                 k: float = 0.35) -> Tuple[np.ndarray, np.ndarray]:
    """(shifts t_l, weights w_l) so that A_M^{-s} ≈ Σ w_l (t_l M + A)⁻¹ M;
    the y-grid covers the spectrum with margins where both exponential
    tails fall below ~e⁻¹⁴."""
    y_lo = np.log(lam_min) - 14.0 / (1.0 - s)
    y_hi = np.log(lam_max) + 14.0 / s
    y = np.arange(y_lo, y_hi + k, k)
    t = np.exp(y)
    w = (k * np.sin(np.pi * s) / np.pi) * np.exp((1.0 - s) * y)
    return t, w


def fractional_apply(
    Amult: Callable,
    Mmult: Callable,
    diagA: torch.Tensor,
    diagM: torch.Tensor,
    s: float,
    v: torch.Tensor,
    lam_min: float,
    lam_max: float,
    k: float = 0.35,
    rel_tol: float = 1e-11,
    max_iter: int = 3000,
) -> torch.Tensor:
    """u = A_M^{-s} v with A_M = M⁻¹A (both SPD, matrix-free).  The shift
    solves' CG counts are kept in ``fractional_apply.cg_iterations``."""
    t_np, w_np = sinc_weights(s, lam_min, lam_max, k)
    ts = torch.as_tensor(t_np, dtype=v.dtype, device=v.device)
    ws = torch.as_tensor(w_np, dtype=v.dtype, device=v.device)
    Mv = Mmult(v)
    u = torch.zeros_like(Mv)
    fractional_apply.cg_iterations = []
    for t, w in zip(ts, ws):
        d = t * diagM + diagA
        x, info = cg(lambda z: t * Mmult(z) + Amult(z), Mv, M=lambda r: r / d,
                     rel_tol=rel_tol, max_iter=max_iter)
        fractional_apply.cg_iterations.append(info.iterations)
        u = u + w * x
    return u


fractional_apply.cg_iterations = []


def fractional_solve(Amult, Mmult, diagA, diagM, s, b,
                     lam_min, lam_max, k=0.35, rel_tol=1e-11,
                     max_iter=3000) -> torch.Tensor:
    """Solve (−Δ)^s u = f from the load vector b = (f, φ):
    u = A_M^{-s} (M⁻¹ b), with one extra mass solve."""
    v, _ = cg(Mmult, b, M=lambda r: r / diagM, rel_tol=rel_tol,
              max_iter=max_iter)
    return fractional_apply(Amult, Mmult, diagA, diagM, s, v,
                            lam_min, lam_max, k, rel_tol, max_iter)
