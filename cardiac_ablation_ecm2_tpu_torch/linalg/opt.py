"""Small constrained-optimisation solvers, SLBQP and NNLS (counterpart of
``cardiac_ablation_ecm2_tpu/linalg/opt.py``; MFEM's ``SLBQPOptimizer`` and
``NNLS``).

SLBQP's evaluation (a clip and two reductions) runs on the vectors'
device; its scalar bracketing and bisection is a Python loop that reads
the residual's sign on the host once per step, where the JAX package runs
``lax.while_loop``.  NNLS is a host numpy active-set method on small dense
problems, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def slbqp(
    w: torch.Tensor,
    lo,
    hi,
    a: float,
    weights: torch.Tensor = None,
    tol: float = 1e-12,
    max_iter: int = 200,
) -> Tuple[torch.Tensor, int]:
    """minimize ½‖x − w‖² s.t. lo ≤ x ≤ hi and Σ cᵢ xᵢ = a.

    x(λ) = clip(w + λc, lo, hi) with the multiplier λ where the monotone
    r(λ) = Σ c·x(λ) − a changes sign: the bracket ±max(max(hi − lo), 1)
    doubles (at most 60 times) until it holds the root, then bisection
    until |r(mid)| ≤ tol or ``max_iter`` steps.  Returns (x, iterations)."""
    c = torch.ones_like(w) if weights is None else torch.as_tensor(
        weights, dtype=w.dtype, device=w.device)
    lo = torch.as_tensor(lo, dtype=w.dtype, device=w.device).expand(w.shape)
    hi = torch.as_tensor(hi, dtype=w.dtype, device=w.device).expand(w.shape)

    def r(lam):
        return torch.sum(c * torch.clamp(w + lam * c, lo, hi)) - a

    scale = torch.clamp_min(torch.max(hi - lo), 1.0)
    l, u, k = -scale, scale, 0
    while k < 60 and bool((r(l) > 0) | (r(u) < 0)):
        l, u, k = l * 2, u * 2, k + 1
    iters = 0
    while iters < max_iter and bool(torch.abs(r(0.5 * (l + u))) > tol):
        m = 0.5 * (l + u)
        rm = r(m)
        l = torch.where(rm < 0, m, l)
        u = torch.where(rm >= 0, m, u)
        iters += 1
    lam = 0.5 * (l + u)
    return torch.clamp(w + lam * c, lo, hi), iters


def nnls(A: np.ndarray, b: np.ndarray, tol: float = None,
         max_iter: int = None) -> np.ndarray:
    """Lawson–Hanson active-set NNLS: min ‖Ax − b‖₂ s.t. x ≥ 0 (host
    numpy; the problems are small dense systems)."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    m, n = A.shape
    if tol is None:
        tol = 10 * np.finfo(np.float64).eps * np.linalg.norm(A, 1) * max(m, n)
    if max_iter is None:
        max_iter = 3 * n
    P = np.zeros(n, dtype=bool)
    x = np.zeros(n)
    w = A.T @ (b - A @ x)
    it = 0
    while (~P).any() and np.max(np.where(P, -np.inf, w)) > tol \
            and it < max_iter:
        P[int(np.argmax(np.where(P, -np.inf, w)))] = True
        while True:
            it += 1
            idx = np.nonzero(P)[0]
            s = np.zeros(n)
            s[idx], *_ = np.linalg.lstsq(A[:, idx], b, rcond=None)
            if np.all(s[idx] > 0):
                x = s
                break
            neg = idx[s[idx] <= 0]
            alpha = np.min(x[neg] / (x[neg] - s[neg]))
            x = x + alpha * (s - x)
            P &= x > tol
            x[~P] = 0.0
            if it >= max_iter:
                break
        w = A.T @ (b - A @ x)
    return x
