"""Matrix-free Krylov solvers (counterpart of ``cg``, ``cg_merged``,
``gmres``, ``power_method``, ``SolveInfo`` and ``default_dot`` in
``cardiac_ablation_ecm2_tpu/linalg/solvers.py``).

Operators and preconditioners are callables ``x -> Ax``.  CG's stopping
rule is MFEM's ``CGSolver::Mult``: stop when (r, z) ≤ max(rel_tol²·(r0, z0),
abs_tol²).  PyTorch runs eagerly, so the loops read the convergence flag on
the host once per iteration (none with ``check_convergence=False``); the
iterates equal those of the JAX ``lax.while_loop``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.config import config, real_t, resolve_device


def default_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Inner product, accumulated in float64 for float32 arrays when
    ``config.f64_reductions`` is set (the card has native f64, so the
    compensated f32 sums the TPU needed are not used)."""
    if config.f64_reductions and x.dtype != torch.float64:
        return torch.dot(x.double(), y.double()).to(x.dtype)
    return torch.dot(x, y)


class SolveInfo(NamedTuple):
    iterations: int
    final_norm: float     # sqrt of the final (r, z)
    converged: bool


def cg(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable] = None,
    rel_tol: float = 1e-8,
    abs_tol: float = 0.0,
    max_iter: int = 500,
    dot: Callable = default_dot,
    check_convergence: bool = True,
):
    """Preconditioned CG (CGSolver::Mult).  Returns (x, SolveInfo).
    ``check_convergence=False`` runs exactly ``max_iter`` iterations with
    no host read inside the loop: the fixed-work benchmarking mode."""
    x = torch.zeros_like(b) if x0 is None else x0
    prec = M if M is not None else (lambda v: v)

    r = b - A(x)
    d = prec(r)
    nom = dot(d, r)
    target = torch.clamp_min(rel_tol * rel_tol * nom, abs_tol * abs_tol)
    k = 0
    done = bool(nom <= target)
    while k < max_iter and not done:
        Ad = A(d)
        alpha = nom / dot(d, Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        z = prec(r)
        betanom = dot(r, z)
        done = check_convergence and bool(betanom <= target)
        d = z + (betanom / nom) * d
        nom = betanom
        k += 1
    info = SolveInfo(iterations=k, final_norm=float(nom.abs().sqrt()),
                     converged=bool(nom <= target))
    return x, info


def cg_merged(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable] = None,
    rel_tol: float = 1e-8,
    abs_tol: float = 0.0,
    max_iter: int = 500,
    dot: Callable = default_dot,
    check_convergence: bool = True,
):
    """Single-reduction (Chronopoulos–Gear) preconditioned CG: the iterates
    of ``cg`` in exact arithmetic, with both inner products, (r, u) and
    (w, u), taken together after the apply and every vector update on
    lagged scalars.  Same stopping rule as ``cg``; one host read an
    iteration for it, none with ``check_convergence=False``, which runs
    exactly ``max_iter`` iterations.  Returns (x, SolveInfo)."""
    x = torch.zeros_like(b) if x0 is None else x0
    prec = M if M is not None else (lambda v: v)

    def safe(v):
        return torch.where(v == 0, torch.ones_like(v), v)

    r = b - A(x)
    u = prec(r)
    w = A(u)
    gamma = dot(r, u)
    delta = dot(w, u)
    target = torch.clamp_min(rel_tol * rel_tol * gamma, abs_tol * abs_tol)
    alpha = gamma / safe(delta)
    beta = torch.zeros((), dtype=b.dtype, device=b.device)
    p = s = torch.zeros_like(b)
    k = 0
    done = bool(gamma <= target)
    while k < max_iter and not done:
        p = u + beta * p
        s = w + beta * s
        x = x + alpha * p
        r = r - alpha * s
        u = prec(r)
        w = A(u)
        gamma_new = dot(r, u)
        delta = dot(w, u)
        beta = gamma_new / safe(gamma)
        alpha = gamma_new / safe(delta - beta * gamma_new / safe(alpha))
        gamma = gamma_new
        k += 1
        done = check_convergence and bool(gamma <= target)
    info = SolveInfo(iterations=k, final_norm=float(gamma.abs().sqrt()),
                     converged=bool(gamma <= target))
    return x, info


def gmres(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable] = None,
    rel_tol: float = 1e-8,
    abs_tol: float = 0.0,
    max_iter: int = 200,
    restart: int = 50,
    dot: Callable = default_dot,
):
    """Restarted left-preconditioned GMRES (GMRESSolver) with modified
    Gram–Schmidt and Givens rotations, for nonsymmetric operators.

    The JAX package's iteration: the residual target is
    max(rel_tol·‖M(b − A x0)‖, abs_tol); a cycle of at most ``restart``
    Arnoldi steps stops when the rotated residual |g_{j+1}| reaches it; at
    most ⌈max_iter / restart⌉ cycles; ``iterations`` counts the Arnoldi
    steps taken.  The Krylov basis and the orthogonalisation stay on the
    vectors' device; each Arnoldi step reads its Hessenberg column (j + 2
    numbers) on the host once, where the rotations and the triangular
    solve run in the vectors' dtype (numpy scalars of that type).
    Returns (x, SolveInfo)."""
    x = torch.zeros_like(b) if x0 is None else x0
    prec = M if M is not None else (lambda v: v)
    m = restart
    npt = np.float64 if b.dtype == torch.float64 else np.float32

    def residual(x):
        r = prec(b - A(x))
        return r, npt(float(torch.sqrt(dot(r, r))))

    r, beta0 = residual(x)
    target = max(npt(rel_tol) * beta0, npt(abs_tol))
    res, its, cycles = beta0, 0, 0
    done = bool(beta0 <= target)
    tiny = npt(1e-300)
    while cycles < (max_iter + m - 1) // m and not done:
        if cycles > 0:
            r, res = residual(x)
        beta = res
        V = [r / torch.clamp_min(torch.sqrt(dot(r, r)), 1e-300)]
        H = np.zeros((m + 1, m), npt)
        cs = np.zeros(m, npt)
        sn = np.zeros(m, npt)
        g = np.zeros(m + 1, npt)
        g[0] = beta
        k = 0
        cdone = bool(beta <= target)
        while k < m and not cdone:
            j = k
            w = prec(A(V[j]))
            h = []
            for i in range(j + 1):          # modified Gram–Schmidt
                hij = dot(w, V[i])
                w = w - hij * V[i]
                h.append(hij)
            hj1 = torch.sqrt(dot(w, w))
            V.append(w / torch.clamp_min(hj1, 1e-300))
            col = torch.stack(h + [hj1]).cpu().numpy()   # the one host read
            H[:j + 2, j] = col
            for i in range(j):              # earlier rotations
                t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = t
            denom = np.sqrt(H[j, j] ** 2 + H[j + 1, j] ** 2)
            c = H[j, j] / max(denom, tiny)
            s = H[j + 1, j] / max(denom, tiny)
            cs[j], sn[j] = c, s
            H[j, j], H[j + 1, j] = denom, 0
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            res = abs(g[j + 1])
            k += 1
            cdone = bool(res <= target)
        y = np.zeros(m, npt)
        for j in range(k - 1, -1, -1):      # back-substitution
            num = g[j] - H[j] @ y
            y[j] = num / H[j, j] if H[j, j] != 0 else 0
        if k:
            yt = torch.as_tensor(y[:k], device=b.device)
            x = x + torch.stack(V[:k], dim=1) @ yt
        its += k
        cycles += 1
        done = bool(res <= target)
    return x, SolveInfo(iterations=its, final_norm=float(res), converged=done)


def power_method(
    A: Callable, n: int = None, iters: int = 30, seed: int = 7, dtype=None,
    dot: Callable = default_dot, v0: Optional[torch.Tensor] = None,
    device=None,
):
    """Largest-eigenvalue estimate by power iteration (the start of the
    Chebyshev bounds; OperatorChebyshevSmoother's PowerMethod).  Returns a
    0-d tensor on the vectors' device, read by no host sync.

    Pass ``v0`` for a deterministic start.  Without it the start is
    uniform on [0, 1), drawn on the CPU from a ``torch.Generator`` seeded
    with ``seed`` in ``dtype`` and then moved to ``device`` (``None``: the
    card), so the CPU and the card start from the same vector.  (The JAX
    package draws ``jax.random.uniform(PRNGKey(seed))``, which this cannot
    reproduce: pass that vector as ``v0`` to start where JAX starts.)"""
    if v0 is not None:
        v = v0
    else:
        gen = torch.Generator().manual_seed(seed)
        v = torch.rand(n, generator=gen, dtype=real_t(dtype or torch.float32))
        v = v.to(resolve_device(device))
    for _ in range(iters):
        w = A(v)
        lam = torch.sqrt(dot(w, w))
        v = w / torch.clamp_min(lam, 1e-300)
    w = A(v)
    return dot(v, w) / dot(v, v)
