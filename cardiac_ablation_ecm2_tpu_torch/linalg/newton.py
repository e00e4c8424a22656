"""Newton's method with exact matrix-free Jacobians, and L-BFGS
(counterpart of ``cardiac_ablation_ecm2_tpu/linalg/newton.py``; MFEM's
``NewtonSolver`` and ``LBFGSSolver``).

The Jacobian action is by default ``torch.func.jvp`` of the residual at
the current iterate, one per Krylov apply: it re-runs the residual's
primal each time, where JAX's ``jax.linearize`` runs it once a Newton
step.  ``torch.func.linearize`` would run it once too, but it traces the
residual with ``make_fx``, which cannot follow a ctypes kernel launch (the
restriction's kernels read ``data_ptr()``), so it is not used.  A caller
whose residual is a gradient can pass ``tangent``, built once a Newton
step (``models/hyperelastic.py``: one backward pass an apply through the
gradient's retained graph).

Inner solves are CG (SPD Jacobians) or GMRES at a fixed relative
tolerance; globalisation is JAX's backtracking on ‖F‖, kept on the device
(``torch.where`` selections, no host read).  The loops read their stopping
test on the host once per iteration, where the JAX ``lax.while_loop``
tests its condition.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .solvers import cg, default_dot, gmres


class NewtonInfo(NamedTuple):
    iterations: int
    final_norm: float
    converged: bool
    #: the inner Krylov solve's iterations in each Newton step (empty for
    #: L-BFGS)
    linear_iterations: Tuple[int, ...] = ()


def jacobian_action(residual: Callable, u: torch.Tensor) -> Callable:
    """v ↦ J(u) v, the exact directional derivative of ``residual`` at
    ``u`` (forward mode through the residual, kernels included)."""

    def apply(v):
        return torch.func.jvp(residual, (u,), (v,))[1]

    return apply


def gradient_tangent(energy: Callable, u: torch.Tensor, mask: torch.Tensor) -> Callable:
    """v ↦ J(u) v for the residual mask·∇E(u) + (1 − mask)·(u − g) of a
    Newton solve on an energy: the gradient's graph is built once here
    (``create_graph``) and kept, and each apply is one backward pass
    through it (the Hessian is symmetric), the masked rows the identity.
    The counterpart of ``jax.linearize`` of that residual."""
    x = u.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(energy(x), x, create_graph=True)

    def apply(v):
        (hv,) = torch.autograd.grad(g, x, v, retain_graph=True)
        return hv * mask + v * (1 - mask)

    return apply


def newton(
    residual: Callable,
    u0: torch.Tensor,
    rel_tol: float = 1e-10,
    abs_tol: float = 0.0,
    max_iter: int = 20,
    linear_solver: str = "cg",
    linear_rel_tol: float = 1e-8,
    linear_max_iter: int = 500,
    precond: Optional[Callable] = None,   # (u) -> M callable, rebuilt per step
    line_search: int = 0,                  # max halvings (0 = full steps)
    dot: Callable = default_dot,
    tangent: Optional[Callable] = None,    # (u) -> (v -> J(u) v), per step
):
    """Solve residual(u) = 0; returns (u, NewtonInfo).  ``tangent``
    defaults to :func:`jacobian_action` of ``residual``.  With
    ``line_search`` = L, each step tries α = 1, 1/2, ..., 2^-L along the
    Newton direction and keeps the trial of least ‖F‖ that is strictly
    below the current one (the earliest on ties), else stays put."""

    def norm(v):
        return torch.sqrt(dot(v, v))

    F = residual(u0)
    nF = norm(F)
    target = torch.clamp_min(rel_tol * nF, abs_tol)
    u, k, lin = u0, 0, []
    done = bool(nF <= target)
    while k < max_iter and not done:
        J = tangent(u) if tangent is not None else jacobian_action(residual, u)
        M = precond(u) if precond is not None else None
        solve = cg if linear_solver == "cg" else gmres
        du, info = solve(J, -F, M=M, rel_tol=linear_rel_tol,
                         max_iter=linear_max_iter, dot=dot)
        lin.append(info.iterations)
        if line_search > 0:
            alpha, u_new, n_new = 1.0, u, nF
            for _ in range(line_search + 1):
                u_try = u + alpha * du
                n_try = norm(residual(u_try))
                better = n_try < n_new
                u_new = torch.where(better, u_try, u_new)
                n_new = torch.where(better, n_try, n_new)
                alpha *= 0.5
        else:
            u_new = u + du
            n_new = norm(residual(u_new))
        F = residual(u_new)
        u, nF = u_new, n_new
        k += 1
        done = bool(nF <= target)
    return u, NewtonInfo(iterations=k, final_norm=float(nF), converged=done,
                         linear_iterations=tuple(lin))


def lbfgs(
    grad: Callable,
    u0: torch.Tensor,
    rel_tol: float = 1e-8,
    abs_tol: float = 0.0,
    max_iter: int = 200,
    history: int = 10,
    line_search: int = 24,
    dot: Callable = default_dot,
    energy: Optional[Callable] = None,
):
    """L-BFGS for grad(u) = 0: a ring of ``history`` (s, y) pairs and the
    two-loop recursion, an empty slot marked by ρ = 0.  The line search
    starts at α = 4 and halves ``line_search`` times, taking the first
    trial that passes Armijo on ``energy`` (when given) or lowers ‖grad‖;
    without one it takes a steepest-descent step of length 1e-4/‖g‖.  A
    pair enters the ring only when yᵀs > 1e-30."""
    m = history
    n = u0.shape[0]

    def norm(v):
        return torch.sqrt(dot(v, v))

    g = grad(u0)
    ng = norm(g)
    target = torch.clamp_min(rel_tol * ng, abs_tol)
    S = u0.new_zeros((m, n))
    Y = u0.new_zeros((m, n))
    R = u0.new_zeros(m)                  # 1/(yᵀs); 0 marks an empty slot
    alphas = u0.new_zeros(m)
    head = 0
    gamma = torch.ones((), dtype=u0.dtype, device=u0.device)
    zero = torch.zeros((), dtype=u0.dtype, device=u0.device)

    def two_loop(g):
        q = g
        for i in range(m):               # newest → oldest
            j = (head - 1 - i) % m
            a = torch.where(R[j] != 0, R[j] * dot(S[j], q), zero)
            q = q - a * Y[j]
            alphas[j] = a
        r = gamma * q
        for i in range(m):
            j = (head + i) % m
            bj = torch.where(R[j] != 0, R[j] * dot(Y[j], r), zero)
            r = r + (alphas[j] - bj) * S[j]
        return r

    u, k = u0, 0
    done = bool(ng <= target)
    while k < max_iter and not done:
        d = -two_loop(g)
        if energy is not None:
            f_u = energy(u)
            slope = dot(g, d)
        alpha = torch.asarray(4.0, dtype=u.dtype, device=u.device)
        u1, g1, n1 = u, g, ng
        found = torch.zeros((), dtype=torch.bool, device=u.device)
        for _ in range(line_search):
            u_try = u + alpha * d
            g_try = grad(u_try)
            n_try = norm(g_try)
            if energy is not None:
                ok = energy(u_try) <= f_u + 1e-4 * alpha * slope
            else:
                ok = n_try < ng
            take = ~found & ok
            u1 = torch.where(take, u_try, u1)
            g1 = torch.where(take, g_try, g1)
            n1 = torch.where(take, n_try, n1)
            found = found | take
            alpha = alpha * 0.5
        tiny = 1e-4 / torch.clamp_min(ng, 1e-30)
        u_sd = u - tiny * g
        g_sd = grad(u_sd)
        u1 = torch.where(found, u1, u_sd)
        g1 = torch.where(found, g1, g_sd)
        n1 = torch.where(found, n1, norm(g1))
        s, y = u1 - u, g1 - g
        ys = dot(y, s)
        if bool(ys > 1e-30):
            S[head], Y[head], R[head] = s, y, 1.0 / ys
            head = (head + 1) % m
            gamma = ys / torch.clamp_min(dot(y, y), 1e-30)
        u, g, ng = u1, g1, n1
        k += 1
        done = bool(ng <= target)
    return u, NewtonInfo(iterations=k, final_norm=float(ng), converged=done)
