"""MINRES, BiCGStab, flexible GMRES and the constant-nullspace wrapper
(counterpart of ``cardiac_ablation_ecm2_tpu/linalg/krylov_extra.py``;
MFEM's ``MINRESSolver``, ``BiCGSTABSolver``, ``FGMRESSolver`` and
``OrthoSolver``).

Same callable conventions as ``solvers.cg``.  The JAX ``lax.while_loop``
bodies become Python loops that read the convergence flag on the host once
per iteration; the iterates are the JAX package's.  Each returns
(x, SolveInfo).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .solvers import SolveInfo, default_dot


def _floor(v, tiny=1e-300):
    return torch.clamp_min(v, tiny)


def _nz(v):
    """``v`` with exact zeros replaced by 1e-300 (JAX's ``jnp.where(v == 0,
    1e-300, v)``)."""
    return torch.where(v == 0, torch.full_like(v, 1e-300), v)


def minres(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable] = None,
    rel_tol: float = 1e-8,
    abs_tol: float = 0.0,
    max_iter: int = 500,
    dot: Callable = default_dot,
):
    """Preconditioned MINRES (Paige–Saunders: Lanczos and Givens) for
    symmetric, possibly indefinite systems; stops when the rotated residual
    |η| ≤ max(rel_tol·sqrt((r0, z0)), abs_tol)."""
    x = torch.zeros_like(b) if x0 is None else x0
    prec = M if M is not None else (lambda v: v)

    r = b - A(x)
    z = prec(r)
    beta = torch.sqrt(dot(r, z))
    target = torch.clamp_min(rel_tol * beta, abs_tol)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    v_old, v = torch.zeros_like(b), r / _floor(beta)
    z = z / _floor(beta)
    w, w_old = torch.zeros_like(b), torch.zeros_like(b)
    eta, s_old, s, c_old, c = beta, zero, zero, one, one
    res, k = beta, 0
    done = bool(beta <= target)
    while k < max_iter and not done:
        Az = A(z)
        alpha = dot(Az, z)
        r_new = Az - alpha * v - beta * v_old
        z_new = prec(r_new)
        beta_new = torch.sqrt(torch.abs(dot(r_new, z_new)))
        rho1 = c * alpha - c_old * s * beta
        rho2 = s * alpha + c_old * c * beta
        rho3 = s_old * beta
        delta = torch.sqrt(rho1 ** 2 + beta_new ** 2)
        c_new = rho1 / _floor(delta)
        s_new = beta_new / _floor(delta)
        w_new = (z - rho2 * w - rho3 * w_old) / _floor(delta)
        x = x + c_new * eta * w_new
        eta = -s_new * eta
        res = torch.abs(eta)
        v_old, v = v, r_new / _floor(beta_new)
        z = z_new / _floor(beta_new)
        w_old, w = w, w_new
        s_old, s, c_old, c = s, s_new, c, c_new
        beta = beta_new
        k += 1
        done = bool(res <= target)
    return x, SolveInfo(iterations=k, final_norm=float(res), converged=done)


def bicgstab(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable] = None,
    rel_tol: float = 1e-8,
    abs_tol: float = 0.0,
    max_iter: int = 500,
    dot: Callable = default_dot,
):
    """Preconditioned BiCGStab for nonsymmetric systems; stops when
    ‖r‖ ≤ max(rel_tol·‖r0‖, abs_tol)."""
    x = torch.zeros_like(b) if x0 is None else x0
    prec = M if M is not None else (lambda v: v)

    r = b - A(x)
    res = torch.sqrt(dot(r, r))
    target = torch.clamp_min(rel_tol * res, abs_tol)
    rtilde = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho_old, alpha, omega = one, one, one
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    k = 0
    done = bool(res <= target)
    while k < max_iter and not done:
        rho = dot(rtilde, r)
        beta = (rho / _nz(rho_old)) * (alpha / _nz(omega))
        p = r + beta * (p - omega * v)
        ph = prec(p)
        v = A(ph)
        alpha = rho / _nz(dot(rtilde, v))
        s = r - alpha * v
        sh = prec(s)
        t = A(sh)
        tt = dot(t, t)
        omega = dot(t, s) / _nz(tt)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        res = torch.sqrt(dot(r, r))
        rho_old = rho
        k += 1
        done = bool(res <= target)
    return x, SolveInfo(iterations=k, final_norm=float(res), converged=done)


def fgmres(
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
    """Flexible GMRES: right preconditioning by a preconditioner that may
    change between applications, with the preconditioned basis Z kept
    beside the Krylov basis V.  As in the JAX package, a cycle stops its
    Arnoldi steps once the rotated residual reaches the target,
    ``iterations`` advances by ``restart`` a cycle, and cycles run while
    fewer than ``max_iter`` iterations were counted and the residual is
    above the target.  The Hessenberg column, the rotations and the
    triangular solve stay on the vectors' device in their dtype."""
    x = torch.zeros_like(b) if x0 is None else x0
    prec = M if M is not None else (lambda v: v)
    m = restart

    def cycle(x):
        r = b - A(x)
        beta = torch.sqrt(dot(r, r))
        V = [r / _floor(beta)]
        Z = []
        H = b.new_zeros((m + 1, m))
        cs = b.new_zeros(m)
        sn = b.new_zeros(m)
        g = b.new_zeros(m + 1)
        g[0] = beta
        res = beta
        done = bool(beta <= target)
        for j in range(m):
            if done:
                break
            z = prec(V[j])
            Z.append(z)
            w = A(z)
            for i in range(j + 1):          # modified Gram–Schmidt
                hij = dot(w, V[i])
                w = w - hij * V[i]
                H[i, j] = hij
            hj1 = torch.sqrt(dot(w, w))
            H[j + 1, j] = hj1
            V.append(w / _floor(hj1))
            for i in range(j):              # earlier rotations
                t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = t
            denom = torch.sqrt(H[j, j] ** 2 + H[j + 1, j] ** 2)
            c = H[j, j] / _floor(denom)
            s = H[j + 1, j] / _floor(denom)
            H[j, j] = denom
            H[j + 1, j] = 0.0
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            cs[j], sn[j] = c, s
            res = torch.abs(g[j + 1])
            done = bool(res <= target)
        # back-substitution on the m×m triangle (JAX's masked form: a zero
        # pivot divides by 1, untouched rows give 0)
        y = b.new_zeros(m)
        for i in range(m - 1, -1, -1):
            num = g[i] - torch.dot(H[i, :m], y)
            piv = H[i, i]
            y[i] = num / torch.where(piv == 0, torch.ones_like(piv), piv)
        for j, z in enumerate(Z):
            x = x + y[j] * z
        return x, res

    r0 = b - A(x)
    beta0 = torch.sqrt(dot(r0, r0))
    target = torch.clamp_min(rel_tol * beta0, abs_tol)
    res, it = beta0, 0
    while it < max_iter and bool(res > target):
        x, res = cycle(x)
        it += m
    return x, SolveInfo(iterations=it, final_norm=float(res),
                        converged=bool(res <= target))


def ortho_wrap(op: Callable, dot: Callable = default_dot) -> Callable:
    """Wrap an operator (or preconditioner) so that its input and output
    are projected orthogonal to the constants (OrthoSolver), for
    pure-Neumann, singular problems."""

    def proj(v):
        return v - torch.sum(v) / v.shape[0]

    def wrapped(v):
        return proj(op(proj(v)))

    return wrapped
