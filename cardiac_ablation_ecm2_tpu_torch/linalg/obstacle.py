"""The obstacle problem by the primal–dual active set method, a
semismooth Newton iteration (counterpart of
``cardiac_ablation_ecm2_tpu/linalg/obstacle.py``; MFEM's ex36 problem):

    min ½ uᵀA u − bᵀu   s.t.  u ≥ ψ
    ⇔  A u − b − λ = 0,   λ ≥ 0,  u ≥ ψ,  λᵀ(u − ψ) = 0.

Each outer iteration freezes the active set {λ + c(ψ − u) > 0} and solves
one masked SPD system by Jacobi-PCG on the vectors' device; it stops when
the active set repeats (one host read of the set a step).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .solvers import cg


def obstacle_solve(
    Amult: Callable,
    b: torch.Tensor,
    psi: torch.Tensor,
    diag: Optional[torch.Tensor] = None,
    fixed_mask: Optional[torch.Tensor] = None,
    fixed_vals: Optional[torch.Tensor] = None,
    c: float = 1e6,
    max_outer: int = 40,
    rel_tol: float = 1e-11,
    max_iter: int = 3000,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (u, λ, outer_iterations); ``fixed_mask`` is 1 on Dirichlet
    dofs, held at ``fixed_vals``.  ``cg_iterations`` on the function
    records the inner CG counts of the last call."""
    n = b.shape[0]
    fm = torch.zeros_like(b) if fixed_mask is None else fixed_mask
    fv = torch.zeros_like(b) if fixed_vals is None else fixed_vals
    u = torch.maximum(fv * fm, psi)
    lam = torch.zeros_like(b)
    active_prev = None
    d = diag if diag is not None else torch.ones(n, dtype=b.dtype, device=b.device)
    obstacle_solve.cg_iterations = []
    for it in range(max_outer):
        active = (lam + c * (psi - u) > 0) & (fm == 0)
        afloat = active.to(b.dtype)
        con = torch.maximum(afloat, fm)          # all constrained dofs
        vals = psi * afloat + fv * fm
        free = 1.0 - con

        def A_c(v):
            z = v * free
            return Amult(z) * free + (v - z)

        rhs = (b - Amult(vals * con)) * free + vals * con
        dg = d * free + (1.0 - free)
        u, info = cg(A_c, rhs, M=lambda r: r / dg, rel_tol=rel_tol,
                     max_iter=max_iter)
        obstacle_solve.cg_iterations.append(info.iterations)
        lam = (Amult(u) - b) * afloat
        if active_prev is not None and torch.equal(active, active_prev):
            return u, lam, it + 1
        active_prev = active
    return u, lam, max_outer


obstacle_solve.cg_iterations = []
