"""Mixed Darcy saddle point, MFEM's ex5 (counterpart of
``cardiac_ablation_ecm2_tpu/models/darcy.py``): the RT0 × L2-P0 block system

    [ M   Bᵀ ] [u]   [f]
    [ B   0  ] [p] = [g]

solved with MINRES and a block-diagonal preconditioner (Jacobi on M, the
element volumes on the p block).  M is ``ops/vecfe``'s RT mass, B / Bᵀ
``ops/block.mixed_divergence``; the L2 right-hand side and the volume
vector are sums on the L2 space's restriction (``segment_sum`` on the
card).
"""

from __future__ import annotations

import dataclasses

import torch

from ..fem.build import restriction_for
from ..fem.fe_vector import RTSpace
from ..fem.fespace import L2FESpace
from ..linalg.krylov_extra import minres
from ..ops.block import BlockOperator, block_diag_precond, mixed_divergence
from ..ops.vecfe import build_rt_operator, host_points, vecfe_linear_form
from ..utils.config import real_t, resolve_device


@dataclasses.dataclass
class DarcyResult:
    rt: RTSpace
    l2: L2FESpace
    u: torch.Tensor
    p: torch.Tensor
    iterations: int
    converged: bool


@dataclasses.dataclass(eq=False)
class DarcySystem:
    """The assembled block system: the RT mass M, the block operator, the
    right-hand side [f; g] and the block-diagonal preconditioner."""

    M: object
    op: BlockOperator
    rhs: torch.Tensor
    prec: object


def system(rt_space, l2, f_vec=None, g_fn=None, dtype=None, device=None) -> DarcySystem:
    """The block system of :func:`solve` on ``rt_space`` × ``l2``."""
    device = resolve_device(device)
    M = build_rt_operator(rt_space, mass_coeff=1.0, dtype=dtype, device=device)
    B, Bt = mixed_divergence(rt_space, l2, dtype=dtype, device=device)
    n0, n1 = rt_space.ndof, l2.ndof_scalar
    rtt = real_t(dtype)
    r_l2 = restriction_for(l2, device)
    f = (vecfe_linear_form(M, f_vec) if f_vec is not None
         else torch.zeros(n0, dtype=rtt, device=device))
    if g_fn is not None:
        # (g, q) for piecewise-constant q: ∫_K g
        gq = torch.as_tensor(g_fn(host_points(M.gf)), dtype=rtt, device=device)
        g = r_l2.mult_transpose((M.gf.wdet * gq).sum(dim=1, keepdim=True))
    else:
        g = torch.zeros(n1, dtype=rtt, device=device)
    dM = M.diagonal()
    # the p block: the element volumes (a Schur-complement surrogate)
    pvec = r_l2.mult_transpose(M.gf.wdet.sum(dim=1, keepdim=True))
    return DarcySystem(M=M, op=BlockOperator(n0=n0, n1=n1, A00=M.mult, A01=Bt, A10=B),
                       rhs=torch.cat([f, g]),
                       prec=block_diag_precond(lambda r: r / dM, lambda r: r / pvec, n0))


def solve(mesh, f_vec=None, g_fn=None, rel_tol: float = 1e-10,
          max_iter: int = 5000, dtype=None, device=None) -> DarcyResult:
    """Solve M u + Bᵀ p = f, B u = g on RT0 × L2-P0 (natural u·n BCs);
    ``f_vec`` / ``g_fn`` take host numpy points; ``device=None`` is the
    card."""
    rt_space = RTSpace(mesh)
    l2 = L2FESpace(mesh, 0)
    sysd = system(rt_space, l2, f_vec, g_fn, dtype, device)
    x, info = minres(sysd.op.mult, sysd.rhs, M=sysd.prec, rel_tol=rel_tol,
                     max_iter=max_iter)
    n0 = rt_space.ndof
    # the block uses +Bᵀ / +B: p̃ = −p of the Darcy form u + ∇p = f
    return DarcyResult(rt=rt_space, l2=l2, u=x[:n0], p=-x[n0:],
                       iterations=int(info.iterations), converged=bool(info.converged))
