"""Rank-local pieces of a sharded operator apply (counterpart of
``cardiac_ablation_ecm2_tpu/parallel/ops.py``).

Every tensor argument is this rank's own: an E-vector of its padded
element block, or its local L-vector with the trailing trash slot.  The
E→L sum is the rank's ``ElementRestriction`` (the segment-sum kernel on
the card); the halo exchange is one ``batch_isend_irecv`` per colour of
the schedule ``pfespace.build`` made (``GroupCommunicator::Bcast/Reduce``,
fused into one symmetric partial-sum exchange); inner products end in one
``all_reduce`` (``MPI_Allreduce``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from ..linalg import ode
from ..utils.config import config


def local_scatter(y_e: torch.Tensor, restr, nloc: int) -> torch.Tensor:
    """E→L sum on this rank: (ne_loc, nd) → (nloc+1,), trash slot cleared."""
    y = restr.mult_transpose(y_e)
    y[nloc] = 0.0
    return y


class Halo:
    """This rank's halo exchange: per colour, the partner rank and the local
    ids of the dofs it shares with it (the real lists, not the JAX
    package's ``max_shared`` padding).  A rank with no partner in a colour
    has no round for it."""

    def __init__(self, rounds: List[Tuple[int, torch.Tensor]], nloc: int):
        self.rounds = rounds
        self.nloc = nloc

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        """Add the partners' partial sums at shared dofs, in place, and clear
        the trash slot.  Every round sends the pre-exchange partials, so
        dofs shared by k > 2 ranks sum right; the adds follow the colours'
        order, as the JAX package's."""
        bufs = [y[idx] for _, idx in self.rounds]
        for (partner, idx), buf in zip(self.rounds, bufs):
            recv = torch.empty_like(buf)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, buf, partner),
                    dist.P2POp(dist.irecv, recv, partner)]):
                req.wait()
            y.index_add_(0, idx, recv)
        y[self.nloc] = 0.0
        return y


def make_pdot(weight: torch.Tensor):
    """Multiplicity-weighted global inner product (IterativeSolver::Dot):
    the local weighted sum, in float64 for float32 vectors when
    ``config.f64_reductions`` is set (as ``linalg/solvers.default_dot``),
    then one ``all_reduce`` of the scalar."""

    def pdot(a, b):
        x = a * weight * b
        if config.f64_reductions and x.dtype != torch.float64:
            s = x.double().sum()
        else:
            s = x.sum()
        s = s.reshape(1)
        dist.all_reduce(s)
        return s[0].to(a.dtype)

    return pdot


def masked_diagonal(d: torch.Tensor, emask: torch.Tensor, nloc: int) -> torch.Tensor:
    """A Jacobi diagonal on this rank: ``d`` where ``emask`` is 1, 1 at
    essential dofs, at the trash slot and at unused pad slots (whose
    assembled diagonal is 0), so that no division is 0/0."""
    dg = d * emask + (1.0 - emask)
    dg[nloc] = 1.0
    return torch.where(dg == 0.0, 1.0, dg)


def rk_stepper(solver, implicit_solve):
    """``(T, t, dt) -> (T, t + dt)``: ``linalg/ode``'s Butcher-tableau step
    over this rank's stage solve ``implicit_solve(gamma, y)``.  A stage
    with a_ii = 0 is its γ = 0 solve, as the JAX package's unrolled stages
    take it; a solver without a tableau raises ``ValueError``."""
    ode_solver = ode.select(solver)
    if not isinstance(ode_solver, ode.RKSolver):
        raise ValueError(f"the sharded step needs a Butcher tableau; "
                         f"{solver!r} has none")
    f = ode.FunctionOperator(lambda t, y: implicit_solve(0.0, y),
                             lambda gamma, t, y: implicit_solve(gamma, y))
    return lambda T, t, dt: ode_solver.step(f, T, t, dt)


def zero_at(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Zero entries at (padded) local indices; pads point at the trash slot."""
    return v.index_fill(0, idx, 0.0)
