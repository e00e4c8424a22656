"""Block operators on concatenated vectors (counterpart of
``BlockOperator`` and ``block_diag_precond`` in
``cardiac_ablation_ecm2_tpu/ops/block.py``; MFEM's ``BlockOperator`` and
``BlockDiagonalPreconditioner``): a block operator is a function on one
flat vector [u; p] with static offsets, so the Krylov solvers need no block
awareness.  (``mixed_divergence`` waits for the port's ``RTSpace``.)"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(eq=False)
class BlockOperator:
    """2×2 block operator on concatenated vectors [u; p]."""

    n0: int
    n1: int
    A00: Callable
    A01: Callable              # block-1 vector → block-0 vector
    A10: Callable
    A11: Optional[Callable] = None   # None: a zero block

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        u, p = x[: self.n0], x[self.n0:]
        y0 = self.A00(u) + self.A01(p)
        y1 = self.A10(u)
        if self.A11 is not None:
            y1 = y1 + self.A11(p)
        return torch.cat([y0, y1])


def block_diag_precond(M0: Callable, M1: Callable, n0: int) -> Callable:
    def prec(r):
        return torch.cat([M0(r[:n0]), M1(r[n0:])])

    return prec
