"""Operator algebra and essential-BC constrained operators (counterpart of
``LinearOperator``, ``identity``, ``ConstrainedOperator`` and
``form_linear_system`` in ``cardiac_ablation_ecm2_tpu/ops/operators.py``;
MFEM's ``Operator``, ``ConstrainedOperator`` and ``FormLinearSystem``).

An operator is a function ``x -> A x`` on flat dof vectors plus a little
metadata.  The essential dofs act through a 0/1 mask held in the working
dtype on the vectors' device, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils.config import real_t, resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class LinearOperator:
    """A linear operator y = mult(x) on flat dof vectors."""

    shape: Tuple[int, int]
    mult: Callable[[torch.Tensor], torch.Tensor]
    diagonal_fn: Optional[Callable[[], torch.Tensor]] = None

    def __call__(self, x):
        return self.mult(x)

    @property
    def height(self):
        return self.shape[0]

    @property
    def width(self):
        return self.shape[1]

    def diagonal(self) -> torch.Tensor:
        if self.diagonal_fn is None:
            raise NotImplementedError("operator has no diagonal assembly")
        return self.diagonal_fn()

    def __add__(self, other: "LinearOperator") -> "LinearOperator":
        diag = None
        if self.diagonal_fn is not None and other.diagonal_fn is not None:
            diag = lambda: self.diagonal() + other.diagonal()
        return LinearOperator(self.shape, lambda x: self.mult(x) + other.mult(x),
                              diag)

    def __rmul__(self, a) -> "LinearOperator":
        diag = None if self.diagonal_fn is None else (lambda: a * self.diagonal())
        return LinearOperator(self.shape, lambda x: a * self.mult(x), diag)

    def scaled_add(self, a, other: "LinearOperator", b=1.0) -> "LinearOperator":
        """a·self + b·other (the reference's SumOperator)."""
        diag = None
        if self.diagonal_fn is not None and other.diagonal_fn is not None:
            diag = lambda: a * self.diagonal() + b * other.diagonal()
        return LinearOperator(self.shape,
                              lambda x: a * self.mult(x) + b * other.mult(x), diag)


def identity(n: int, dtype=None, device=None) -> LinearOperator:
    """The n×n identity; its diagonal is made on ``device`` (``None``: the
    card)."""
    device = resolve_device(device)
    return LinearOperator((n, n), lambda x: x,
                          lambda: torch.ones(n, dtype=real_t(dtype), device=device))


@dataclasses.dataclass(frozen=True, eq=False)
class ConstrainedOperator:
    """Essential-BC constrained wrapper (MFEM ``ConstrainedOperator``).

    mult:  z = x with ess dofs zeroed; y = A z; y[ess] = x[ess]."""

    op: LinearOperator
    ess_dofs: torch.Tensor   # (ness,) int32
    mask: torch.Tensor       # (n,) 0 at constrained dofs, 1 elsewhere

    @staticmethod
    def wrap(op: LinearOperator, ess_dofs, dtype=None,
             device=None) -> "ConstrainedOperator":
        """The mask in ``dtype`` on ``device`` (``None``: the card)."""
        device = resolve_device(device)
        ess = np.asarray(ess_dofs, dtype=np.int64)
        m = np.ones(op.shape[0])
        m[ess] = 0.0
        return ConstrainedOperator(
            op=op, ess_dofs=torch.as_tensor(ess, dtype=torch.int32, device=device),
            mask=torch.as_tensor(m, dtype=real_t(dtype), device=device))

    @property
    def shape(self):
        return self.op.shape

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        m = self.mask.to(x.dtype)
        z = x * m
        return self.op.mult(z) * m + (x - z)

    def __call__(self, x):
        return self.mult(x)

    def diagonal(self) -> torch.Tensor:
        d = self.op.diagonal()
        m = self.mask.to(d.dtype)
        return d * m + (1.0 - m)

    def eliminate_rhs(self, x_bc: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Fold the boundary values into the right-hand side (EliminateRHS)."""
        m = self.mask.to(x_bc.dtype)
        w = x_bc * (1.0 - m)
        bmod = b - self.op.mult(w)
        return bmod * m + w


def form_linear_system(op: LinearOperator, ess_dofs, x_bc: torch.Tensor,
                       b: torch.Tensor):
    """FormLinearSystem: returns (A_constrained, B) with the boundary values
    eliminated into B; the solution of A_constrained X = B satisfies
    X[ess] = x_bc[ess].  The mask takes ``x_bc``'s dtype and device."""
    A = ConstrainedOperator.wrap(op, ess_dofs, x_bc.dtype, x_bc.device)
    return A, A.eliminate_rhs(x_bc, b)
