"""Simple preconditioners (``jacobi`` of
``cardiac_ablation_ecm2_tpu/linalg/smoothers.py``; OperatorJacobiSmoother on
the assembled partial-assembly diagonal)."""

from __future__ import annotations

from typing import Callable

import torch


def jacobi(diag: torch.Tensor, damping: float = 1.0) -> Callable:
    """M(r) = damping · r / diag."""
    inv = damping / diag

    def prec(r):
        return inv * r

    return prec
