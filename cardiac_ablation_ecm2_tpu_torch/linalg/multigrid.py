"""Polynomial and geometric multigrid (``MGLevel``, ``Multigrid``,
``make_p_multigrid`` and ``make_h_multigrid`` of
``cardiac_ablation_ecm2_tpu/linalg/multigrid.py``; MFEM's ``Multigrid``
over a space hierarchy with Chebyshev-smoothed levels, the ex26 pattern).

A hierarchy is a list of levels, coarsest first; each holds a matrix-free
operator, a smoother and the transfers from the next coarser level
(``fem/transfer.py``).  The V-cycle runs eagerly: its coarse solve is CG,
which reads the host once per iteration (``linalg/solvers.cg``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..utils.config import resolve_device
from .smoothers import chebyshev
from .solvers import cg


@dataclasses.dataclass(eq=False)
class MGLevel:
    A: Callable                         # operator apply (constrained if BCs)
    smoother: Callable                  # approximate A⁻¹ (e.g. Chebyshev)
    prolongate: Optional[Callable]      # from the next coarser level (None at 0)
    restrict_t: Optional[Callable]
    ess: Optional[torch.Tensor] = None  # essential dofs of THIS level (int64)


@dataclasses.dataclass(eq=False)
class Multigrid:
    """V-cycle over levels[0] = coarsest … levels[-1] = finest.  ``cycles``
    counts the V-cycles run as a preconditioner; ``setup_seconds`` holds
    the setup's parts where the function that made the hierarchy timed
    them."""

    levels: List[MGLevel]
    coarse_iters: int = 32              # CG iterations on the coarsest level
    coarse_M: Optional[Callable] = None
    cycles: int = 0
    setup_seconds: dict = dataclasses.field(default_factory=dict)

    def _coarse_solve(self, b):
        lvl = self.levels[0]
        x, _ = cg(lvl.A, b, M=self.coarse_M or lvl.smoother,
                  rel_tol=1e-8, max_iter=self.coarse_iters)
        return x

    def v_cycle(self, b, level: Optional[int] = None):
        if level is None:
            level = len(self.levels) - 1
        if level == 0:
            return self._coarse_solve(b)
        lvl = self.levels[level]
        x = lvl.smoother(b)                              # pre-smooth (x0 = 0)
        r = b - lvl.A(x)
        rc = lvl.restrict_t(r)
        coarse_ess = self.levels[level - 1].ess
        if coarse_ess is not None:
            # the restriction leaks interior residual into constrained
            # coarse rows; project back onto the constrained subspace (out
            # of place: no tensor a solver still holds is written)
            rc = rc.index_fill(0, coarse_ess, 0.0)
        ec = self.v_cycle(rc, level - 1)
        x = x + lvl.prolongate(ec)
        x = x + lvl.smoother(b - lvl.A(x))               # post-smooth
        return x

    def preconditioner(self) -> Callable:
        def prec(r):
            self.cycles += 1
            return self.v_cycle(r)

        return prec


def ess_tensor(ess, device) -> Optional[torch.Tensor]:
    """An essential-dof list as an int64 tensor on ``device``, or None when
    it is empty (no projection on that level)."""
    if ess is None or len(ess) == 0:
        return None
    return torch.as_tensor(np.asarray(ess, dtype=np.int64), device=device)


def make_p_multigrid(
    fes_factory: Callable,
    operator_factory: Callable,
    orders: Sequence[int],
    smoother_order: int = 3,
    ess_factory: Optional[Callable] = None,   # fes -> essential dof array
    dtype=None,
    device=None,
) -> Multigrid:
    """p-MG: ``fes_factory(p)`` → space, ``operator_factory(fes)`` → an
    object with ``mult`` and ``diagonal`` on ``device`` (e.g. a constrained
    partially assembled operator).  ``orders`` coarse → fine, e.g. (1, 2, 4).
    The essential-dof sets of the levels must be nested (the same boundary
    attributes), as they are in a same-mesh p-hierarchy."""
    from ..fem.transfer import PTransfer

    device = resolve_device(device)
    spaces = [fes_factory(p) for p in orders]
    ops = [operator_factory(f) for f in spaces]
    levels: List[MGLevel] = []
    for i, (f, op) in enumerate(zip(spaces, ops)):
        sm = chebyshev(op.mult, op.diagonal(), order=smoother_order)
        ess = ess_tensor(ess_factory(f), device) if ess_factory else None
        if i == 0:
            levels.append(MGLevel(op.mult, sm, None, None, ess))
        else:
            tr = PTransfer(spaces[i - 1], f, dtype=dtype, device=device)
            levels.append(MGLevel(op.mult, sm, tr.prolongate, tr.restrict_t, ess))
    return Multigrid(levels=levels)


def make_h_multigrid(
    meshes: Sequence,
    fes_factory: Callable,
    operator_factory: Callable,
    smoother_order: int = 3,
    ess_factory: Optional[Callable] = None,
    dtype=None,
    device=None,
) -> Multigrid:
    """h-MG over a uniform-refinement mesh hierarchy, coarse → fine:
    ``fes_factory(mesh)`` → space, ``operator_factory(fes)`` → an object
    with ``mult`` and ``diagonal`` on ``device``; the levels are joined by
    ``fem/transfer.HTransfer``."""
    from ..fem.transfer import HTransfer

    device = resolve_device(device)
    spaces = [fes_factory(m) for m in meshes]
    ops = [operator_factory(f) for f in spaces]
    levels: List[MGLevel] = []
    for i, (f, op) in enumerate(zip(spaces, ops)):
        sm = chebyshev(op.mult, op.diagonal(), order=smoother_order)
        ess = ess_tensor(ess_factory(f), device) if ess_factory else None
        if i == 0:
            levels.append(MGLevel(op.mult, sm, None, None, ess))
        else:
            tr = HTransfer(spaces[i - 1], f, dtype=dtype, device=device)
            levels.append(MGLevel(op.mult, sm, tr.prolongate, tr.restrict_t, ess))
    return Multigrid(levels=levels)
