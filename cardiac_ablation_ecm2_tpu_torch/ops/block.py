"""Block operators on concatenated vectors (counterpart of
``BlockOperator`` and ``block_diag_precond`` in
``cardiac_ablation_ecm2_tpu/ops/block.py``; MFEM's ``BlockOperator`` and
``BlockDiagonalPreconditioner``): a block operator is a function on one
flat vector [u; p] with static offsets, so the Krylov solvers need no block
awareness.  ``mixed_divergence`` is the RT0 × L2 coupling of Darcy (ex5):
its gathers and scatters run on the two spaces' ``ElementRestriction``s."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
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


def mixed_divergence(rt_space, l2_fes, nq1d: int = 3, dtype=None, device=None):
    """B: RT0 → L2' with (B u)_m = (div u, q_m); returns (B, Bt) callables
    (VectorFEDivergenceIntegrator; div_phys = div_ref / det J, so the
    w·det J weight cancels to w·div_ref: one (ndl2, nfl) element matrix,
    no geometry).  ``device=None`` is the card."""
    from ..fem.basis import make_dof_to_quad
    from ..fem.build import restriction_for
    from ..fem.fe_vector import rt0_basis
    from ..fem.intrules import tensor_rule
    from ..utils.config import real_t, resolve_device
    from .vecfe import _restriction

    device = resolve_device(device)
    mesh = rt_space.mesh
    rt = real_t(dtype)
    _, _, Dref = rt0_basis(mesh.geom, nq1d)              # (nq, nfl)
    Bl2 = make_dof_to_quad(mesh.geom, l2_fes.order, nq1d).full_B()
    _, w = tensor_rule(mesh.dim, nq1d)
    Dmat = torch.as_tensor(np.einsum("q,qm,qn->mn", w, Bl2, Dref), dtype=rt,
                           device=device)
    r_rt = _restriction(rt_space, device)
    r_l2 = restriction_for(l2_fes, device)
    sg = torch.as_tensor(rt_space.signs, dtype=rt, device=device)

    def B(u):
        v = torch.einsum("mn,en->em", Dmat, r_rt.mult(u) * sg)
        return r_l2.mult_transpose(v.contiguous())

    def Bt(p):
        v = torch.einsum("mn,em->en", Dmat, r_l2.mult(p)) * sg
        return r_rt.mult_transpose(v)

    return B, Bt
