"""Parallel uniform refinement with a rank-local solution transfer
(counterpart of ``cardiac_ablation_ecm2_tpu/parallel/refine.py``; MFEM's
``ParMesh::UniformRefinement`` with the ``ParFiniteElementSpace`` update
and ``ParGridFunction::Update``).

Children stay on their parent's rank (child o of coarse element e is fine
element o·ne_c + e, the ``HTransfer`` order), so the prolongation is
rank-local: the coarse local L→E gather, one batched (nchild, nd, nd)
einsum into the fine element slots, the fine local E→L sum (the
segment-sum kernel on the card) and the halo exchange, divided by the
number of written element slots that touch each dof (summed across ranks
the same way).  No element moves between ranks; rebalancing afterwards is
``parallel/rebalance``'s job.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..fem.fespace import FESpace
from ..fem.transfer import child_interpolation
from ..utils.config import real_t, resolve_device
from .ops import local_scatter
from .pfespace import LocalSpace, ParFESpace, build


@dataclasses.dataclass(eq=False)
class ParHTransfer:
    """Host tables of the uniform-refinement transfer for every rank."""

    coarse: ParFESpace
    fine: ParFESpace
    I: np.ndarray                # (nchild, nd, nd) child interpolation
    child_slot: np.ndarray       # (ndev, nchild, ne_loc_c) fine slot (pad: ne_loc_f)

    def local(self, rank: int, device=None, dtype=None) -> "LocalHTransfer":
        """Rank ``rank``'s transfer on ``device`` (``None``: the card), over
        the rank's coarse and fine ``LocalSpace``."""
        device = resolve_device(device)
        return LocalHTransfer(
            coarse=self.coarse.local(rank, device, dtype),
            fine=self.fine.local(rank, device, dtype),
            I=torch.as_tensor(self.I, dtype=real_t(dtype), device=device),
            child_slot=torch.as_tensor(self.child_slot[rank].reshape(-1),
                                       device=device))


@dataclasses.dataclass(eq=False)
class LocalHTransfer:
    """One rank's prolongation: coarse local L-vector → fine local
    L-vector, consistent across ranks after its halo exchange.  Collective:
    every rank calls ``prolongate`` together."""

    coarse: LocalSpace
    fine: LocalSpace
    I: torch.Tensor              # (nchild, nd, nd)
    child_slot: torch.Tensor     # (nchild·ne_loc_c,) int64
    _inv_count: Optional[torch.Tensor] = None

    def _scatter(self, e_f: torch.Tensor) -> torch.Tensor:
        """(ne_loc_f + 1, nd) slots (the last one the trash row) → the
        halo-summed fine local L-vector."""
        f = self.fine
        return f.halo(local_scatter(e_f[:-1], f.restr, f.nloc))

    def prolongate(self, uc_loc: torch.Tensor) -> torch.Tensor:
        e_c = self.coarse.restr.mult(uc_loc)                  # (ne_loc_c, nd)
        e_ch = torch.einsum("omn,en->oem", self.I, e_c)
        nd = e_ch.shape[-1]
        ne_f = self.fine.restr.ne
        if self._inv_count is None:
            # element slots a child was written to (pad slots of either
            # space must not dilute the average)
            w = torch.zeros(ne_f + 1, nd, dtype=e_ch.dtype, device=e_ch.device)
            w[self.child_slot] = 1.0
            cnt = self._scatter(w)
            self._inv_count = torch.where(cnt > 0, 1.0 / cnt.clamp_min(1.0), 0.0)
        e_f = torch.zeros(ne_f + 1, nd, dtype=e_ch.dtype, device=e_ch.device)
        e_f[self.child_slot] = e_ch.reshape(-1, nd)
        return self._scatter(e_f) * self._inv_count


def refine_uniform(pf: ParFESpace, dtype=None):
    """(fine ParFESpace, ParHTransfer): every element refined 2^dim ways
    (4 for triangles), children kept on the parent's rank.  ``dtype`` is
    accepted for the JAX package's signature; the tables are numpy and the
    tensors take their dtype in :meth:`ParHTransfer.local`."""
    fes_c = pf.fes
    mesh_f = fes_c.mesh.uniform_refinement()
    fes_f = FESpace(mesh_f, fes_c.order)
    ne_c = fes_c.mesh.ne
    nchild = mesh_f.ne // ne_c
    pf_f = build(fes_f, pf.ndev, np.tile(pf.parts, nchild))

    # the rank-local slot of each child: the position of its global fine id
    # in the rank's ascending element list (pads → the trash row ne_loc_f)
    child_slot = np.full((pf.ndev, nchild, pf.ne_loc), pf_f.ne_loc,
                         dtype=np.int64)
    for d in range(pf.ndev):
        felems = pf_f.elems[d]
        order = np.argsort(felems, kind="stable")
        sorted_f = felems[order]
        real_c = pf.elem_weight[d] > 0
        for o in range(nchild):
            gids = o * ne_c + pf.elems[d]
            pos = np.clip(np.searchsorted(sorted_f, gids), 0, len(sorted_f) - 1)
            ok = (sorted_f[pos] == gids) & real_c
            child_slot[d, o] = np.where(ok, order[pos], pf_f.ne_loc)

    return pf_f, ParHTransfer(coarse=pf, fine=pf_f,
                              I=child_interpolation(fes_c.mesh.geom, fes_c.order),
                              child_slot=child_slot)
