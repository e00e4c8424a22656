"""Parallel SubMesh and rank-local transfer maps (counterpart of
``cardiac_ablation_ecm2_tpu/parallel/psubmesh.py``; MFEM's
``ParSubMesh::CreateFromDomain`` and ``ParTransferMap``, the parallel
coupling of ``miniapps/multidomain/multidomain.cpp``).

The submesh inherits the parent's element partition: each sub element lives
on its parent element's rank (a boundary submesh on the rank of the element
next to the face).  Every sub dof a rank holds is then in the rank's parent
L-vector, so ``transfer_to_sub`` is one gather of the rank's own vector
(``ops/gather_probes.take_flat``, the one-plane ``gather_sum`` kernel on
the card) and needs no communication.  ``transfer_to_parent`` writes the
sub values with ``index_copy_``, then, with the parent's halo schedule,
passes written values to partners whose own sub block does not touch a
shared dof (``ParTransferMap``'s shared-vertex exchange): per colour one
``batch_isend_irecv`` with the partner (``parallel/ops.Halo``'s rounds), and
a bit-exact select — take the partner's value only where this rank wrote
none and the partner did — as the JAX package's ``ppermute`` select.

The host tables (``build_sub``'s sub ``ParFESpace``, ``idx`` and ``wmask``)
are bitwise the JAX package's and stacked on a leading rank axis; a rank
keeps its row on its device (:meth:`ParTransferMap.local`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..mesh.submesh import SubMesh, _local_faces, last_match, sub_to_parent_map
from ..ops.gather_probes import take_flat
from ..utils.config import real_t, resolve_device
from .pfespace import ParFESpace, build


def boundary_adjacent_elements(mesh) -> np.ndarray:
    """(nbe,) the element next to each boundary face (the last element in
    element order that holds the face, as the JAX package's dict)."""
    from ..fem.geometry import FACES

    faces = _local_faces(mesh.elements, mesh.geom)
    owner = np.repeat(np.arange(mesh.ne, dtype=np.int64), len(FACES[mesh.geom]))
    out = last_match(np.sort(faces, axis=1), owner, np.sort(mesh.boundary, axis=1))
    if np.any(out < 0):
        raise KeyError(tuple(np.sort(mesh.boundary[np.argmax(out < 0)])))
    return out


def sub_partition(parent_parts: np.ndarray, sm: SubMesh) -> np.ndarray:
    """Partition of the submesh inherited from the parent's."""
    if sm.from_boundary:
        adj = boundary_adjacent_elements(sm.parent)
        return parent_parts[adj[sm.parent_elems]]
    return parent_parts[sm.parent_elems]


@dataclasses.dataclass(eq=False)
class ParTransferMap:
    """Every rank's dof map, sub local L-vector ↔ parent local L-vector:
    ``idx`` (ndev, nloc_sub+1) parent-local ids (pads and the sub trash
    slot → the parent trash slot) and ``wmask`` (ndev, nloc_parent+1), 1
    where the rank's sub block writes.  The fields may also be the JAX
    map's, as numpy."""

    idx: np.ndarray
    wmask: np.ndarray

    def local(self, rank: int, device=None, dtype=None):
        """Rank ``rank``'s (idx int32, wmask) on ``device`` (``None``: the
        card), the mask in ``dtype``."""
        device = resolve_device(device)
        return (torch.as_tensor(np.asarray(self.idx[rank], dtype=np.int32),
                                device=device),
                torch.as_tensor(self.wmask[rank], dtype=real_t(dtype), device=device))


def transfer_to_sub(idx_d: torch.Tensor, u_parent_loc: torch.Tensor) -> torch.Tensor:
    """Rank-local: parent local L-vector → sub local L-vector (trash slot
    included), one gather."""
    return take_flat(u_parent_loc, idx_d)


def transfer_to_parent(idx_d: torch.Tensor, u_sub_loc: torch.Tensor,
                       u_parent_loc: torch.Tensor, wmask_d=None, halo=None):
    """Rank-local: a copy of the parent local L-vector with the sub values
    written in.  The sub trash slot and pads map to the parent trash slot,
    so they land harmlessly; real parent dofs outside the sub are unchanged.
    With the parent's ``halo`` (``ops.Halo``) and ``wmask_d``, written
    values go to sharing ranks whose own sub block does not touch the dof,
    and the parent trash slot is restored.  Every writer holds the same
    value, so the exchange selects, it does not average."""
    up = u_parent_loc.clone().index_copy_(0, idx_d.long(), u_sub_loc)
    if wmask_d is None:
        return up
    nloc = halo.nloc
    w = wmask_d.clone()
    w[nloc] = 0.0
    for partner, ids in halo.rounds:
        buf = torch.stack([up[ids], w[ids]])
        recv = torch.empty_like(buf)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, buf, partner),
                dist.P2POp(dist.irecv, recv, partner)]):
            req.wait()
        bu, bw = buf
        ru, rw = recv
        take = (bw == 0) & (rw > 0)
        up[ids] = torch.where(take, ru, bu)
        w[ids] = torch.maximum(bw, rw)
    up[nloc] = u_parent_loc[nloc]
    return up


def build_sub(parent_pf: ParFESpace, sm: SubMesh, sub_fes, parent_fes=None):
    """(sub ParFESpace, ParTransferMap) with the inherited partition.

    ``sub_fes``: the space on ``sm.mesh`` of the parent's order;
    ``parent_fes`` defaults to ``parent_pf.fes``."""
    if parent_fes is None:
        parent_fes = parent_pf.fes
    parts_sub = sub_partition(parent_pf.parts, sm)
    sub_pf = build(sub_fes, parent_pf.ndev, parts_sub)
    s2p = sub_to_parent_map(parent_fes, sub_fes, sm)

    ndev, nloc = parent_pf.ndev, parent_pf.nloc
    idx = np.full((ndev, sub_pf.nloc + 1), nloc, dtype=np.int64)
    for d in range(ndev):
        gsub = sub_pf.loc2glob[d]                     # (nloc_sub,) or −1
        valid = gsub >= 0
        gpar = np.where(valid, s2p[np.clip(gsub, 0, len(s2p) - 1)], -1)
        l2g = parent_pf.loc2glob[d]
        ploc = np.searchsorted(np.where(l2g < 0, np.iinfo(np.int64).max, l2g),
                               np.clip(gpar, 0, None))
        ok = valid & (ploc < nloc) & (l2g[np.clip(ploc, 0, nloc - 1)] == gpar)
        if not bool(np.all(ok | ~valid)):
            raise RuntimeError(
                f"rank {d}: {int(np.sum(valid & ~ok))} sub dofs missing from "
                "the parent rank's block: partition not inherited?")
        idx[d, : sub_pf.nloc] = np.where(ok, ploc, nloc)

    wmask = np.zeros((ndev, nloc + 1))
    for d in range(ndev):
        real = idx[d, : sub_pf.nloc]
        wmask[d, real[real < nloc]] = 1.0
    return sub_pf, ParTransferMap(idx=idx, wmask=wmask)
