"""Repartitioning for partitioned FE spaces (counterpart of
``cardiac_ablation_ecm2_tpu/parallel/rebalance.py``; MFEM's
``ParNCMesh::Rebalance`` and ``ParMesh`` redistribution).

Partitions are tables: a rebalance is a new weighted-RCB partition from
per-element costs, a rebuilt ``ParFESpace``, and a transfer that moves a
rank's local field from the old layout to the new one.  The JAX package
gathers from the flat stacked layout; here every rank sends what each new
rank needs of its old field in one ``all_to_all_single``, with the counts
worked out on the host from the JAX package's first-owner rule (the lowest
old rank holding a dof supplies it; owners agree after a halo exchange).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils.config import resolve_device
from .partition import element_centroids, rcb_weighted
from .pfespace import ParFESpace, build


def repartition(pf: ParFESpace, weights: np.ndarray = None) -> ParFESpace:
    """New ParFESpace with element loads balanced by ``weights`` (default:
    uniform, for a skewed or user-supplied previous partition)."""
    mesh = pf.fes.mesh
    if weights is None:
        weights = np.ones(mesh.ne)
    parts = rcb_weighted(element_centroids(mesh), weights, pf.ndev)
    return build(pf.fes, pf.ndev, parts)


class TransferMap:
    """This rank's old local field → its new local field, on ``device``."""

    def __init__(self, send_slots, send_counts, recv_slots, recv_counts,
                 nloc_new, device):
        self.send_slots = torch.as_tensor(send_slots, device=device)
        self.recv_slots = torch.as_tensor(recv_slots, device=device)
        self.send_counts = [int(c) for c in send_counts]
        self.recv_counts = [int(c) for c in recv_counts]
        self.nloc_new = nloc_new

    def __call__(self, u_loc_old: torch.Tensor) -> torch.Tensor:
        send = u_loc_old[self.send_slots]
        recv = send.new_empty(len(self.recv_slots))
        dist.all_to_all_single(recv, send, self.recv_counts, self.send_counts)
        out = u_loc_old.new_zeros(self.nloc_new + 1)
        out[self.recv_slots] = recv
        return out


def transfer_map(pf_old: ParFESpace, pf_new: ParFESpace, rank: int,
                 device=None) -> TransferMap:
    """The old → new mover of rank ``rank`` on ``device`` (``None``: the
    card).  Both spaces must wrap the same global dof numbering; pads and
    the trash slot come out 0."""
    if pf_old.ndof_global != pf_new.ndof_global:
        raise ValueError("the two partitions number different spaces")
    owner = np.zeros(pf_old.ndof_global, dtype=np.int64)
    owner_slot = np.zeros(pf_old.ndof_global, dtype=np.int64)
    for d in range(pf_old.ndev - 1, -1, -1):   # first owner wins
        g = pf_old.loc2glob[d]
        real = np.nonzero(g >= 0)[0]
        owner[g[real]] = d
        owner_slot[g[real]] = real

    # what each new rank d needs, ordered by source rank (stable within)
    def needs(d):
        g = pf_new.loc2glob[d]
        real = np.nonzero(g >= 0)[0]
        src = owner[g[real]]
        order = np.argsort(src, kind="stable")
        return src[order], real[order], owner_slot[g[real]][order]

    ndev = pf_new.ndev
    src, slots_new, _ = needs(rank)
    recv_counts = np.bincount(src, minlength=pf_old.ndev)
    send_slots, send_counts = [], []
    for d in range(ndev):
        s, _, old = needs(d)
        mine = old[s == rank]
        send_slots.append(mine)
        send_counts.append(len(mine))
    return TransferMap(np.concatenate(send_slots), send_counts, slots_new,
                       recv_counts, pf_new.nloc, resolve_device(device))
