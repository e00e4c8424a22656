"""Block ILU(0) with level-scheduled triangular solves (counterpart of
``cardiac_ablation_ecm2_tpu/linalg/blockilu.py``; MFEM's ``BlockILU``, the
standard DG preconditioner).

The factorisation (small dense blocks, a sequential dependency) is host
numpy at setup, as in the JAX package and MFEM.  The apply runs on the
vectors' device: rows are grouped into dependency levels (wavefronts of
the triangular graphs), each level one batched (k, b, b) product.  A row
takes several updates within a level; the JAX package scatter-adds them
(``y.at[rows].add``).  Here they are summed by the sorted segment-sum of
``ops/block_gather.py`` over the level's destination slots, in a fixed
order and without float atomics, and each touched row is written once, so
the apply is deterministic on the card too.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..fem.restriction import scatter_slots
from ..ops.block_gather import segment_sum
from ..utils.config import real_t, resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class _Level:
    """One wavefront: entry k updates row ``rows[k]`` from ``cols[k]``
    through ``blocks[k]``; ``dest`` are the touched flat dofs (ascending)
    and (``slots``, ``offsets``) sum each one's updates."""

    rows: torch.Tensor       # (k,) int64
    cols: torch.Tensor       # (k,) int64
    blocks: torch.Tensor     # (k, b, b)
    dest: torch.Tensor       # (t,) int64, unique flat dofs
    slots: torch.Tensor      # (k·b,) int32
    offsets: torch.Tensor    # (t + 1,) int64

    def scatter_sub(self, y: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
        """y with each level row reduced by the sum of its updates."""
        flat = y.reshape(-1)
        s = segment_sum(upd.reshape(-1), self.slots, self.offsets)
        return flat.index_copy(0, self.dest, flat[self.dest] - s).view(y.shape)


@dataclasses.dataclass(eq=False)
class BlockILU:
    """Factored state and the device apply tables."""

    nblk: int
    b: int
    Dinv: torch.Tensor           # (nblk, b, b) inverted pivots
    low: Tuple[_Level, ...]      # lower solve, one entry per level
    up: Tuple[_Level, ...]
    perm: np.ndarray             # block ordering used (the identity)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """M⁻¹ r by the level-scheduled forward and backward block solves."""
        y = r.reshape(self.nblk, self.b)
        for lv in self.low:
            y = lv.scatter_sub(y, torch.einsum("kij,kj->ki", lv.blocks, y[lv.cols]))
        z = torch.einsum("kij,kj->ki", self.Dinv, y)
        for lv in self.up:
            upd = torch.einsum("kij,kj->ki", self.Dinv[lv.rows],
                               torch.einsum("kij,kj->ki", lv.blocks, z[lv.cols]))
            z = lv.scatter_sub(z, upd)
        return z.reshape(-1)


def block_ilu0(A_blocks: np.ndarray, rows: np.ndarray, cols: np.ndarray,
               nblk: int, dtype=None, device=None) -> BlockILU:
    """Factor a block-sparse matrix given in COO block form: ``A_blocks``
    (nnz, b, b) at block coordinates (rows, cols), every diagonal block
    present.  ILU(0): for k < i with (i, k) stored, L_ik = A_ik D_k⁻¹ and
    A_ij ← A_ij − L_ik A_kj for stored (i, j), j > k.  ``device=None`` is
    the card."""
    dev = resolve_device(device)
    rt = real_t(dtype)
    b = A_blocks.shape[1]
    store = {}
    for blk, i, j in zip(A_blocks, rows, cols):
        store[(int(i), int(j))] = np.array(blk, dtype=np.float64)
    row_cols: List[List[int]] = [[] for _ in range(nblk)]
    for (i, j) in store:
        row_cols[i].append(j)
    for i in range(nblk):
        row_cols[i].sort()
        assert (i, i) in store, f"missing diagonal block {i}"

    L = {}
    for i in range(nblk):
        for k in row_cols[i]:
            if k >= i:
                break
            Lik = store[(i, k)] @ np.linalg.inv(store[(k, k)])
            L[(i, k)] = Lik
            for j in row_cols[k]:
                if j > k and (i, j) in store:
                    store[(i, j)] = store[(i, j)] - Lik @ store[(k, j)]

    Dinv = np.stack([np.linalg.inv(store[(i, i)]) for i in range(nblk)])

    def level(rs, cs, blks) -> _Level:
        rs = np.asarray(rs, np.int64)
        flat = (rs[:, None] * b + np.arange(b)).reshape(-1)
        dest, inverse = np.unique(flat, return_inverse=True)
        slots, offsets = scatter_slots(inverse, len(dest))
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)
        return _Level(rows=t(rs), cols=t(np.asarray(cs, np.int64)),
                      blocks=t(np.stack(blks), rt), dest=t(dest),
                      slots=t(slots), offsets=t(offsets))

    def schedule(entries, lower: bool):
        """Group the entries (i, j) → block by the dependency level of
        their target row i."""
        deps: List[List[int]] = [[] for _ in range(nblk)]
        for (i, j) in entries:
            deps[i].append(j)
        order = range(nblk) if lower else range(nblk - 1, -1, -1)
        lev = np.zeros(nblk, dtype=np.int64)
        for i in order:
            if deps[i]:
                lev[i] = 1 + max(lev[j] for j in deps[i])
        out = []
        nlev = int(lev.max()) + 1 if len(entries) else 0
        for lv in range(1, nlev):
            rs, cs, blks = [], [], []
            for (i, j), blk in entries.items():
                if lev[i] == lv:
                    rs.append(i)
                    cs.append(j)
                    blks.append(blk)
            if rs:
                out.append(level(rs, cs, blks))
        return tuple(out)

    up_entries = {(i, j): store[(i, j)] for (i, j) in store if j > i}
    return BlockILU(nblk=nblk, b=b,
                    Dinv=torch.as_tensor(Dinv, dtype=rt, device=dev),
                    low=schedule(L, True), up=schedule(up_entries, False),
                    perm=np.arange(nblk))
