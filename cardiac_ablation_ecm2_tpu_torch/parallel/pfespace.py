"""Partitioned FE space: rank-local numbering and halo-exchange tables
(counterpart of ``cardiac_ablation_ecm2_tpu/parallel/pfespace.py``;
MFEM's ``ParFiniteElementSpace`` with ``GroupCommunicator``).

No owner/ghost asymmetry and no matrix P: each rank owns a balanced block
of elements, and its local L-vector holds every dof its elements touch.
After a local E→L sum, shared dofs hold partial sums; a symmetric pairwise
halo exchange adds the partners' partials, so every rank ends with the
assembled value (Pᵀ then P in one exchange).  The exchange schedule is a
greedy edge colouring of the rank-sharing graph; each colour is a matching,
one send and one receive per rank (``ops.Halo``).

Every rank builds the same host tables (numpy, stacked on a leading rank
axis, bitwise the JAX package's) and keeps its own row on its device with
:meth:`ParFESpace.local`.  Padding conventions, as in the JAX package:

* element slots beyond a rank's real count repeat its element 0 with
  ``elem_weight`` 0 (their qdata are zeroed, so they add nothing);
* the local L-vector has one trailing **trash slot** ``nloc``; every padded
  gather, scatter and halo index points there.  The rank's
  ``ElementRestriction`` maps into ``nloc + 1`` dofs, so pads and the trash
  slot are ordinary dofs of its kernels' maps.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..fem.fespace import FESpace, element_node_coords
from ..fem.restriction import ElementRestriction, scatter_slots
from ..utils.config import real_t, resolve_device
from .ops import Halo
from .partition import partition_mesh


@dataclasses.dataclass(eq=False)
class ParFESpace:
    """Host tables of every rank (leading axis = rank), the JAX package's
    fields."""

    fes: FESpace
    ndev: int
    parts: np.ndarray            # (ne,) rank of each element

    ne_loc: int                  # padded local element count
    nloc: int                    # padded local dof count (excl. trash slot)
    ncolors: int                 # halo exchange rounds
    max_shared: int              # padded shared-dof list length

    elems: np.ndarray            # (ndev, ne_loc) global element ids
    elem_weight: np.ndarray      # (ndev, ne_loc) 1 real / 0 pad
    gather: np.ndarray           # (ndev, ne_loc, nd) local dof ids (pad→nloc)
    loc2glob: np.ndarray         # (ndev, nloc) global dof ids (pad −1)
    dof_weight: np.ndarray       # (ndev, nloc+1) 1/multiplicity (pad 0)
    send_idx: np.ndarray         # (ndev, ncolors, max_shared) local ids (pad nloc)
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]  # per colour: (src, dst) pairs

    @property
    def ndof_global(self) -> int:
        return self.fes.ndof_scalar

    @functools.cached_property
    def scat_perm(self) -> np.ndarray:
        """(ndev, ne_loc·nd) int32: the E-slots in stable order of their
        local dof, the JAX package's sorted segment-sum permutation (and the
        slot list of each rank's ``ElementRestriction``)."""
        flat = self.gather.reshape(self.ndev, -1)
        return np.stack([scatter_slots(f, self.nloc + 1)[0] for f in flat])

    @functools.cached_property
    def scat_seg(self) -> np.ndarray:
        """(ndev, ne_loc·nd) int32: the sorted local dof of each slot."""
        flat = self.gather.reshape(self.ndev, -1)
        return np.take_along_axis(flat, self.scat_perm.astype(np.int64), axis=1)

    @functools.cached_property
    def node_coords(self) -> np.ndarray:
        """(ndev, ne_loc, nd_geo, sdim) geometry E-vector of every rank."""
        return element_node_coords(self.fes.mesh, self.fes.order)[self.elems]

    def partner(self, rank: int, color: int) -> Optional[int]:
        """The rank that ``rank`` exchanges with in ``color``, if any."""
        for src, dst in self.perms[color]:
            if src == rank:
                return dst
        return None

    def local(self, rank: int, device=None, dtype=None) -> "LocalSpace":
        """Rank ``rank``'s row on ``device`` (``None``: the card), weights
        in ``dtype``."""
        device = resolve_device(device)
        rt = real_t(dtype)
        nloc = self.nloc
        rounds = []
        for c in range(len(self.perms)):
            partner = self.partner(rank, c)
            if partner is None:
                continue
            ids = self.send_idx[rank, c]
            rounds.append((partner, torch.as_tensor(
                ids[ids != nloc].astype(np.int64), device=device)))
        l2g = np.concatenate([self.loc2glob[rank], [-1]])
        return LocalSpace(
            rank=rank, nloc=nloc,
            restr=ElementRestriction(self.gather[rank], nloc + 1, device),
            elem_weight=torch.as_tensor(self.elem_weight[rank], dtype=rt,
                                        device=device),
            dof_weight=torch.as_tensor(self.dof_weight[rank], dtype=rt,
                                       device=device),
            loc2glob=torch.as_tensor(l2g, device=device),
            halo=Halo(rounds, nloc),
            node_coords=element_node_coords(self.fes.mesh, self.fes.order)[
                self.elems[rank]],
        )


@dataclasses.dataclass(eq=False)
class LocalSpace:
    """One rank's row of a ``ParFESpace``, on its device."""

    rank: int
    nloc: int
    restr: ElementRestriction    # (ne_loc, nd) map into nloc + 1 dofs
    elem_weight: torch.Tensor    # (ne_loc,)
    dof_weight: torch.Tensor     # (nloc+1,)
    loc2glob: torch.Tensor       # (nloc+1,) int64, −1 at pads and trash
    halo: Halo                   # the rank's exchanges, one per colour
    node_coords: np.ndarray      # (ne_loc, nd_geo, sdim)


def space_of(mesh, order: int, fes: Optional[FESpace] = None) -> FESpace:
    """The order-``order`` space of ``mesh``: ``fes`` when given (a
    prebuilt one, which must be that space), else a new one."""
    if fes is None:
        return FESpace(mesh, order)
    if fes.mesh is not mesh or fes.order != order:
        raise ValueError(f"fes is not the order-{order} space of this mesh")
    return fes


def build(fes: FESpace, ndev: int, parts: np.ndarray = None,
          extra_dofs: Optional[List[np.ndarray]] = None) -> ParFESpace:
    """The tables of ``fes`` split over ``ndev`` ranks by ``parts`` (default
    ``partition_mesh``).  ``extra_dofs`` (optional, one array a rank): global
    dofs to add to the rank's local set beyond those of its elements — the
    ghost dofs of NC constraint masters (``parallel/pnc.py``; ParNCMesh's
    ghost layer).  They join the halo-exchange tables like any shared
    dof."""
    mesh = fes.mesh
    gm = fes.gather_map.astype(np.int64)           # (ne, nd)
    ne, nd = gm.shape
    if parts is None:
        parts = partition_mesh(mesh, ndev)

    dev_elems: List[np.ndarray] = [
        np.nonzero(parts == d)[0] for d in range(ndev)
    ]
    ne_loc = max(len(e) for e in dev_elems)

    elems = np.zeros((ndev, ne_loc), dtype=np.int64)
    elem_weight = np.zeros((ndev, ne_loc))
    for d, e in enumerate(dev_elems):
        elems[d, : len(e)] = e
        elem_weight[d, : len(e)] = 1.0
        if len(e) < ne_loc:
            elems[d, len(e):] = e[0] if len(e) else 0

    # local dof sets (real elements and extra dofs), sorted by global id: a
    # marker array gives np.unique's result in linear time
    gdofs = []
    for e in dev_elems:
        seen = np.zeros(fes.ndof_scalar, dtype=bool)
        seen[gm[e].reshape(-1)] = True
        if extra_dofs is not None:
            seen[np.asarray(extra_dofs[len(gdofs)], dtype=np.int64)] = True
        gdofs.append(np.nonzero(seen)[0])
    nloc = max(len(g) for g in gdofs)

    loc2glob = np.full((ndev, nloc), -1, dtype=np.int64)
    gather = np.full((ndev, ne_loc, nd), nloc, dtype=np.int64)
    for d in range(ndev):
        g = gdofs[d]
        if len(g) == 0:          # a rank that owns no elements: all trash
            continue
        loc2glob[d, : len(g)] = g
        # global → local lookup; padded elements' dofs follow element 0 of
        # the rank (weight 0, so any target is safe; this keeps them in range)
        lut = np.full(fes.ndof_scalar, -1, dtype=np.int64)
        lut[g] = np.arange(len(g))
        local = lut[gm[elems[d]]]
        gather[d] = np.where(local >= 0, local, nloc)

    # multiplicity of each global dof across ranks
    mult = np.zeros(fes.ndof_scalar, dtype=np.int64)
    for g in gdofs:
        mult[g] += 1
    dof_weight = np.zeros((ndev, nloc + 1))
    for d, g in enumerate(gdofs):
        dof_weight[d, : len(g)] = 1.0 / mult[g]

    # rank-sharing edges and shared dof lists (the sorted intersection, as
    # the JAX package's sorted set intersection)
    shared: dict = {}
    for d in range(ndev):
        for e in range(d + 1, ndev):
            common = np.intersect1d(gdofs[d], gdofs[e], assume_unique=True)
            if len(common):
                shared[(d, e)] = common

    # greedy edge colouring (each colour = a matching of the rank graph)
    colors: List[List[Tuple[int, int]]] = []
    for edge in sorted(shared, key=lambda de: -len(shared[de])):
        for cls in colors:
            if all(edge[0] not in pr and edge[1] not in pr for pr in cls):
                cls.append(edge)
                break
        else:
            colors.append([edge])
    ncolors = max(len(colors), 1)
    max_shared = max((len(v) for v in shared.values()), default=1)

    send_idx = np.full((ndev, ncolors, max_shared), nloc, dtype=np.int64)
    perms: List[Tuple[Tuple[int, int], ...]] = []
    for c, cls in enumerate(colors):
        pairs = []
        for (d, e) in cls:
            common = shared[(d, e)]
            send_idx[d, c, : len(common)] = np.searchsorted(gdofs[d], common)
            send_idx[e, c, : len(common)] = np.searchsorted(gdofs[e], common)
            pairs += [(d, e), (e, d)]
        perms.append(tuple(pairs))
    if not colors:
        perms.append(tuple())

    return ParFESpace(
        fes=fes, ndev=ndev, parts=parts,
        ne_loc=ne_loc, nloc=nloc, ncolors=ncolors, max_shared=max_shared,
        elems=elems, elem_weight=elem_weight,
        gather=gather.astype(np.int32),
        loc2glob=loc2glob,
        dof_weight=dof_weight,
        send_idx=send_idx.astype(np.int32),
        perms=tuple(perms),
    )


_TABLES = ("parts", "ne_loc", "nloc", "ncolors", "max_shared", "elems",
           "elem_weight", "gather", "loc2glob", "dof_weight", "send_idx",
           "perms")


def from_jax_tables(fes: FESpace, tables) -> ParFESpace:
    """A port ``ParFESpace`` over the host tables of a JAX ``ParFESpace``
    (``tables``, its numpy fields), on the port space ``fes``, which must
    number the dofs as the JAX space does."""
    kw = {name: getattr(tables, name) for name in _TABLES}
    kw["perms"] = tuple(tuple(tuple(int(r) for r in pr) for pr in c)
                        for c in kw["perms"])
    return ParFESpace(fes=fes, ndev=int(tables.ndev), **kw)


def local_state(stacked, rank: int, device=None, dtype=None) -> torch.Tensor:
    """Row ``rank`` of a stacked (ndev, nloc+1) state, such as a JAX sharded
    state as numpy, as the rank's tensor on ``device`` (``None``: the
    card)."""
    row = np.asarray(stacked)[rank]
    return torch.as_tensor(row, dtype=real_t(dtype), device=resolve_device(device))


def stack_states(rows) -> np.ndarray:
    """Every rank's (nloc+1,) state, in rank order → stacked (ndev, nloc+1)
    numpy, the JAX sharded layout."""
    return np.stack([r.detach().cpu().numpy() if torch.is_tensor(r)
                     else np.asarray(r) for r in rows])


def stack_local_ess(pf: ParFESpace, ess_global: np.ndarray) -> np.ndarray:
    """Global essential dofs → (ndev, max_ness) local ids, pads → the trash
    slot (the JAX package's ``_stack_local_ess`` of ``parallel/poisson.py``
    and its copy in ``parallel/pmg.py``)."""
    rows = []
    for d in range(pf.ndev):
        g = pf.loc2glob[d]
        mask = np.isin(g, ess_global) & (g >= 0)
        rows.append(np.nonzero(mask)[0])
    m = max([len(r) for r in rows] + [1])
    out = np.full((pf.ndev, m), pf.nloc, dtype=np.int32)
    for d, r in enumerate(rows):
        out[d, : len(r)] = r
    return out


def essential_global(fes: FESpace, ess_bdr) -> np.ndarray:
    """Essential dofs of the marked attributes; ``None`` marks every one,
    an empty list none."""
    if ess_bdr is None or len(list(ess_bdr)) > 0:
        return fes.essential_dofs(ess_bdr)
    return np.zeros(0, np.int32)


def local_ess(pf: ParFESpace, ess_global: np.ndarray, rank: int,
              device) -> torch.Tensor:
    """Row ``rank`` of :func:`stack_local_ess`, int64 on ``device``."""
    return torch.as_tensor(stack_local_ess(pf, ess_global)[rank].astype(np.int64),
                           device=device)


# ----------------------------------------------------------------------------
# host-side helpers
# ----------------------------------------------------------------------------


def scatter_global(pf: ParFESpace, u_global: np.ndarray) -> np.ndarray:
    """Global L-vector → stacked local vectors (ndev, nloc+1)."""
    out = np.zeros((pf.ndev, pf.nloc + 1), dtype=np.asarray(u_global).dtype)
    for d in range(pf.ndev):
        g = pf.loc2glob[d]
        real = g >= 0
        out[d, : pf.nloc][real] = np.asarray(u_global)[g[real]]
    return out


def gather_global(pf: ParFESpace, u_loc: np.ndarray) -> np.ndarray:
    """Stacked local vectors → global L-vector (last writer wins; all owners
    agree after a halo exchange)."""
    u_loc = np.asarray(u_loc)
    out = np.zeros(pf.ndof_global, dtype=u_loc.dtype)
    for d in range(pf.ndev):
        g = pf.loc2glob[d]
        real = g >= 0
        out[g[real]] = u_loc[d, : pf.nloc][real]
    return out


def gather_to_root(pf: ParFESpace, x_loc: torch.Tensor) -> Optional[np.ndarray]:
    """Every rank's padded local vector to rank 0, as the global L-vector
    there (``gather_global``); ``None`` on the other ranks."""
    root = dist.get_rank() == 0
    rows = [torch.empty_like(x_loc) for _ in range(pf.ndev)] if root else None
    dist.gather(x_loc, rows, dst=0)
    return gather_global(pf, stack_states(rows)) if root else None
