"""Point evaluation of sharded fields (counterpart of
``cardiac_ablation_ecm2_tpu/parallel/pointeval.py``; MFEM's
``FindPointsGSLIB`` on a ``ParMesh``: every point is routed to the rank
that owns its element, interpolated there, and the value returned to every
requester).

Locating the points (kd-tree and Newton inversion, ``mesh/point_eval``) and
routing them are host set-up, and the tables are bitwise the JAX
package's: each found point has exactly one owner, its element's rank,
with a padded per-rank table of basis rows, element slots and output
positions.  The evaluation is rank-local: the element read is the rank's
``ElementRestriction`` (the ``gather_sum`` kernel on the card), then each
owned point's row times its element's values.  Every rank's output is
zero except at the points it owns, so one ``all_reduce`` (sum) makes the
whole result on every rank, exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..fem.faces import _eval_volume_basis
from ..mesh.point_eval import locate_points
from ..utils.config import real_t, resolve_device
from .pfespace import LocalSpace, ParFESpace, scatter_global


@dataclasses.dataclass(eq=False)
class ParPointEval:
    """Interpolation tables of a fixed point set, every rank's (leading
    axis = rank), float64 on the host."""

    pf: ParFESpace
    npts: int
    B: np.ndarray                 # (ndev, npt_loc, nd) basis at ref coords
    slot: np.ndarray              # (ndev, npt_loc) local element slot
    out_idx: np.ndarray           # (ndev, npt_loc) position in the output
    found: np.ndarray             # (npts,) bool

    def local(self, rank: int, device=None, dtype=None):
        """Rank ``rank``'s (B, slot, out_idx) on ``device`` (``None``: the
        card), B in ``dtype``."""
        device = resolve_device(device)
        return (torch.as_tensor(self.B[rank], dtype=real_t(dtype), device=device),
                torch.as_tensor(self.slot[rank], dtype=torch.int64, device=device),
                torch.as_tensor(self.out_idx[rank], dtype=torch.int64, device=device))

    def interpolate(self, ls: LocalSpace, u_loc: torch.Tensor, tables=None) -> torch.Tensor:
        """Rank-local L-vector ``u_loc`` (nloc+1,) → the (npts,) values on
        every rank (one ``all_reduce`` when a process group is up).
        ``tables``: the rank's :meth:`local` tables, if already made."""
        B, slot, out_idx = tables if tables is not None else self.local(
            ls.rank, u_loc.device, u_loc.dtype)
        ept = ls.restr.mult(u_loc)[slot]                # (npt_loc, nd)
        vals = torch.sum(B * ept, dim=1)
        out = torch.zeros(self.npts + 1, dtype=vals.dtype, device=vals.device)
        out = out.index_add_(0, out_idx, vals)[: self.npts].contiguous()
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.all_reduce(out)
        return out


def prepare(pf: ParFESpace, pts: np.ndarray) -> ParPointEval:
    """Locate the points on the host and build every rank's routing tables:
    each found point goes to the one rank that owns its element."""
    fes = pf.fes
    mesh = fes.mesh
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    elem, ref = locate_points(mesh, pts)
    found = elem >= 0
    npts = len(pts)

    owner = np.where(found, pf.parts[np.clip(elem, 0, mesh.ne - 1)], -1)
    rows = [np.nonzero(owner == d)[0] for d in range(pf.ndev)]
    npt_loc = max(max((len(r) for r in rows), default=1), 1)
    nd = fes.gather_map.shape[1]
    B = np.zeros((pf.ndev, npt_loc, nd))
    slot = np.zeros((pf.ndev, npt_loc), dtype=np.int64)
    out_idx = np.full((pf.ndev, npt_loc), npts, dtype=np.int64)
    for d in range(pf.ndev):
        r = rows[d]
        if not len(r):
            continue
        B[d, : len(r)] = _eval_volume_basis(mesh.geom, fes.order, ref[r])
        # the element's slot on the rank: its place in the rank's list
        felems = pf.elems[d]
        order = np.argsort(felems, kind="stable")
        pos = np.searchsorted(felems[order], elem[r])
        slot[d, : len(r)] = order[np.clip(pos, 0, len(felems) - 1)]
        out_idx[d, : len(r)] = r
    return ParPointEval(pf=pf, npts=npts, B=B, slot=slot, out_idx=out_idx,
                        found=found)


def interpolate_sharded(pe: ParPointEval, u_global: np.ndarray, device=None,
                        dtype=None) -> torch.Tensor:
    """Rank body for tests and host probes: this rank's part of the global
    field ``u_global`` (numpy), then :meth:`ParPointEval.interpolate`.
    Called on every rank of the group (rank 0 alone without one)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    ls = pe.pf.local(rank, device, dtype)
    u_loc = torch.as_tensor(scatter_global(pe.pf, u_global)[rank],
                            dtype=real_t(dtype), device=resolve_device(device))
    return pe.interpolate(ls, u_loc)
