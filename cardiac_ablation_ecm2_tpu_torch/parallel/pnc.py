"""Sharded nonconforming (hanging-node) Poisson (counterpart of
``cardiac_ablation_ecm2_tpu/parallel/pnc.py``; MFEM's ``ParNCMesh`` ghost
layer with the parallel conforming prolongation of ``fem/pfespace.cpp``).

The *broken* L-dof space is sharded like a conforming one, and each rank's
dof set also holds the **master dofs of its local slaves** (the ghost
layer, ``pfespace.build``'s ``extra_dofs``).  P and Pᵀ are then
rank-local: P reads the masters with the rank's (ns_loc, width)
``ElementRestriction`` (the L→E gather kernel on the card) and writes the
slave slots; Pᵀ sums the weighted slave residuals into the masters with
that map's ``segment_sum`` and zeroes the slave rows.  The ordinary halo
exchange (``ops.Halo``) then assembles PᵀAP across ranks: a Pᵀ
contribution written into a ghost master's copy rides the same exchange as
the element partial sums.  State lives in the L-representation:
conforming dofs replicated, slave slots recomputed by P on entry and
zeroed on exit.  CG's inner products are ``all_reduce``d (``make_pdot``
over the conforming dofs' multiplicity weights); NCCL on the card, gloo on
the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..fem.geom_factors import compute_geometric_factors
from ..fem.quadinterp import device_basis, eval_values_t
from ..fem.restriction import ElementRestriction
from ..linalg.solvers import cg
from ..ops import diffusion as dmod
from ..utils.config import real_t, resolve_device
from . import ops as pops
from .partition import partition_mesh
from .pfespace import ParFESpace, build, essential_global, gather_to_root, local_ess


def ghost_masters(ncsp, parts: np.ndarray, ndev: int) -> List[np.ndarray]:
    """Per rank, the global master dofs of the slaves its elements touch
    that its elements do not (the JAX package's ``extra`` of ``setup``)."""
    slave_L = ncsp.slave_idx
    masters_L = ncsp.L_of_conf[ncsp.slave_masters]
    gm = ncsp.fes.gather_map.astype(np.int64)
    extra = []
    for d in range(ndev):
        own = np.unique(gm[parts == d].reshape(-1))
        has = np.isin(slave_L, own)
        need = np.unique(masters_L[has].reshape(-1))
        extra.append(np.setdiff1d(need, own))
    return extra


def _local_ids(g_sorted: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Global ids → local slots of the rank's sorted dof list; raise on a
    missing one."""
    pos = np.clip(np.searchsorted(g_sorted, want), 0, max(len(g_sorted) - 1, 0))
    if not len(g_sorted) or (g_sorted[pos] != want).any():
        raise RuntimeError("NC masters missing from the rank's ghost layer")
    return pos


@dataclasses.dataclass(eq=False)
class ParNCPoisson:
    """Assembled sharded NC Poisson solver on this rank."""

    pf: ParFESpace
    ncsp: object
    solve_fn: Callable          # () -> (x_loc, SolveInfo)
    restr: Optional[ElementRestriction]   # the rank's (ns_loc, width) master map

    def solve(self):
        """(u, iterations, final norm): u the conforming solution on rank 0,
        ``None`` elsewhere."""
        x_loc, info = self.solve_fn()
        uL = gather_to_root(self.pf, x_loc)
        uc = None if uL is None else uL[self.ncsp.L_of_conf]
        return uc, info.iterations, info.final_norm


def setup(
    ncsp,
    rhs: Callable = None,
    ess_bdr: Optional[Sequence[int]] = None,
    rel_tol: float = 1e-12,
    max_iter: int = 3000,
    dtype=None,
    device=None,
) -> ParNCPoisson:
    """This rank's part of the sharded NC Poisson solve (ex6p-class):
    −∇·∇u = f with hanging-node constraints and homogeneous essential BCs
    on ``ess_bdr`` (None = all), Jacobi-PCG.  The process group
    (``launch.init``) sets the rank and the world size; ``rhs`` is a
    callable of the physical coordinates (torch) or None (f = 1);
    ``device=None`` is the card."""
    device = resolve_device(device)
    rank, ndev = dist.get_rank(), dist.get_world_size()
    rt = real_t(dtype)
    fes = ncsp.fes
    parts = partition_mesh(fes.mesh, ndev)
    pf = build(fes, ndev, parts, extra_dofs=ghost_masters(ncsp, parts, ndev))
    loc = pf.local(rank, device, dtype)
    nloc = loc.nloc

    # this rank's constraint rows: slaves it holds, their masters' slots
    slave_L = ncsp.slave_idx
    masters_L = ncsp.L_of_conf[ncsp.master_map]
    g = pf.loc2glob[rank]
    g = g[g >= 0]
    r = np.nonzero(np.isin(slave_L, g))[0]
    si = torch.as_tensor(_local_ids(g, slave_L[r]), device=device)
    restr = None
    if len(r):
        mi = _local_ids(g, masters_L[r].reshape(-1)).reshape(len(r), -1)
        restr = ElementRestriction(mi, nloc + 1, device)
    sw = torch.as_tensor(ncsp.slave_w[r], dtype=rt, device=device)

    # 1 on conforming local dofs, 0 on slaves, pads and the trash slot
    conf = np.zeros(nloc + 1)
    conf[: len(g)] = np.isin(g, ncsp.L_of_conf)
    cm = torch.as_tensor(conf, dtype=rt, device=device)

    def Pro(v):
        if restr is None:
            return v
        sv = (restr.mult(v) * sw).sum(dim=1)
        v = v.index_copy(0, si, sv)
        v[nloc] = 0.0
        return v

    def ProT(y):
        if restr is not None:
            y = y + restr.mult_transpose(y.index_select(0, si)[:, None] * sw)
        y = y * cm            # slave rows fold away
        y[nloc] = 0.0
        return y

    ess = local_ess(pf, essential_global(fes, ess_bdr), rank, device)
    emask = torch.ones(nloc + 1, dtype=rt, device=device).index_fill(0, ess, 0.0)
    emask = emask * cm        # solve on the conforming dofs
    emask[nloc] = 0.0

    d2q = fes.d2q
    db = device_basis(d2q, dtype, device)
    w_el = loc.elem_weight
    gf = compute_geometric_factors(loc.node_coords, d2q, dtype, device)
    qd = dmod.pack_sym(dmod.setup(gf, None)) * w_el[None, :, None]

    def assemble(e):
        return loc.halo(ProT(pops.local_scatter(e, loc.restr, nloc)))

    def A(v):
        z = Pro(v * emask)
        y = assemble(dmod.apply(db, qd, loc.restr.mult(z)))
        return y * emask + (v - v * emask)

    fq = torch.ones_like(gf.det) if rhs is None else rhs(gf.x).to(rt)
    b = assemble(eval_values_t(db, gf.wdet * fq * w_el[:, None])) * emask

    # Jacobi diagonal of PᵀAP (diagonal-block approximation): element
    # diagonals scattered, slave rows folded with w² into their masters
    dg = pops.local_scatter(dmod.diagonal(db, qd), loc.restr, nloc)
    dfold = dg * cm
    if restr is not None:
        dfold = dfold + restr.mult_transpose(dg.index_select(0, si)[:, None] * sw * sw)
    dfold[nloc] = 0.0
    dg = loc.halo(dfold)
    dg = dg * emask + (1.0 - emask)
    dg = torch.where(dg == 0.0, 1.0, dg)

    pdot = pops.make_pdot(loc.dof_weight * cm)

    def run():
        return cg(A, b, M=lambda r_: r_ / dg, rel_tol=rel_tol,
                  max_iter=max_iter, dot=pdot)

    return ParNCPoisson(pf=pf, ncsp=ncsp, solve_fn=run, restr=restr)
