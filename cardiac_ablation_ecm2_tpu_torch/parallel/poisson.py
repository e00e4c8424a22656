"""Sharded Poisson solve, the ex1p slice (counterpart of
``cardiac_ablation_ecm2_tpu/parallel/poisson.py``; MFEM's
``examples/ex1p.cpp``: ParMesh partition, ParFiniteElementSpace, parallel
partial-assembly apply and CG with ``MPI_Allreduce`` inner products).

Each rank computes the geometric factors and qdata of its own element
block; the apply is L→E (``gather_sum``), the diffusion apply on packed
qdata (``fused_diffusion`` on hexes on the card), E→L (``segment_sum``)
and the halo exchange; CG's inner products are ``all_reduce``d.
Preconditioners: ``"jacobi"``, ``"chebyshev"``, ``"pmg"`` (the in-shard
p-multigrid V-cycle) and ``"lor"`` (that V-cycle with the LOR operator on
the order-p lattice as its fine level).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..fem.fespace import FESpace
from ..fem.geom_factors import compute_geometric_factors
from ..fem.geometry import DIMENSION
from ..fem.quadinterp import device_basis, eval_values_t
from ..fem.restriction import ElementRestriction
from ..linalg.smoothers import chebyshev
from ..linalg.solvers import cg
from ..ops import diffusion as dmod
from ..ops.lor import lor_corner_slots
from ..ops.lor_device import _lor_matrices
from ..utils.config import real_t, resolve_device
from . import ops as pops
from . import pmg as pmg_mod
from .pfespace import (
    LocalSpace,
    ParFESpace,
    build,
    essential_global,
    gather_to_root,
    local_ess,
    space_of,
)


@dataclasses.dataclass(eq=False)
class ParPoisson:
    """Assembled sharded Poisson solver on this rank (ex1p)."""

    pf: ParFESpace
    local: LocalSpace
    solve_fn: Callable          # () -> (x_loc, SolveInfo)
    pmg: Optional[pmg_mod.PMGContext] = None   # "pmg", "lor": coarse levels
    coarse_qdata: Optional[Callable] = None    # "pmg", "lor": their qdata_fn
    lor_restr: Optional[ElementRestriction] = None  # "lor": sub-elements

    def solve(self):
        """(u, iterations, final norm): u the global solution on rank 0,
        ``None`` elsewhere."""
        x_loc, info = self.solve_fn()
        return gather_to_root(self.pf, x_loc), info.iterations, info.final_norm


def setup(
    mesh,
    order: int = 2,
    rhs: Callable = None,
    kappa: Callable = None,
    ess_bdr: Optional[Sequence[int]] = None,
    rel_tol: float = 1e-12,
    max_iter: int = 2000,
    dtype=None,
    device=None,
    precond: str = "jacobi",      # "jacobi" | "chebyshev" | "pmg" | "lor"
    cheb_order: int = 4,
    cheb_power_iters: int = 12,
    pmg_orders: Optional[Sequence[int]] = None,   # coarse orders, coarsest 1st
    fes: Optional[FESpace] = None,
) -> ParPoisson:
    """Build this rank's part of the sharded solver; the process group
    (``launch.init``) sets the rank and the world size.  ``rhs`` and
    ``kappa`` are callables of the physical coordinates (torch) or None;
    ``device=None`` is the card.  ``fes``, the order-``order`` space of
    ``mesh`` (checked), is built when not given."""
    device = resolve_device(device)
    rank, ndev = dist.get_rank(), dist.get_world_size()
    fes = space_of(mesh, order, fes)
    pf = build(fes, ndev)
    loc = pf.local(rank, device, dtype)
    nloc = loc.nloc
    rt = real_t(dtype)
    d2q = fes.d2q
    db = device_basis(d2q, dtype, device)
    ess = local_ess(pf, essential_global(fes, ess_bdr), rank, device)
    emask = torch.ones(nloc + 1, dtype=rt, device=device).index_fill(0, ess, 0.0)
    w_el = loc.elem_weight

    gf = compute_geometric_factors(loc.node_coords, d2q, dtype, device)
    kq = None if kappa is None else kappa(gf.x).to(rt)
    qd = dmod.pack_sym(dmod.setup(gf, kq)) * w_el[None, :, None]

    def assemble(e):
        return loc.halo(pops.local_scatter(e, loc.restr, nloc))

    def A(v):
        z = v * emask
        y = assemble(dmod.apply(db, qd, loc.restr.mult(z)))
        return y * emask + (v - z)

    # RHS (f, v) with halo assembly; essential rows zero (u_bc = 0)
    fq = torch.ones_like(gf.det) if rhs is None else rhs(gf.x).to(rt)
    b = assemble(eval_values_t(db, gf.wdet * fq * w_el[:, None]))
    b = pops.zero_at(b, ess)

    # Jacobi diagonal with halo assembly
    dg = pops.masked_diagonal(assemble(dmod.diagonal(db, qd)), emask, nloc)

    pdot = pops.make_pdot(loc.dof_weight)

    def qd_fn(gf_l, li, db_l):
        kq_l = None if kappa is None else kappa(gf_l.x).to(rt)
        return None, dmod.pack_sym(dmod.setup(gf_l, kq_l)) * w_el[None, :, None]

    def fine_level(A_f, diag_f):
        return dict(A=A_f, diag=diag_f, local=loc, emask=emask, pdot=pdot)

    ctx = lor = None
    if precond == "pmg":
        ctx = pmg_mod.build_coarse_levels(
            fes, pf, pmg_orders or pmg_mod.default_orders(order), ess_bdr,
            rank, device, dtype)
        make_M = lambda: pmg_mod.inshard_vcycle(     # noqa: E731
            ctx, fine=fine_level(A, dg), qdata_fn=qd_fn,
            smoother_order=cheb_order - 1, power_iters=cheb_power_iters)
    elif precond == "lor":
        # all-device LOR-MG (fem/lor/lor_batched.hpp:34 + lor.hpp:201): the
        # rank's batched LOR element matrices (pad elements zeroed) feed a
        # V-cycle whose fine level is the LOR operator on the order-p
        # lattice and whose coarse level is order 1 on the original mesh
        if order < 2:
            raise ValueError("LOR preconditioning needs order >= 2")
        ctx = pmg_mod.build_coarse_levels(fes, pf, [1], ess_bdr, rank, device,
                                          dtype)
        slots = lor_corner_slots(mesh.geom, order)
        X = torch.as_tensor(loc.node_coords, dtype=rt, device=device)
        Ae = _lor_matrices(X, slots, mesh.geom,
                           kappa if kappa is not None else 1.0, None, rt)
        nv = Ae.shape[-1]
        nsub = order ** DIMENSION[mesh.geom]
        Ae = (Ae.view(-1, nsub, nv, nv) * w_el[:, None, None, None]).view(-1, nv, nv)
        lor = _LORLocal(loc, slots, device)

        def A_lor(v):
            z = v * emask
            y = torch.einsum("snm,sm->sn", Ae, lor.restr.mult(z))
            return lor.assemble(y) * emask + (v - z)

        d_lor = pops.masked_diagonal(
            lor.assemble(torch.diagonal(Ae, dim1=1, dim2=2).contiguous()),
            emask, nloc)
        make_M = lambda: pmg_mod.inshard_vcycle(     # noqa: E731
            ctx, fine=fine_level(A_lor, d_lor), qdata_fn=qd_fn,
            smoother_order=cheb_order - 1, power_iters=cheb_power_iters)
    elif precond == "chebyshev":
        make_M = lambda: chebyshev(                  # noqa: E731
            A, dg, order=cheb_order, dot=pdot, power_iters=cheb_power_iters,
            v0=pmg_mod.power_start(loc, rt))
    elif precond == "jacobi":
        make_M = lambda: (lambda r: r / dg)          # noqa: E731
    else:
        raise ValueError(f"unknown preconditioner {precond!r}")

    def run():
        return cg(A, b, M=make_M(), rel_tol=rel_tol, max_iter=max_iter,
                  dot=pdot)

    return ParPoisson(pf=pf, local=loc, solve_fn=run, pmg=ctx,
                      coarse_qdata=qd_fn if ctx is not None else None,
                      lor_restr=lor.restr if lor is not None else None)


class _LORLocal:
    """The rank's LOR sub-element restriction (local ids of the corner
    slots of every element) and its assembly."""

    def __init__(self, loc: LocalSpace, slots: np.ndarray, device):
        g = loc.restr.gm.cpu().numpy()
        self.restr = ElementRestriction(g[:, slots].reshape(-1, slots.shape[1]),
                                        loc.nloc + 1, device)
        self.loc = loc

    def assemble(self, e):
        return self.loc.halo(pops.local_scatter(e, self.restr, self.loc.nloc))

