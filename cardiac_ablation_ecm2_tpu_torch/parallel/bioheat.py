"""Sharded Pennes bioheat stepping (counterpart of
``cardiac_ablation_ecm2_tpu/parallel/bioheat.py``): BASELINE config 5, the
cardiac mesh split over ranks with halo exchange (MFEM's ex16p/joule time
loop on a ParMesh).

Each rank sets up the qdata, right-hand side and diagonals of its own
element block (no O(global) array on any one device), then takes implicit
SDIRK steps: stage PCG solves whose apply is L→E (``gather_sum``), the mass
apply plus the diffusion apply on packed qdata (``fused_diffusion`` on
hexes on the card; the einsum chain on tets), E→L (``segment_sum``) and the
halo exchange, with ``all_reduce``d inner products.  Preconditioners:
``"jacobi"``, ``"chebyshev"`` and ``"pmg"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..fem.fespace import FESpace
from ..fem.geom_factors import compute_geometric_factors
from ..fem.quadinterp import DeviceBasis, device_basis, eval_values_t
from ..linalg.smoothers import chebyshev
from ..linalg.solvers import cg
from ..ops import diffusion as dmod
from ..ops import mass as mmod
from ..utils.config import elapsed, real_t, resolve_device
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
class ParBioheat:
    """This rank's part of the sharded bioheat stepper."""

    pf: ParFESpace
    local: LocalSpace
    step: Callable            # (T_loc, t, dt) -> (T_loc, t)
    T0: torch.Tensor          # the rank's initial state (nloc+1,)
    cg_iterations: List[int]  # CG iterations of every stage solve
    db: DeviceBasis           # the operator basis
    K_qd: torch.Tensor        # packed stiffness qdata, element weights in
    setup_seconds: dict       # "tables": host tables and the restriction;
                              # "device": the rest of the setup
    pmg: Optional[pmg_mod.PMGContext]   # "pmg": the coarse levels
    coarse_qdata: Optional[Callable]    # "pmg": γ -> the V-cycle's qdata_fn

    def gather(self, T_loc) -> Optional[np.ndarray]:
        """The global L-vector on rank 0 (``None`` elsewhere)."""
        return gather_to_root(self.pf, T_loc)


def setup(
    mesh,
    order: int = 2,
    rho_c: float = 3.6e6,
    k: float = 0.54,
    w_cb: float = 20000.0,
    T_a: float = 37.0,
    q_src: Optional[Callable] = None,     # Q_met + Q_rf as f(x) [W/m³]
    ess_bdr: Optional[Sequence[int]] = None,
    solver: str = "sdirk33",
    rel_tol: float = 1e-10,
    max_iter: int = 500,
    dtype=None,
    device=None,
    precond: str = "jacobi",      # "jacobi" | "chebyshev" | "pmg"
    cheb_order: int = 4,
    cheb_power_iters: int = 12,
    pmg_orders: Optional[Sequence[int]] = None,
    fes: Optional[FESpace] = None,
) -> ParBioheat:
    """Set up this rank's part; the process group (``launch.init``) sets
    the rank and the world size.  ``q_src`` is a callable of the physical
    coordinates (torch); ``device=None`` is the card.  ``fes``, the
    order-``order`` space of ``mesh`` (checked), is built when not given."""
    device = resolve_device(device)
    rank, ndev = dist.get_rank(), dist.get_world_size()
    fes = space_of(mesh, order, fes)
    t0 = time.perf_counter()
    pf = build(fes, ndev)
    loc = pf.local(rank, device, dtype)
    seconds = dict(tables=elapsed(t0, device))
    t1 = time.perf_counter()
    nloc = loc.nloc
    d2q = fes.d2q
    db = device_basis(d2q, dtype, device)
    rt = real_t(dtype)
    ess_bdr = list(ess_bdr) if ess_bdr else []
    ess = local_ess(pf, essential_global(fes, ess_bdr), rank, device)
    w_el = loc.elem_weight

    def assemble(e):
        return loc.halo(pops.local_scatter(e, loc.restr, nloc))

    # ---------------- rank-local one-shot setup -----------------------
    gf = compute_geometric_factors(loc.node_coords, d2q, dtype, device)
    wm = w_el[:, None]
    qd_mrc = mmod.setup(gf) * rho_c * wm
    qd_mw = mmod.setup(gf) * w_cb * wm
    qd_k = dmod.pack_sym(dmod.setup(gf)) * k * w_el[None, :, None]
    # constant rhs: M_ω T_a 1 + (q_src, v)
    q = qd_mw * T_a
    if q_src is not None:
        q = q + gf.wdet * q_src(gf.x).to(rt) * wm
    b_const = pops.zero_at(assemble(eval_values_t(db, q)), ess)
    dM = assemble(mmod.diagonal(db, qd_mrc))
    dA = assemble(dmod.diagonal(db, qd_k) + mmod.diagonal(db, qd_mw))
    del gf, q

    pmg_ctx = coarse_qdata = None
    if precond == "pmg":
        pmg_ctx = pmg_mod.build_coarse_levels(
            fes, pf, pmg_orders or pmg_mod.default_orders(order), ess_bdr,
            rank, device, dtype)

        def coarse_qdata(gamma):
            """The coarse operators' qdata of the stage solve at γ."""
            def qd_fn(gf_l, li, db_l):
                qm = mmod.setup(gf_l) * (rho_c + gamma * w_cb) * wm
                qdf = dmod.pack_sym(dmod.setup(gf_l)) * (gamma * k) * w_el[None, :, None]
                return qm, qdf

            return qd_fn
    elif precond not in ("jacobi", "chebyshev"):
        raise ValueError(f"unknown preconditioner {precond!r}")

    # one scatter builds the mask; the CG loop then multiplies
    emask = torch.ones(nloc + 1, dtype=rt, device=device).index_fill(0, ess, 0.0)
    pdot = pops.make_pdot(loc.dof_weight)
    g2l_start = pmg_mod.power_start(loc, rt)
    cg_iterations: List[int] = []
    seconds["device"] = elapsed(t1, device)

    def Aop(v):
        e = loc.restr.mult(v)
        return assemble(mmod.apply(db, qd_mw, e) + dmod.apply(db, qd_k, e))

    def Mrc(v):
        return assemble(mmod.apply(db, qd_mrc, loc.restr.mult(v)))

    def implicit_solve(gamma, Tval):
        rhs = (b_const - Aop(Tval)) * emask

        def lhs(v):
            z = v * emask
            y = (Mrc(z) + gamma * Aop(z)) * emask
            return y + (v - z)

        dg = pops.masked_diagonal(dM + gamma * dA, emask, nloc)
        if precond == "pmg":
            M = pmg_mod.inshard_vcycle(
                pmg_ctx, fine=dict(A=lhs, diag=dg, local=loc, emask=emask,
                                   pdot=pdot),
                qdata_fn=coarse_qdata(gamma), smoother_order=cheb_order - 1,
                power_iters=cheb_power_iters)
        elif precond == "chebyshev":
            M = chebyshev(lhs, dg, order=cheb_order, dot=pdot,
                          power_iters=cheb_power_iters, v0=g2l_start)
        else:
            M = lambda r: r / dg          # noqa: E731
        x, info = cg(lhs, rhs, M=M, rel_tol=rel_tol, max_iter=max_iter,
                     dot=pdot)
        cg_iterations.append(info.iterations)
        return x * emask

    T0 = torch.full((nloc + 1,), T_a, dtype=rt, device=device)
    T0[nloc] = 0.0
    return ParBioheat(pf=pf, local=loc,
                      step=pops.rk_stepper(solver, implicit_solve), T0=T0,
                      cg_iterations=cg_iterations, db=db, K_qd=qd_k,
                      setup_seconds=seconds, pmg=pmg_ctx,
                      coarse_qdata=coarse_qdata)
