"""Sharded p-multigrid V-cycle (counterpart of
``cardiac_ablation_ecm2_tpu/parallel/pmg.py``; MFEM's ``Multigrid`` over a
``FiniteElementSpaceHierarchy`` with ``PRefinementTransferOperator``, used
as a parallel preconditioner the way ex26p uses GeometricMultigrid).

Every level shares the fine level's element partition, so the order
transfer is element-local (one interpolation contraction) followed by the
level's own E→L sum and halo exchange; each coarse level is a
``ParFESpace`` on the same parts with its own ``LocalSpace`` (restriction
and ``Halo``).  The host builds the coarse tables
(:func:`build_coarse_levels`); :func:`inshard_vcycle` wires
Chebyshev-smoothed levels into a V-cycle closure usable as the CG
preconditioner ``M`` on this rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from ..fem.fespace import FESpace
from ..fem.geom_factors import GeometricFactors, compute_geometric_factors
from ..fem.quadinterp import DeviceBasis, device_basis, eval_values, eval_values_t
from ..fem.transfer import _interp_db
from ..linalg.smoothers import chebyshev
from ..linalg.solvers import cg
from ..ops import diffusion as dmod
from ..ops import mass as mmod
from . import ops as pops
from .pfespace import LocalSpace, ParFESpace, build, essential_global, local_ess


@dataclasses.dataclass(eq=False)
class PMGLevel:
    """One coarse level, this rank's row on its device."""

    pf: ParFESpace
    local: LocalSpace
    ess: torch.Tensor            # (m,) local essential dofs (pad → nloc)
    db: DeviceBasis              # operator basis (order p_l quadrature)
    interp: Optional[DeviceBasis]  # THIS level's nodes ← next-coarser basis
    gf: GeometricFactors         # the level's geometric factors


@dataclasses.dataclass(eq=False)
class PMGContext:
    """Coarse levels (coarsest first) below an externally owned fine level."""

    levels: List[PMGLevel]
    interp_fine: DeviceBasis     # fine nodes ← levels[-1] basis
    orders: Sequence[int]


def default_orders(order: int) -> List[int]:
    """Coarse orders below ``order``, coarsest first: halving down to 1."""
    orders = []
    p = order // 2
    while p >= 1:
        orders.insert(0, p)
        p //= 2
    return orders or [1]


def build_coarse_levels(
    fine_fes: FESpace,
    fine_pf: ParFESpace,
    orders: Sequence[int],
    ess_bdr,
    rank: int,
    device,
    dtype=None,
) -> PMGContext:
    """Coarse-level tables under the fine level's element partition, and
    this rank's row of each.  ``orders`` lists the coarse orders coarsest
    first (not the fine order), e.g. ``(1,)`` for two levels at p = 2."""
    mesh = fine_fes.mesh
    geom = mesh.geom
    levels: List[PMGLevel] = []
    prev_order: Optional[int] = None
    for p in orders:
        fes = FESpace(mesh, p)
        pf = build(fes, fine_pf.ndev, parts=fine_pf.parts)
        loc = pf.local(rank, device, dtype)
        levels.append(PMGLevel(
            pf=pf, local=loc,
            ess=local_ess(pf, essential_global(fes, ess_bdr), rank, device),
            db=device_basis(fes.d2q, dtype, device),
            interp=(_interp_db(geom, prev_order, p, dtype, device)
                    if prev_order is not None else None),
            gf=compute_geometric_factors(loc.node_coords, fes.d2q, dtype,
                                         device),
        ))
        prev_order = p
    return PMGContext(levels=levels,
                      interp_fine=_interp_db(geom, orders[-1], fine_fes.order,
                                             dtype, device),
                      orders=tuple(orders))


def assembler(loc: LocalSpace) -> Callable:
    """E-vector → assembled local L-vector: E→L sum, then halo."""

    def assemble(e):
        return loc.halo(pops.local_scatter(e, loc.restr, loc.nloc))

    return assemble


def power_start(loc: LocalSpace, dtype) -> torch.Tensor:
    """The halo-consistent deterministic start of a sharded power
    iteration: sin(0.7 + 1.61803·global id), 0 at pads and the trash
    slot."""
    v0 = torch.sin(0.7 + 1.61803 * loc.loc2glob.to(dtype))
    v0[loc.nloc] = 0.0
    return v0 * (loc.dof_weight > 0).to(dtype)


def inverse_multiplicity(assemble, w_el, shape, dtype) -> torch.Tensor:
    """1 / (assembled count of real elements at each dof), 0 where none."""
    mult = assemble(w_el[:, None] * torch.ones(shape, dtype=dtype,
                                               device=w_el.device))
    return torch.where(mult > 0, 1.0 / torch.where(mult == 0, 1.0, mult), 0.0)


def inshard_vcycle(
    ctx: PMGContext,
    *,
    fine: dict,
    qdata_fn: Callable,
    smoother_order: int = 3,
    power_iters: int = 12,
    coarse_iters: int = 32,
    coarse_tol: float = 1e-8,
):
    """The V-cycle preconditioner closure on this rank.

    ``fine`` supplies the fine level: ``{A, diag, local, emask, pdot}`` and
    optionally ``smoother``; ``local`` is the fine ``LocalSpace``.
    ``qdata_fn(gf, level_index, db)`` returns ``(qd_mass, qd_diff)`` for the
    coarse operator at that level (either may be None, the diffusion qdata
    packed), with the element pad weights folded in.
    """
    rt = fine["diag"].dtype
    f_loc = fine["local"]
    # pad-element weights (the same partition on every level): padded slots
    # repeat element 0, so unweighted transfer sums would count it twice
    w_el = f_loc.elem_weight.to(rt)

    # ---- per-coarse-level local ops ------------------------------------
    coarse = []
    for li, lv in enumerate(ctx.levels):
        loc = lv.local
        nloc = loc.nloc
        emask = torch.ones(nloc + 1, dtype=rt, device=w_el.device)
        emask = emask.index_fill(0, lv.ess, 0.0)
        emask[nloc] = 0.0
        assemble = assembler(loc)
        qd_mass, qd_diff = qdata_fn(lv.gf, li, lv.db)

        def A(v, loc=loc, db=lv.db, qm=qd_mass, qdf=qd_diff,
              assemble=assemble, emask=emask):
            z = v * emask
            e = loc.restr.mult(z)
            out = None
            if qdf is not None:
                out = dmod.apply(db, qdf, e)
            if qm is not None:
                y = mmod.apply(db, qm, e)
                out = y if out is None else out + y
            return assemble(out) * emask + (v - z)

        d_e = None
        if qd_diff is not None:
            d_e = dmod.diagonal(lv.db, qd_diff)
        if qd_mass is not None:
            dm = mmod.diagonal(lv.db, qd_mass)
            d_e = dm if d_e is None else d_e + dm
        dg = pops.masked_diagonal(assemble(d_e), emask, nloc)

        pdot = pops.make_pdot(loc.dof_weight)
        sm = chebyshev(A, dg, order=smoother_order, dot=pdot,
                       power_iters=power_iters, v0=power_start(loc, rt))
        coarse.append(dict(A=A, diag=dg, smoother=sm, pdot=pdot,
                           restr=loc.restr, assemble=assemble, emask=emask,
                           inv_mult=inverse_multiplicity(
                               assemble, w_el, loc.restr.gm.shape, rt),
                           interp=lv.interp))

    # ---- fine level -----------------------------------------------------
    f_assemble = assembler(f_loc)
    f_A = fine["A"]
    f_sm = fine.get("smoother")
    if f_sm is None:
        f_sm = chebyshev(f_A, fine["diag"], order=smoother_order,
                         dot=fine["pdot"], power_iters=power_iters,
                         v0=power_start(f_loc, rt))
    f_inv_mult = inverse_multiplicity(f_assemble, w_el, f_loc.restr.gm.shape, rt)

    # ---- transfers (pad elements weighted out on the summing side) -------
    def prolong_to_fine(uc):
        e = eval_values(ctx.interp_fine, coarse[-1]["restr"].mult(uc))
        return f_inv_mult * f_assemble(w_el[:, None] * e)

    def restrict_from_fine(rf):
        e = eval_values_t(ctx.interp_fine, f_loc.restr.mult(f_inv_mult * rf))
        return coarse[-1]["assemble"](w_el[:, None] * e)

    def prolong(li, uc):
        """coarse level li-1 → li."""
        lvl = coarse[li]
        e = eval_values(lvl["interp"], coarse[li - 1]["restr"].mult(uc))
        return lvl["inv_mult"] * lvl["assemble"](w_el[:, None] * e)

    def restrict(li, rf):
        """coarse level li → li-1."""
        lvl = coarse[li]
        e = eval_values_t(lvl["interp"], lvl["restr"].mult(lvl["inv_mult"] * rf))
        return coarse[li - 1]["assemble"](w_el[:, None] * e)

    # ---- V-cycle ---------------------------------------------------------
    def coarse_solve(b):
        lvl = coarse[0]
        x, _ = cg(lvl["A"], b, M=lambda r: r / lvl["diag"],
                  rel_tol=coarse_tol, max_iter=coarse_iters, dot=lvl["pdot"])
        return x

    def v_coarse(b, li):
        if li == 0:
            return coarse_solve(b)
        lvl = coarse[li]
        x = lvl["smoother"](b)
        r = b - lvl["A"](x)
        rc = restrict(li, r) * coarse[li - 1]["emask"]
        x = x + prolong(li, v_coarse(rc, li - 1))
        return x + lvl["smoother"](b - lvl["A"](x))

    def M(b):
        x = f_sm(b)
        r = b - f_A(x)
        rc = restrict_from_fine(r) * coarse[-1]["emask"]
        x = x + prolong_to_fine(v_coarse(rc, len(coarse) - 1))
        return x + f_sm(b - f_A(x))

    return M
