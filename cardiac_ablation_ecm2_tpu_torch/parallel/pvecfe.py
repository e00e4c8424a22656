"""Sharded H(curl)/H(div) solves, the ex3p/ex4p slice (counterpart of
``cardiac_ablation_ecm2_tpu/parallel/pvecfe.py``; MFEM's ND/RT
``ParFiniteElementSpace`` with a parallel partial-assembly apply and PCG).

The canonical dof numbering makes a vector space shard exactly as H1: its
dof values do not depend on the element, so the halo exchange is the same
symmetric partial-sum schedule (``pfespace.build`` on the space's gather
map).  Each rank gets the ``ElementRestriction`` of its elements into
nloc + 1 dofs (``ParFESpace.local``), and the orientation (±1 signs or the
simplex DofTransformation blocks of its elements) is applied inside the
rank-local gather and scatter, never across ranks.  The rank's geometry
and basis tables are built for its own elements (``ops/vecfe.nd_terms`` /
``rt_terms``); padded elements carry zero weights.  CG's inner products
are ``make_pdot``'s all-reduced weighted dots.

``precond="ams"`` (ND₁): the in-shard auxiliary-space preconditioner.
Every transfer is element-mediated: per-element values through the rank's
restriction, the local ``segment_sum``, the halo sum and 1/(global
multiplicity); the auxiliary H1 solves are Chebyshev sweeps on dense
order-1 element matrices whose eigenvalue bounds are host power
iterations on the assembled operators (the JAX package's ``_ams_tables``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..fem.build import geom_factors_for
from ..fem.fespace import FESpace
from ..fem.geometry import EDGES
from ..linalg.smoothers import chebyshev
from ..linalg.solvers import cg
from ..ops import diffusion as diff_mod
from ..ops import mass as mass_mod
from ..ops.mixed_vecfe import _kind
from ..ops.vecfe import (
    apply_terms,
    element_diagonal,
    eval_basis_t,
    host_points,
    nd_terms,
    rt_terms,
    vertex_dof_positions,
)
from ..utils.config import real_t, resolve_device
from . import ops as pops
from .pfespace import build, gather_to_root, local_ess


class _Shim:
    """The FESpace view of a vector space that ``pfespace.build`` reads:
    the canonical gather map, the mesh and the geometry order."""

    def __init__(self, space):
        self.mesh = space.mesh
        self.gather_map = np.asarray(space.gather_map)
        self.ndof_scalar = space.ndof
        self.order = 1


@dataclasses.dataclass(eq=False)
class ParVecFE:
    """This rank's part of a sharded vector-FE solve."""

    pf: object
    local: object
    solve_fn: Callable          # () -> (x_loc, SolveInfo)
    ams: Optional[dict] = None  # the in-shard AMS's restrictions and bounds

    def solve(self):
        """(u, iterations, final norm): u the global solution on rank 0,
        ``None`` elsewhere."""
        x_loc, info = self.solve_fn()
        return gather_to_root(self.pf, x_loc), info.iterations, info.final_norm


def _h1_element_matrices(h1, alpha, beta):
    """Dense order-1 H1 element matrices (host float64): the gradient
    auxiliary's β-stiffness and the Π auxiliary's α-stiffness + β-mass."""
    gf = geom_factors_for(h1, None, "float64", "cpu")
    d2q = h1.dof_to_quad(None)
    B, G = (torch.as_tensor(a) for a in (d2q.full_B(), d2q.full_G()))
    stiff = torch.einsum("qma,eqab,qnb->emn", G, diff_mod.setup(gf), G).numpy()
    massm = torch.einsum("qm,eq,qn->emn", B, mass_mod.setup(gf), B).numpy()
    return beta * stiff, alpha * stiff + beta * massm


def _assembled_diag_and_lmax(h1, Ae, mask):
    """The assembled diagonal of ``Ae`` and the host power estimate (25
    steps from a seeded start) of λ_max(D⁻¹A) on the masked operator."""
    import scipy.sparse as sp

    gm = h1.gather_map.astype(np.int64)
    ne, nd = gm.shape
    dg = np.zeros(h1.ndof_scalar)
    np.add.at(dg, gm.reshape(-1), np.einsum("enn->en", Ae).reshape(-1))
    rows = np.repeat(gm, nd, axis=1).reshape(-1)
    cols = np.tile(gm, (1, nd)).reshape(-1)
    A = sp.coo_matrix((Ae.reshape(-1), (rows, cols)), shape=(h1.ndof_scalar,) * 2).tocsr()
    dgm = dg * mask + (1 - mask)
    v = np.random.default_rng(0).standard_normal(h1.ndof_scalar)
    lam = 1.0
    for _ in range(25):
        v = mask * (A @ (mask * v)) / dgm
        lam = np.linalg.norm(v)
        v = v / lam
    return dgm, float(lam)


def _local_rows(pf, glob, rank):
    """The rank's (nloc + 1,) row of a global vector (trash slot 0)."""
    out = np.zeros(pf.nloc + 1)
    g = pf.loc2glob[rank]
    real = g >= 0
    out[: pf.nloc][real] = glob[g[real]]
    return out


def _inshard_ams(space, pf, loc, rank, sg_l, emask_nd, dg_nd, alpha, beta, ess_bdr,
                 rt, device):
    """The in-shard AMS preconditioner of this rank and its tables."""
    mesh = space.mesh
    h1 = FESpace(mesh, 1)
    pf_h1 = build(h1, pf.ndev, parts=pf.parts)
    loc_h1 = pf_h1.local(rank, device, rt)
    nloc_h1 = loc_h1.nloc
    dofpos = vertex_dof_positions(mesh)
    le = np.array(EDGES[mesh.geom])
    ua, ub = dofpos[le[:, 0]], dofpos[le[:, 1]]
    nd_h1 = h1.gather_map.shape[1]
    # per-element incidence of the local edges on the local vertex dofs
    Pa, Pb = np.zeros((len(le), nd_h1)), np.zeros((len(le), nd_h1))
    Pa[np.arange(len(le)), ua] = 1.0
    Pb[np.arange(len(le)), ub] = 1.0
    dvt = torch.as_tensor(Pb - Pa, dtype=rt, device=device)        # G's rows
    svt = torch.as_tensor(Pa + Pb, dtype=rt, device=device)        # Π's rows
    ua_t = torch.as_tensor(ua, device=device)
    ub_t = torch.as_tensor(ub, device=device)

    elems = pf.elems[rank]
    ew = loc.elem_weight
    ev = mesh.elements[:, le]
    lo, hi = np.minimum(ev[..., 0], ev[..., 1]), np.maximum(ev[..., 0], ev[..., 1])
    tvec = mesh.vertices[hi] - mesh.vertices[lo]                  # (ne, nle, dim)
    tv = torch.as_tensor(tvec[elems], dtype=rt, device=device) * ew[:, None, None]

    cnt = np.bincount(np.asarray(space.gather_map).reshape(-1),
                      minlength=space.ndof).astype(np.float64)
    minv = torch.as_tensor(_local_rows(pf, 1.0 / cnt, rank), dtype=rt, device=device)
    minv_m = minv * emask_nd

    Ae_grad, Ae_pi = _h1_element_matrices(h1, alpha, beta)
    ess_h1 = (h1.essential_dofs(ess_bdr) if ess_bdr is not None
              else np.zeros(0, np.int32))
    mask_h1 = np.ones(h1.ndof_scalar)
    mask_h1[ess_h1] = 0.0
    dgg, lmax_grad = _assembled_diag_and_lmax(h1, Ae_grad, mask_h1)
    dgp, lmax_pi = _assembled_diag_and_lmax(h1, Ae_pi, mask_h1)

    def local_diag(glob):
        d = _local_rows(pf_h1, glob, rank)
        return torch.as_tensor(np.where(d == 0.0, 1.0, d), dtype=rt, device=device)

    def local_mats(Ae):
        return torch.as_tensor(Ae[elems], dtype=rt, device=device) * ew[:, None, None]

    Aeg, Aep = local_mats(Ae_grad), local_mats(Ae_pi)
    em_h1 = torch.ones(nloc_h1 + 1, dtype=rt, device=device).index_fill(
        0, local_ess(pf_h1, ess_h1, rank, device), 0.0)
    em_h1[nloc_h1] = 0.0
    r_h1, r_nd = loc_h1.restr, loc.restr

    def h1_collect(y_e):
        return loc_h1.halo(pops.local_scatter(y_e, r_h1, nloc_h1)) * em_h1

    def nd_collect(val):
        return minv_m * loc.halo(pops.local_scatter(val, r_nd, loc.nloc))

    def h1_op(Ae):
        def A(w):
            z = w * em_h1
            y_e = torch.bmm(Ae, r_h1.mult(z).unsqueeze(-1)).squeeze(-1)
            y = loc_h1.halo(pops.local_scatter(y_e, r_h1, nloc_h1))
            return y * em_h1 + (w - z)

        return A

    ew2 = ew[:, None]

    def G(u):
        e = r_h1.mult(u * em_h1)
        return nd_collect(sg_l * (e.index_select(1, ub_t) - e.index_select(1, ua_t)) * ew2)

    def GT(y):
        z = r_nd.mult(minv_m * y) * sg_l * ew2
        return h1_collect(z @ dvt)

    def Pi(w, d):
        e = r_h1.mult(w * em_h1)
        return nd_collect(0.5 * (e.index_select(1, ua_t) + e.index_select(1, ub_t))
                          * tv[:, :, d] * ew2)

    def PiT(y, d):
        z = 0.5 * r_nd.mult(minv_m * y) * tv[:, :, d] * ew2
        return h1_collect(z @ svt)

    cheb_g = chebyshev(h1_op(Aeg), local_diag(dgg), order=3, eig_max=lmax_grad)
    cheb_p = chebyshev(h1_op(Aep), local_diag(dgp), order=3, eig_max=lmax_pi)
    dim = mesh.dim

    def M(r):
        x = r / dg_nd
        x = x + G(cheb_g(GT(r)))
        for d in range(dim):
            x = x + Pi(cheb_p(PiT(r, d)), d)
        return x

    return M, dict(h1_restr=r_h1, lmax_grad=lmax_grad, lmax_pi=lmax_pi)


def setup(space, mass_coeff=1.0, curlcurl_coeff=None, divdiv_coeff=None,
          rhs_fn: Callable = None, ess_bdr: Optional[Sequence[int]] = None,
          nq1d: int = 3, rel_tol: float = 1e-10, max_iter: int = 3000, dtype=None,
          device=None, precond: str = "jacobi") -> ParVecFE:
    """This rank's part of the sharded α(u,v) + β(curl u, curl v) (ND) or
    α(u,v) + β(div u, div v) (RT) solve with the (f, v) right-hand side
    (``rhs_fn`` of host numpy points; ones when None) and homogeneous
    essential trace BCs; the process group (``launch.init``) sets the rank
    and world; ``device=None`` is the card."""
    device = resolve_device(device)
    rank, ndev = dist.get_rank(), dist.get_world_size()
    rt = real_t(dtype)
    nd_kind = _kind(space) == "nd"
    pf = build(_Shim(space), ndev)
    loc = pf.local(rank, device, rt)
    nloc = loc.nloc
    elems = pf.elems[rank]
    ew = loc.elem_weight

    if nd_kind:
        terms, gf = nd_terms(space, mass_coeff, curlcurl_coeff, nq1d, rt, device, elems)
    else:
        terms, gf = rt_terms(space, mass_coeff, divdiv_coeff, nq1d, rt, device, elems)
    terms = [(qd * ew.view((-1,) + (1,) * (qd.dim() - 1)), B) for _, qd, B in terms]

    simplex = hasattr(space, "transform")
    if simplex:
        blocks = space.blocks(device, rt, elems)

        def pre(e):
            return space.apply_blocks(e, blocks, False)

        def post(y):
            return space.apply_blocks(y, blocks, True)
        sg_l = None
    else:
        sg_l = torch.as_tensor(space.signs[elems], dtype=rt, device=device)

        def pre(e):
            return e * sg_l
        post = pre

    def assemble(y_e):
        return loc.halo(pops.local_scatter(post(y_e).contiguous(), loc.restr, nloc))

    ess_global = (space.essential_dofs(ess_bdr) if ess_bdr is not None
                  else np.zeros(0, np.int32))
    ess = local_ess(pf, ess_global, rank, device)
    emask = torch.ones(nloc + 1, dtype=rt, device=device).index_fill(0, ess, 0.0)

    def A(v):
        z = v * emask
        return assemble(apply_terms(terms, pre(loc.restr.mult(z)))) * emask + (v - z)

    # the (f, φ) right-hand side and the Jacobi diagonal, halo-assembled
    _, Bm = terms[0]
    if rhs_fn is not None:
        f = torch.as_tensor(rhs_fn(host_points(gf)), dtype=rt, device=device)
        b = assemble(eval_basis_t(Bm, gf.wdet[..., None] * f * ew[:, None, None]))
    else:                                 # ones at every real dof
        b = (loc.dof_weight > 0).to(rt)
    if simplex:
        # the canonical diagonal of Tᵀ A_e T from the element matrices
        T = torch.as_tensor(space.dense_transform()[elems], dtype=rt, device=device)
        d = element_diagonal(terms, T=T)
    else:
        d = element_diagonal(terms, signs=sg_l)
    dg = loc.halo(pops.local_scatter(d.contiguous(), loc.restr, nloc))
    b = pops.zero_at(b * emask, ess)
    dg = pops.masked_diagonal(dg, emask, nloc)
    pdot = pops.make_pdot(loc.dof_weight)

    ams = None
    if precond == "ams":
        if simplex or not nd_kind or getattr(space, "kind", None) is not None:
            raise NotImplementedError("sharded AMS: lowest-order ND (NDSpace) only")
        M, ams = _inshard_ams(space, pf, loc, rank, sg_l, emask, dg,
                              curlcurl_coeff if curlcurl_coeff else 1.0,
                              mass_coeff if mass_coeff else 1.0, ess_bdr, rt, device)
    elif precond == "jacobi":
        def M(r):
            return r / dg
    else:
        raise ValueError(f"unknown preconditioner {precond!r}")

    def run():
        return cg(A, b, M=M, rel_tol=rel_tol, max_iter=max_iter, dot=pdot)

    return ParVecFE(pf=pf, local=loc, solve_fn=run, ams=ams)
