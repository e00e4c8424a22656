"""Sharded DG: upwind advection and SIPG diffusion with a ghost-face
exchange (counterpart of ``cardiac_ablation_ecm2_tpu/parallel/dg.py``;
MFEM's ``ParMesh::ExchangeFaceNbrData`` and ``ParL2FaceRestriction``
feeding ex9p and ex14p).

L2 spaces share no dofs, so the only communication is face traces.  Every
rank classifies the interior faces (elements split by RCB, as the JAX
package's) into its own and cross faces, and colours the rank pairs of the
cross faces greedily (``_edge_color``, the JAX package's schedule).  Each
apply, a rank evaluates its side's trace (values, and for SIPG the normal
derivatives) at the face points of its cross faces, swaps them with its
partner of each colour in one ``batch_isend_irecv`` (the JAX package's
``lax.ppermute`` per colour), forms the fluxes from (own, received) traces
and sums into its own elements only.  As in the serial operators, face
reads are ``take_rows`` and the volume term and every face term go into
the elements in one ``segment_sum`` (``ops/face_sum.py``).  Inner products
end in one ``all_reduce``.

The functions here run inside a rank (``parallel/launch``): ``setup`` and
``setup_sipg`` take the rank and world size from the process group.  At
world size 1 every face is the rank's own and the applies equal the
serial operators' bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..fem.build import face_data_for
from ..fem.fespace import element_node_coords
from ..fem.geom_factors import compute_geometric_factors
from ..fem.quadinterp import device_basis, eval_grad_t, eval_values, eval_values_t
from ..linalg.solvers import cg
from ..ops import diffusion as dmod
from ..ops.dg_advection import convection_qdata, mass_inverse, upwind_flux, upwind_tables
from ..ops.dg_diffusion import boundary_rows, face_diagonal, interior_rows, sipg_tables
from ..ops.face_sum import FaceSum
from ..utils.config import config, real_t, resolve_device
from .partition import partition_mesh

_es = torch.einsum


def _edge_color(pairs: List[Tuple[int, int]]):
    """Greedy edge colouring: each colour is a matching of rank pairs."""
    colors: List[List[Tuple[int, int]]] = []
    for e in sorted(pairs):
        for cls in colors:
            if all(e[0] not in p and e[1] not in p for p in cls):
                cls.append(e)
                break
        else:
            colors.append([e])
    return colors


def pdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Global inner product: the local ``torch.dot`` (in float64 for float32
    vectors with ``config.f64_reductions``, as ``linalg/solvers.default_dot``)
    and one ``all_reduce``; at world size 1 it equals ``default_dot``."""
    if config.f64_reductions and a.dtype != torch.float64:
        s = torch.dot(a.double(), b.double())
    else:
        s = torch.dot(a, b)
    s = s.reshape(1)
    dist.all_reduce(s)
    return s[0].to(a.dtype)


@dataclasses.dataclass(eq=False)
class _Layout:
    """This rank's elements and faces: local ids of its own elements
    (``elems`` global, ascending), its own interior faces, its cross faces
    (by colour, then global face id) with their side and the exchange
    rounds, and its boundary faces; the ``*_sel`` arrays index the global
    face tables."""

    rank: int
    world: int
    elems: np.ndarray
    ne_max: int
    loc_sel: np.ndarray
    e0l: np.ndarray
    e1l: np.ndarray
    cx_sel: np.ndarray
    ecx: np.ndarray
    side0: np.ndarray           # True where this rank holds side 0
    rounds: List[Tuple[int, int, int]]   # (partner, start, stop) per colour
    b_sel: np.ndarray
    bel: np.ndarray


def _layout(mesh, fd, parts) -> _Layout:
    rank, world = dist.get_rank(), dist.get_world_size()
    ne = mesh.ne
    dev_elems = [np.nonzero(parts == d)[0] for d in range(world)]
    g2l = np.full(ne, -1, dtype=np.int64)
    for e in dev_elems:
        g2l[e] = np.arange(len(e))
    d0, d1 = parts[fd.elem0], parts[fd.elem1]
    loc_sel = np.nonzero((d0 == d1) & (d0 == rank))[0]

    cross = np.nonzero(d0 != d1)[0]
    lo, hi = np.minimum(d0[cross], d1[cross]), np.maximum(d0[cross], d1[cross])
    colors = _edge_color(sorted(set(zip(lo.tolist(), hi.tolist()))))
    cx, rounds, start = [], [], 0
    for cls in colors:
        for a, b in cls:
            if rank in (a, b):
                f = cross[(lo == a) & (hi == b)]          # ascending global id
                rounds.append((b if rank == a else a, start, start + len(f)))
                cx.append(f)
                start += len(f)
    cx_sel = np.concatenate(cx) if cx else np.zeros(0, dtype=np.int64)
    side0 = d0[cx_sel] == rank
    own = np.where(side0, fd.elem0[cx_sel], fd.elem1[cx_sel])
    b_sel = np.nonzero(parts[fd.b_elem] == rank)[0]
    return _Layout(rank=rank, world=world, elems=dev_elems[rank],
                   ne_max=max(len(e) for e in dev_elems), loc_sel=loc_sel,
                   e0l=g2l[fd.elem0[loc_sel]], e1l=g2l[fd.elem1[loc_sel]],
                   cx_sel=cx_sel, ecx=g2l[own], side0=side0, rounds=rounds,
                   b_sel=b_sel, bel=g2l[fd.b_elem[b_sel]])


def _exchange(own: torch.Tensor, rounds) -> torch.Tensor:
    """The partners' traces of this rank's cross faces: one
    ``batch_isend_irecv`` per colour."""
    recv = torch.empty_like(own)
    for partner, s, e in rounds:
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, own[s:e].contiguous(), partner),
                dist.P2POp(dist.irecv, recv[s:e], partner)]):
            req.wait()
    return recv


@dataclasses.dataclass(eq=False)
class _ParDG:
    """This rank's part of a sharded DG operator over global vectors
    (ne·nd,) held element block by element block."""

    fes: object
    parts: np.ndarray
    layout: _Layout
    device: torch.device
    dtype: torch.dtype
    faces: FaceSum               # the rank's face reads and sum

    @property
    def ne_loc(self):
        return len(self.layout.elems)

    def scatter(self, u_global) -> torch.Tensor:
        """Global (ne·nd,) L2 field → this rank's (ne_loc·nd,) on its device."""
        nd = self.fes.nd_elem
        u = torch.as_tensor(u_global).reshape(-1, nd)
        rows = torch.as_tensor(self.layout.elems, device=u.device)
        return u[rows].reshape(-1).to(device=self.device, dtype=self.dtype)

    def gather(self, u_loc: torch.Tensor) -> Optional[np.ndarray]:
        """Every rank's (ne_loc·nd,) to rank 0 as the global (ne·nd,) numpy
        field; ``None`` on the other ranks."""
        L, nd = self.layout, self.fes.nd_elem
        pad = u_loc.new_zeros(L.ne_max * nd)
        pad[:u_loc.numel()] = u_loc
        rows = [torch.empty_like(pad) for _ in range(L.world)] if L.rank == 0 else None
        dist.gather(pad, rows, dst=0)
        if L.rank != 0:
            return None
        out = np.zeros((self.fes.mesh.ne, nd), dtype=np.float64)
        for d, r in enumerate(rows):
            e = np.nonzero(self.parts == d)[0]
            out[e] = r.view(-1, nd)[:len(e)].double().cpu().numpy()
        return out.reshape(-1)


def _local_geometry(fes, elems, nq1d, rt, dev):
    d2q = fes.dof_to_quad(nq1d)
    X = element_node_coords(fes.mesh, fes.order)[elems]
    return device_basis(d2q, rt, dev), compute_geometric_factors(X, d2q, rt, dev)


@dataclasses.dataclass(eq=False)
class ParDGAdvection(_ParDG):
    """Sharded ex9 operator on this rank: ``mult(t, u_loc)``."""

    mult: Callable = None


def setup(fes, velocity: Callable, inflow: Optional[Callable] = None,
          nq1d: Optional[int] = None, dtype=None, parts: Optional[np.ndarray] = None,
          device=None) -> ParDGAdvection:
    """This rank's sharded upwind DG advection operator on ``device``, the
    rank's (``launch.init``'s; ``None``: the card)."""
    mesh = fes.mesh
    dev = resolve_device(device)
    rt = real_t(dtype)
    if parts is None:
        parts = partition_mesh(mesh, dist.get_world_size())
    fd = face_data_for(fes, nq1d)
    L = _layout(mesh, fd, parts)
    db, gf = _local_geometry(fes, L.elems, nq1d, rt, dev)
    vol_qd = convection_qdata(gf, velocity)
    Minv = mass_inverse(fes, nq1d, rt, dev, L.elems)
    vn, bvn, g_in = upwind_tables(fd, velocity, inflow)
    t = lambda a: torch.as_tensor(a, dtype=rt, device=dev)
    B0, B1, vnl = t(fd.B0[L.loc_sel]), t(fd.B1[L.loc_sel]), t(vn[L.loc_sel])
    Bc = t(np.where(L.side0[:, None, None], fd.B0[L.cx_sel], fd.B1[L.cx_sel]))
    vnc = t(vn[L.cx_sel])
    role = torch.as_tensor(L.side0, device=dev)[:, None]
    sgn = torch.where(role, -1.0, 1.0).to(rt)
    bB, bvnl, gin = t(fd.b_B[L.b_sel]), t(bvn[L.b_sel]), t(g_in[L.b_sel])
    nd, ne_loc = fes.nd_elem, len(L.elems)
    F = FaceSum(ne_loc, nd, [np.arange(ne_loc), L.e0l, L.e1l, L.ecx, L.bel], dev)

    def mult(t_, u_loc):
        u = u_loc.reshape(ne_loc, nd)
        y = eval_grad_t(db, vol_qd * eval_values(db, u)[..., None])
        # the rank's own interior faces
        u0 = _es("fqn,fn->fq", B0, F.read(u, 1))
        u1 = _es("fqn,fn->fq", B1, F.read(u, 2))
        flux = upwind_flux(vnl, u0, u1)
        y0 = -_es("fqn,fq->fn", B0, flux)
        y1 = _es("fqn,fq->fn", B1, flux)
        # cross faces: own trace, the partner's by exchange
        own = _es("fqn,fn->fq", Bc, F.read(u, 3))
        recv = _exchange(own, L.rounds)
        yc = _es("fqn,fq->fn", Bc, sgn * upwind_flux(
            vnc, torch.where(role, own, recv), torch.where(role, recv, own)))
        # boundary faces
        ub = _es("fqn,fn->fq", bB, F.read(u, 4))
        yb = -_es("fqn,fq->fn", bB, upwind_flux(bvnl, ub, gin))
        r = F.sum([y, y0, y1, yc, yb])
        return _es("emn,en->em", Minv, r).reshape(-1)

    return ParDGAdvection(fes=fes, parts=parts, layout=L, device=dev, dtype=rt,
                          faces=F, mult=mult)


@dataclasses.dataclass(eq=False)
class ParDGDiffusion(_ParDG):
    """Sharded SIPG operator on this rank: ``mult(u_loc)``, the right-hand
    side ``b`` and Jacobi diagonal ``diag`` of the rank's elements, and
    ``solve(rel_tol, max_iter) -> (u_loc, SolveInfo)``, Jacobi-PCG with
    ``all_reduce``d inner products."""

    mult: Callable = None
    b: torch.Tensor = None
    diag: torch.Tensor = None

    def solve(self, rel_tol=1e-10, max_iter=2000):
        d = self.diag
        return cg(self.mult, self.b, M=lambda r: r / d, rel_tol=rel_tol,
                  max_iter=max_iter, dot=pdot)


def setup_sipg(fes, kappa: float = 1.0, penalty: float = 10.0,
               g: Optional[Callable] = None, f_rhs: Optional[Callable] = None,
               nq1d: Optional[int] = None, dtype=None,
               parts: Optional[np.ndarray] = None, device=None) -> ParDGDiffusion:
    """This rank's sharded SIPG operator, with the weak Dirichlet data ``g``
    and the volume source ``f_rhs`` in its right-hand side."""
    mesh = fes.mesh
    dev = resolve_device(device)
    rt = real_t(dtype)
    if parts is None:
        parts = partition_mesh(mesh, dist.get_world_size())
    fd = face_data_for(fes, nq1d, with_gradients=True)
    L = _layout(mesh, fd, parts)
    T = sipg_tables(fd, fes.order, kappa, penalty)
    db, gf = _local_geometry(fes, L.elems, nq1d, rt, dev)
    vol_qd = dmod.setup_packed(gf, kappa)
    t = lambda a: torch.as_tensor(a, dtype=rt, device=dev)
    loc = {k: t(T[k][L.loc_sel]) for k in ("B0", "B1", "N0", "N1", "w_f", "pen")}
    s0 = L.side0[:, None, None]
    Bc = t(np.where(s0, T["B0"][L.cx_sel], T["B1"][L.cx_sel]))
    Nc = t(np.where(s0, T["N0"][L.cx_sel], T["N1"][L.cx_sel]))
    wc, penc = t(T["w_f"][L.cx_sel]), t(T["pen"][L.cx_sel])
    role = torch.as_tensor(L.side0, device=dev)[:, None]
    sgn = torch.where(role, -1.0, 1.0).to(rt)
    bnd = {k: t(T[k][L.b_sel]) for k in ("bB", "bN", "bw", "bpen")}
    nd, ne_loc, nqf = fes.nd_elem, len(L.elems), fd.B0.shape[1]
    F = FaceSum(ne_loc, nd, [np.arange(ne_loc), L.e0l, L.e1l, L.ecx, L.bel], dev)

    def mult(u_loc):
        u = u_loc.reshape(ne_loc, nd)
        y = dmod.apply(db, vol_qd, u)
        y0, y1 = interior_rows(*(loc[k] for k in ("B0", "B1", "N0", "N1", "w_f", "pen")),
                               F.read(u, 1), F.read(u, 2))
        # cross faces: own (value, normal derivative) traces, the partner's
        uec = F.read(u, 3)
        own = torch.cat([_es("fqn,fn->fq", Bc, uec), _es("fqn,fn->fq", Nc, uec)], -1)
        recv = _exchange(own, L.rounds)
        u0c = torch.where(role, own, recv)
        u1c = torch.where(role, recv, own)
        jmp = u0c[:, :nqf] - u1c[:, :nqf]
        tc = wc * 0.5 * (u0c[:, nqf:] + u1c[:, nqf:])
        yc = (_es("fqn,fq->fn", Bc, sgn * (tc - penc[:, None] * wc * jmp))
              - _es("fqn,fq->fn", Nc, 0.5 * wc * jmp))
        yb = boundary_rows(bnd["bB"], bnd["bN"], bnd["bw"], bnd["bpen"], F.read(u, 4))
        return F.sum([y, y0, y1, yc, yb]).reshape(-1)

    # right-hand side and Jacobi diagonal of the rank's elements
    b = torch.zeros(ne_loc * nd, dtype=rt, device=dev)
    if g is not None:
        from ..ops.dg_advection import host_call

        gq = t(host_call(g, fd.b_xq[L.b_sel]))
        bb = (-_es("fqn,fq->fn", bnd["bN"], bnd["bw"] * gq)
              + _es("fqn,fq->fn", bnd["bB"], bnd["bpen"][:, None] * bnd["bw"] * gq))
        b = b + F.sum([None, None, None, None, bb]).reshape(-1)
    if f_rhs is not None:
        fq = torch.as_tensor(f_rhs(gf.x), dtype=rt, device=dev)
        b = b + eval_values_t(db, gf.wdet * fq).reshape(-1)
    d = F.sum([dmod.diagonal(db, vol_qd),
               face_diagonal(loc["B0"], loc["N0"], loc["w_f"], loc["pen"], 1.0),
               face_diagonal(loc["B1"], loc["N1"], loc["w_f"], loc["pen"], -1.0),
               face_diagonal(Bc, Nc, wc, penc, -sgn[..., None]),
               face_diagonal(bnd["bB"], bnd["bN"], bnd["bw"], bnd["bpen"], 2.0)])
    diag = torch.clamp_min(d.reshape(-1), 0.0)
    diag = torch.where(diag == 0.0, torch.ones_like(diag), diag)
    return ParDGDiffusion(fes=fes, parts=parts, layout=L, device=dev, dtype=rt,
                          faces=F, mult=mult, b=b, diag=diag)

