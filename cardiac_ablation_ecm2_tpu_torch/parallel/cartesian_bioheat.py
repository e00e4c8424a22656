"""Sharded bioheat on a structured Cartesian lattice (counterpart of
``cardiac_ablation_ecm2_tpu/parallel/cartesian_bioheat.py``).

The domain is split into contiguous z-slabs of the dof lattice, one rank
each.  Each rank's restriction is the gather-free structured one
(``fem/cartesian.StructuredRestriction``); the halo is one shared dof plane
per z-neighbour, sent to and received from rank ± 1 in one
``batch_isend_irecv`` per operator apply (the least communication a
structured partition needs).  The stage PCG solves take ``all_reduce``d
inner products; the diffusion apply is ``fused_diffusion`` on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..fem.basis import make_dof_to_quad
from ..fem.cartesian import StructuredRestriction
from ..fem.fespace import element_node_coords
from ..fem.geom_factors import compute_geometric_factors
from ..fem.geometry import Geometry
from ..fem.quadinterp import device_basis, eval_values_t
from ..linalg.solvers import cg
from ..mesh.mesh import make_cartesian_3d
from ..ops import diffusion as dmod
from ..ops import mass as mmod
from ..utils.config import real_t, resolve_device
from . import ops as pops


@dataclasses.dataclass(eq=False)
class ParCartesianBioheat:
    ndev: int
    n: tuple                      # global (nx, ny, nz)
    order: int
    nloc_shape: tuple             # (Nz_loc, Ny, Nx) local dof lattice
    step: Callable                # (T_loc, t, dt) -> (T_loc, t)
    T0: torch.Tensor              # (Nl+1,)
    cg_iterations: List[int]      # CG iterations of every stage solve

    def gather(self, T_loc) -> Optional[np.ndarray]:
        """The global lattice vector (z slowest) on rank 0, ``None``
        elsewhere."""
        root = dist.get_rank() == 0
        rows = [torch.empty_like(T_loc) for _ in range(self.ndev)] if root else None
        dist.gather(T_loc, rows, dst=0)
        if not root:
            return None
        Nzl, Ny, Nx = self.nloc_shape
        out = []
        for d, row in enumerate(rows):
            sl = row[:-1].cpu().numpy().reshape(Nzl, Ny, Nx)
            out.append(sl if d == self.ndev - 1 else sl[:-1])
        return np.concatenate(out, axis=0).reshape(-1)


def setup(
    nx: int, ny: int, nz: int,
    order: int = 2,
    lengths=(0.04, 0.04, 0.04),
    rho_c: float = 3.6e6, k: float = 0.54, w_cb: float = 2e4,
    T_a: float = 37.0,
    q_src: Optional[Callable] = None,
    ess_all_boundary: bool = True,
    solver: str = "sdirk33",
    rel_tol: float = 1e-5,
    max_iter: int = 300,
    dtype=None,
    device=None,
) -> ParCartesianBioheat:
    """Set up this rank's slab; the process group (``launch.init``) sets the
    rank and the world size, which must divide ``nz``.  ``device=None`` is
    the card."""
    device = resolve_device(device)
    rank, ndev = dist.get_rank(), dist.get_world_size()
    if nz % ndev:
        raise ValueError(f"nz = {nz} must be divisible by the world size {ndev}")
    nzl = nz // ndev
    p = order
    rt = real_t(dtype)

    # the rank's slab restriction (the same on every rank)
    Nx, Ny, Nzl = p * nx + 1, p * ny + 1, p * nzl + 1
    Nl = Nx * Ny * Nzl
    R = StructuredRestriction((nx, ny, nzl), p, Nl)
    d2q = make_dof_to_quad(Geometry.CUBE, p, p + 2)
    db = device_basis(d2q, dtype, device)

    # the rank's element slab (elements x fastest, so each slab is a block)
    Lx, Ly, Lz = lengths
    ne_loc = nx * ny * nzl
    Xe = element_node_coords(make_cartesian_3d(nx, ny, nz, Lx, Ly, Lz), p)
    X = Xe[rank * ne_loc:(rank + 1) * ne_loc]

    # essential dofs (all six outer faces)
    m = np.zeros((Nzl, Ny, Nx), dtype=bool)
    if ess_all_boundary:
        m[:, 0, :] = True
        m[:, -1, :] = True
        m[:, :, 0] = True
        m[:, :, -1] = True
        if rank == 0:
            m[0] = True
        if rank == ndev - 1:
            m[-1] = True
    ess = torch.as_tensor(np.nonzero(m.reshape(-1))[0], device=device)

    # dot weights: interior shared planes count half on each side
    w = np.ones((Nzl, Ny, Nx))
    if rank > 0:
        w[0] *= 0.5
    if rank < ndev - 1:
        w[-1] *= 0.5
    pdot = pops.make_pdot(torch.as_tensor(
        np.concatenate([w.reshape(-1), [0.0]]), dtype=rt, device=device))

    plane = Ny * Nx
    below = rank - 1 if rank > 0 else None
    above = rank + 1 if rank < ndev - 1 else None

    def halo(y):
        """Add the z-neighbours' partial sums on the shared planes, from
        the pre-exchange partials: below's top plane onto my bottom one,
        above's bottom plane onto my top one."""
        y3 = y.view(Nzl, plane)
        ops, adds = [], []
        for partner, mine in ((below, 0), (above, Nzl - 1)):
            if partner is None:
                continue
            recv = torch.empty(plane, dtype=y.dtype, device=y.device)
            ops += [dist.P2POp(dist.isend, y3[mine], partner),
                    dist.P2POp(dist.irecv, recv, partner)]
            adds.append((mine, recv))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for mine, recv in adds:
            y3[mine] += recv
        return y

    def pad(v):
        return torch.cat([v, v.new_zeros(1)])

    # ---------------- rank-local one-shot setup -----------------------
    gf = compute_geometric_factors(X, d2q, dtype, device)
    qm = mmod.setup(gf) * rho_c
    qw = mmod.setup(gf) * w_cb
    qk = dmod.setup_packed(gf, k)
    q = qw * T_a
    if q_src is not None:
        q = q + gf.wdet * q_src(gf.x).to(rt)
    bc = pad(halo(R.mult_transpose(eval_values_t(db, q))))
    dM = halo(R.mult_transpose(mmod.diagonal(db, qm)))
    dA = halo(R.mult_transpose(dmod.diagonal(db, qk) + mmod.diagonal(db, qw)))
    del gf, q
    cg_iterations: List[int] = []

    def zero_ess(v):
        return v.index_fill(0, ess, 0.0)

    def Aop(v):
        e = R.mult(v[:Nl])
        return pad(halo(R.mult_transpose(mmod.apply(db, qw, e)
                                         + dmod.apply(db, qk, e))))

    def Mrc(v):
        return pad(halo(R.mult_transpose(mmod.apply(db, qm, R.mult(v[:Nl])))))

    def implicit_solve(gamma, Tv):
        rhs = zero_ess(bc - Aop(Tv))

        def lhs(v):
            z = zero_ess(v)
            return zero_ess(Mrc(z) + gamma * Aop(z)) + (v - z)

        dg = pad(dM + gamma * dA).index_fill(0, ess, 1.0)
        dg[Nl] = 1.0
        dg = torch.where(dg == 0.0, 1.0, dg)
        x, info = cg(lhs, rhs, M=lambda r: r / dg, rel_tol=rel_tol,
                     max_iter=max_iter, dot=pdot)
        cg_iterations.append(info.iterations)
        return zero_ess(x)

    T0 = torch.full((Nl + 1,), T_a, dtype=rt, device=device)
    T0[Nl] = 0.0
    return ParCartesianBioheat(
        ndev=ndev, n=(nx, ny, nz), order=order, nloc_shape=(Nzl, Ny, Nx),
        step=pops.rk_stepper(solver, implicit_solve), T0=T0,
        cg_iterations=cg_iterations)
