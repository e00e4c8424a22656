"""Structured (Cartesian) FE space with a gather-free restriction
(counterpart of ``cardiac_ablation_ecm2_tpu/fem/cartesian.py``, quads and
hexes).

With lexicographic dof numbering the local lattice offset (a, b, c) of
element (ex, ey, ez) is the global lattice node (p·ex+a, p·ey+b, p·ez+c)
(in 2D (a, b) of (ex, ey)), so

* L→E is a view: ``unfold`` the ([Nz,] Ny, Nx) dof lattice into
  overlapping windows of p+1 nodes with step p along each axis, then one
  copy into the (ne, nd) or (nd, ne) layout;
* E→L sums the windows back, one axis at a time (x, then y, then z, as the
  JAX package does): every lattice node takes its own window's value and
  adds the previous window's last node where two windows meet.  Copies and
  adds on strided views, deterministic, no index tables and no atomics.

Trailing component axes pass through both directions ((ndof, c) ↔
(ne, nd, c)), as in the JAX package; ``mult_vec`` / ``mult_transpose_vec``
take byNODES vectors, as ``ElementRestriction``'s do.

``CartesianFESpace`` is duck-type compatible with ``FESpace`` (gather_map,
ndof, vdim, nd_elem, d2q, dof_coords, essential_dofs); ``fem/build.py``
``restriction_for`` returns its structured restriction.  Elements are
ordered x fastest, as ``mesh.make_cartesian_2d`` / ``make_cartesian_3d``
number them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..mesh.mesh import Mesh
from .basis import DofToQuad, h1_nodes_1d, lattice_multi_index, make_dof_to_quad
from .geometry import Geometry


def _sum_windows(v: torch.Tensor, n_dim: int, c_dim: int, p: int) -> torch.Tensor:
    """Adjoint of ``unfold(size=p+1, step=p)``: the block axis ``n_dim`` and
    the local-node axis ``c_dim`` of ``v`` become one lattice axis of length
    p·n+1 at the block axis' place (``c_dim`` is dropped).  The result is
    laid out in ``v``'s memory order, so both copies read along ``v``'s
    fastest axis."""
    n = v.shape[n_dim]
    keep = [d for d in range(v.dim()) if d != c_dim]
    pos = {d: i for i, d in enumerate(keep)}
    shape = [v.shape[d] for d in keep]
    shape[pos[n_dim]] = p * n + 1
    order = sorted(keep, key=lambda d: -v.stride(d))      # slowest first
    buf = v.new_empty([shape[pos[d]] for d in order])
    out = buf.permute([order.index(d) for d in keep])     # logical axes
    m = pos[n_dim]
    w = out.unfold(m, p + 1, p)                           # (..., n, ..., c)
    vc = v.movedim(c_dim, -1)                             # same axes as w
    w[..., :p].copy_(vc[..., :p])
    out.select(m, p * n).copy_(vc.select(m, n - 1)[..., p])
    w.narrow(m, 1, n - 1)[..., 0].add_(vc.narrow(m, 0, n - 1)[..., p])
    return out


class StructuredRestriction:
    """Gather-free L↔E restriction on a 2D or 3D Cartesian dof lattice.  It
    holds no tensors: every method runs on the device of its argument."""

    def __init__(self, shape_n: Tuple[int, ...], order: int, ndof: int):
        if len(shape_n) not in (2, 3):
            raise NotImplementedError("structured restrictions are 2D or 3D")
        self.shape_n = tuple(int(n) for n in shape_n)
        self.order = p = int(order)
        self.ndof = int(ndof)
        self.dim = len(self.shape_n)
        self.nshape = tuple(p * n + 1 for n in self.shape_n)
        self.ne = int(np.prod(self.shape_n))
        self.nd = (p + 1) ** self.dim

    def _blocks(self, u: torch.Tensor) -> torch.Tensor:
        """(ndof, *c) → view ([nz,] ny, nx, [cz,] cy, cx, *c) of every
        element's (p+1)^dim block of the lattice."""
        p, d = self.order, self.dim
        extra = u.shape[1:]
        v = u.view(*self.nshape[::-1], *extra)
        for a in range(d):
            v = v.unfold(a, p + 1, p)            # window axes go last
        k = len(extra)
        return v.permute(*range(d), *range(d + k, 2 * d + k),
                         *range(d, d + k))

    def _sum_blocks(self, v: torch.Tensor) -> torch.Tensor:
        """Adjoint of :meth:`_blocks`: ([nz,] ny, nx, [cz,] cy, cx, *c) →
        (ndof, *c); x first, then y, then z."""
        d = self.dim
        extra = v.shape[2 * d:]
        for a in reversed(range(d)):
            v = _sum_windows(v, a, d + a, self.order)
        return v.reshape(self.ndof, *extra)

    def mult(self, u: torch.Tensor) -> torch.Tensor:
        """L→E: (ndof[, c]) → (ne, nd[, c]), elements x fastest, local dofs
        lex."""
        return self._blocks(u).reshape(self.ne, self.nd, *u.shape[1:])

    def mult_t(self, u: torch.Tensor) -> torch.Tensor:
        """L→E in the transposed layout: (ndof,) → contiguous (nd, ne)."""
        d = self.dim
        return self._blocks(u).permute(*range(d, 2 * d), *range(d)).reshape(
            self.nd, self.ne)

    def mult_transpose(self, u_e: torch.Tensor) -> torch.Tensor:
        """E→L sum: (ne, nd[, c]) → (ndof[, c]), deterministic."""
        c = self.order + 1
        return self._sum_blocks(u_e.reshape(*self.shape_n[::-1],
                                            *(c,) * self.dim, *u_e.shape[2:]))

    def mult_transpose_t(self, u_eT: torch.Tensor) -> torch.Tensor:
        """E→L sum from the transposed layout: (nd, ne) → (ndof,)."""
        c, d = self.order + 1, self.dim
        v = u_eT.reshape(*(c,) * d, *self.shape_n[::-1]).permute(
            *range(d, 2 * d), *range(d))
        return self._sum_blocks(v)

    def mult_vec(self, u: torch.Tensor, vdim: int) -> torch.Tensor:
        """L→E of a byNODES vector: (vdim·ndof,) → (ne, nd, vdim)."""
        return self.mult(u.view(vdim, self.ndof).T)

    def mult_transpose_vec(self, u_e: torch.Tensor) -> torch.Tensor:
        """E→L of a vector E-vector: (ne, nd, vdim) → (vdim·ndof,) byNODES."""
        return self.mult_transpose(u_e).T.reshape(-1)

    def counts(self, device=None) -> torch.Tensor:
        """Number of elements sharing each dof, (ndof,) int32."""
        ones = torch.ones(self.ne, self.nd, dtype=torch.float64, device=device)
        return self.mult_transpose(ones).to(torch.int32)


@dataclasses.dataclass(eq=False)
class CartesianFESpace:
    """H1 space on a Cartesian quad or hex grid with lexicographic dof
    numbering and the structured restriction; ``vdim`` components byNODES.
    Duck-type compatible with ``FESpace``."""

    mesh: Mesh
    order: int
    shape_n: Tuple[int, ...]          # (nx, ny[, nz])
    lengths: Tuple[float, ...] = None
    vdim: int = 1

    def __post_init__(self):
        p = self.order
        self.dim = len(self.shape_n)
        if self.dim not in (2, 3):
            raise NotImplementedError("CartesianFESpace is 2D or 3D")
        if self.lengths is None:
            self.lengths = tuple(float(self.mesh.vertices[:, d].max())
                                 for d in range(self.dim))
        self.nshape = tuple(p * n + 1 for n in self.shape_n)
        self.ndof_scalar = int(np.prod(self.nshape))
        self.restriction = StructuredRestriction(self.shape_n, p,
                                                 self.ndof_scalar)
        self.gather_map = self._build_gather().astype(np.int32)
        self.bdr_gather_map = None   # boundary dofs come from lattice masks

    @property
    def geom(self) -> Geometry:
        return Geometry.CUBE if self.dim == 3 else Geometry.SQUARE

    def _build_gather(self) -> np.ndarray:
        p = self.order
        grids = np.meshgrid(*(np.arange(n) for n in self.shape_n), indexing="ij")
        eidx = [g.ravel(order="F") for g in grids]           # x fastest
        mi = lattice_multi_index(self.geom, p)               # (nd, dim)
        out = 0
        for a in reversed(range(self.dim)):
            out = out * self.nshape[a] + (p * eidx[a][:, None] + mi[None, :, a])
        return out

    @property
    def ndof(self) -> int:
        return self.ndof_scalar * self.vdim

    @property
    def nd_elem(self) -> int:
        return self.gather_map.shape[1]

    @functools.cached_property
    def d2q(self) -> DofToQuad:
        from ..utils.config import config

        return make_dof_to_quad(self.geom, self.order,
                                self.order + 1 + config.quad_extra)

    def dof_to_quad(self, nq1d=None) -> DofToQuad:
        if nq1d is None:
            return self.d2q
        return make_dof_to_quad(self.geom, self.order, nq1d)

    @functools.cached_property
    def dof_coords(self) -> np.ndarray:
        x1 = [
            np.concatenate(
                [k / self.shape_n[d] * self.lengths[d]
                 + h1_nodes_1d(self.order)[:-1] / self.shape_n[d]
                 * self.lengths[d]
                 for k in range(self.shape_n[d])]
                + [[self.lengths[d]]]
            )
            for d in range(self.dim)
        ]
        grids = np.meshgrid(*x1, indexing="ij")
        return np.stack([g.ravel(order="F") for g in grids], axis=1)

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        """Boundary attributes of ``make_cartesian_2d`` (1=y0, 2=x1, 3=y1,
        4=x0) or ``make_cartesian_3d`` (1=z0, 2=y0, 3=x1, 4=y1, 5=x0,
        6=z1); ``None`` marks all of them."""
        masks = np.zeros(self.nshape[::-1], dtype=bool)  # ([Nz,] Ny, Nx)
        if self.dim == 3:
            sel = {1: (0, 0), 6: (0, -1), 2: (1, 0), 4: (1, -1),
                   5: (2, 0), 3: (2, -1)}
        else:
            sel = {1: (0, 0), 3: (0, -1), 4: (1, 0), 2: (1, -1)}
        attrs = list(bdr_marker) if bdr_marker is not None else list(sel)
        for a in attrs:
            axis, end = sel[a]      # C-order axis: 0 = slowest, last = x
            sl = [slice(None)] * self.dim
            sl[axis] = end
            masks[tuple(sl)] = True
        return np.nonzero(masks.reshape(-1))[0].astype(np.int32)
