"""Structured (Cartesian) FE space with a gather-free restriction
(counterpart of ``cardiac_ablation_ecm2_tpu/fem/cartesian.py``, 3D).

With lexicographic dof numbering the local lattice offset (a, b, c) of
element (ex, ey, ez) is the global lattice node (p·ex+a, p·ey+b, p·ez+c), so

* L→E is a view: ``unfold`` the (Nz, Ny, Nx) dof lattice into overlapping
  windows of p+1 nodes with step p along each axis, then one copy into the
  (ne, nd) or (nd, ne) layout;
* E→L sums the windows back, one axis at a time (x, then y, then z, as the
  JAX package does): every lattice node takes its own window's value and
  adds the previous window's last node where two windows meet.  Copies and
  adds on strided views, deterministic, no index tables and no atomics.

``CartesianFESpace`` is duck-type compatible with ``FESpace`` (gather_map,
ndof, nd_elem, d2q, dof_coords, essential_dofs); ``fem/build.py``
``restriction_for`` returns its structured restriction.  Elements are
ordered x fastest, as ``mesh.make_cartesian_3d`` numbers them.
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
    """Gather-free L↔E restriction on a 3D Cartesian dof lattice.  It holds
    no tensors: every method runs on the device of its argument."""

    def __init__(self, shape_n: Tuple[int, ...], order: int, ndof: int):
        if len(shape_n) != 3:
            raise NotImplementedError("the port's structured restriction is 3D")
        self.shape_n = tuple(int(n) for n in shape_n)
        self.order = p = int(order)
        self.ndof = int(ndof)
        self.dim = 3
        self.nshape = tuple(p * n + 1 for n in self.shape_n)
        self.ne = int(np.prod(self.shape_n))
        self.nd = (p + 1) ** 3

    def _blocks(self, u: torch.Tensor) -> torch.Tensor:
        """(ndof,) → view (nz, ny, nx, cz, cy, cx) of every element's
        (p+1)³ block of the lattice."""
        p = self.order
        Nx, Ny, Nz = self.nshape
        v = u.view(Nz, Ny, Nx)
        return v.unfold(0, p + 1, p).unfold(1, p + 1, p).unfold(2, p + 1, p)

    def _sum_blocks(self, v: torch.Tensor) -> torch.Tensor:
        """Adjoint of :meth:`_blocks`: (nz, ny, nx, cz, cy, cx) → (ndof,)."""
        p = self.order
        v = _sum_windows(v, 2, 5, p)        # (nz, ny, Nx, cz, cy)
        v = _sum_windows(v, 1, 4, p)        # (nz, Ny, Nx, cz)
        v = _sum_windows(v, 0, 3, p)        # (Nz, Ny, Nx)
        return v.reshape(self.ndof)

    def mult(self, u: torch.Tensor) -> torch.Tensor:
        """L→E: (ndof,) → (ne, nd), elements x fastest, local dofs lex."""
        return self._blocks(u).reshape(self.ne, self.nd)

    def mult_t(self, u: torch.Tensor) -> torch.Tensor:
        """L→E in the transposed layout: (ndof,) → contiguous (nd, ne)."""
        return self._blocks(u).permute(3, 4, 5, 0, 1, 2).reshape(self.nd, self.ne)

    def mult_transpose(self, u_e: torch.Tensor) -> torch.Tensor:
        """E→L sum: (ne, nd) → (ndof,), deterministic."""
        nx, ny, nz = self.shape_n
        c = self.order + 1
        return self._sum_blocks(u_e.reshape(nz, ny, nx, c, c, c))

    def mult_transpose_t(self, u_eT: torch.Tensor) -> torch.Tensor:
        """E→L sum from the transposed layout: (nd, ne) → (ndof,)."""
        nx, ny, nz = self.shape_n
        c = self.order + 1
        v = u_eT.reshape(c, c, c, nz, ny, nx).permute(3, 4, 5, 0, 1, 2)
        return self._sum_blocks(v)

    def counts(self, device=None) -> torch.Tensor:
        """Number of elements sharing each dof, (ndof,) int32."""
        ones = torch.ones(self.ne, self.nd, dtype=torch.float64, device=device)
        return self.mult_transpose(ones).to(torch.int32)


@dataclasses.dataclass(eq=False)
class CartesianFESpace:
    """Scalar H1 space on a Cartesian hex grid with lexicographic dof
    numbering and the structured restriction.  Duck-type compatible with
    ``FESpace``."""

    mesh: Mesh
    order: int
    shape_n: Tuple[int, ...]          # (nx, ny, nz)
    lengths: Tuple[float, ...] = None

    def __post_init__(self):
        p = self.order
        self.dim = len(self.shape_n)
        if self.dim != 3:
            raise NotImplementedError("the port's CartesianFESpace is 3D")
        if self.lengths is None:
            self.lengths = tuple(float(self.mesh.vertices[:, d].max())
                                 for d in range(self.dim))
        self.nshape = tuple(p * n + 1 for n in self.shape_n)
        self.ndof_scalar = int(np.prod(self.nshape))
        self.restriction = StructuredRestriction(self.shape_n, p,
                                                 self.ndof_scalar)
        self.gather_map = self._build_gather().astype(np.int32)
        self.bdr_gather_map = None   # boundary dofs come from lattice masks

    def _build_gather(self) -> np.ndarray:
        p = self.order
        nx, ny, nz = self.shape_n
        Nx, Ny, _ = self.nshape
        ex, ey, ez = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                 indexing="ij")
        ex, ey, ez = (a.ravel(order="F") for a in (ex, ey, ez))
        mi = lattice_multi_index(Geometry.CUBE, p)   # (nd, 3)
        gx = p * ex[:, None] + mi[None, :, 0]
        gy = p * ey[:, None] + mi[None, :, 1]
        gz = p * ez[:, None] + mi[None, :, 2]
        return gx + Nx * (gy + Ny * gz)

    @property
    def ndof(self) -> int:
        return self.ndof_scalar

    @property
    def vdim(self) -> int:
        """Scalar: the structured restriction has no component axes."""
        return 1

    @property
    def nd_elem(self) -> int:
        return self.gather_map.shape[1]

    @functools.cached_property
    def d2q(self) -> DofToQuad:
        from ..utils.config import config

        return make_dof_to_quad(Geometry.CUBE, self.order,
                                self.order + 1 + config.quad_extra)

    def dof_to_quad(self, nq1d=None) -> DofToQuad:
        if nq1d is None:
            return self.d2q
        return make_dof_to_quad(Geometry.CUBE, self.order, nq1d)

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
        """Boundary attributes of ``make_cartesian_3d``: 1=z0, 2=y0, 3=x1,
        4=y1, 5=x0, 6=z1; ``None`` marks all six."""
        masks = np.zeros(self.nshape[::-1], dtype=bool)  # (Nz, Ny, Nx)
        sel = {1: (0, 0), 6: (0, -1), 2: (1, 0), 4: (1, -1),
               5: (2, 0), 3: (2, -1)}
        attrs = list(bdr_marker) if bdr_marker is not None else list(sel)
        for a in attrs:
            axis, end = sel[a]      # C-order axis: 0 = z (slowest), 2 = x
            sl = [slice(None)] * 3
            sl[axis] = end
            masks[tuple(sl)] = True
        return np.nonzero(masks.reshape(-1))[0].astype(np.int32)
