"""Grid transfers between two spaces (``_interp_db``, ``PTransfer``,
``HTransfer`` and ``_tensor_child_interp`` of
``cardiac_ablation_ecm2_tpu/fem/transfer.py``; MFEM's
``PRefinementTransferOperator`` and the uniform-refinement transfers of a
``FiniteElementSpaceHierarchy``).

Both transfers are element-local interpolation, then an average into the
fine L-vector by the fine dofs' multiplicity (exact for continuous data):

* ``PTransfer`` (one mesh, order pc → pf): the coarse basis at the fine
  space's nodes, as the ``eval_values`` contraction of a ``DeviceBasis``
  whose "quadrature points" are those nodes (per axis on tensor
  geometries, dense on simplices);
* ``HTransfer`` (a mesh → its uniform refinement, one order): per child,
  the (nd, nd) matrix of the parent's basis at the child's nodes; child o
  of coarse element e is fine element o·ne_c + e
  (``Mesh.uniform_refinement``), so the fine E-vector is one batched
  (nchild, nd, nd) einsum of the coarse one.

``restrict_t`` is the exact adjoint of ``prolongate``.  Both run through
the two spaces' restrictions (``fem/build.py``: the gather and segment-sum
kernels on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.config import real_t, resolve_device
from .basis import h1_nodes, h1_nodes_1d, lagrange_matrices, simplex_basis_matrices
from .build import restriction_for
from .fespace import FESpace
from .geometry import DIMENSION, IS_TENSOR, REF_VERTS, Geometry
from .quadinterp import DeviceBasis, eval_values, eval_values_t


def _interp_db(geom: Geometry, pc: int, pf: int, dtype=None,
               device=None) -> DeviceBasis:
    """DeviceBasis whose points are the order-``pf`` nodes: B1 is the
    (pf+1, pc+1) 1D interpolation matrix (G1 zero) on tensor geometries,
    B the dense (nd_f, nd_c) one on simplices."""
    kw = dict(dtype=real_t(dtype), device=resolve_device(device))
    if IS_TENSOR.get(geom, False):
        I1, _ = lagrange_matrices(h1_nodes_1d(pc), h1_nodes_1d(pf))
        B1 = torch.as_tensor(I1, **kw)
        return DeviceBasis(dim=DIMENSION[geom], tensor=True, W=None, B1=B1,
                           G1=torch.zeros_like(B1))
    Bf, _ = simplex_basis_matrices(geom, pc, h1_nodes(geom, pf))
    return DeviceBasis(dim=DIMENSION[geom], tensor=False, W=None,
                       B=torch.as_tensor(Bf, **kw))


@dataclasses.dataclass(eq=False)
class PTransfer:
    """Order transfer coarse → fine on a fixed mesh, on ``device``
    (``None``: the card)."""

    coarse: FESpace
    fine: FESpace
    dtype: object = None
    device: object = None

    def __post_init__(self):
        if self.coarse.mesh is not self.fine.mesh:
            raise ValueError("PTransfer needs two spaces on one mesh")
        self.device = resolve_device(self.device)
        self.db = _interp_db(self.coarse.mesh.geom, self.coarse.order,
                             self.fine.order, self.dtype, self.device)
        self.Rc = restriction_for(self.coarse, self.device)
        self.Rf = restriction_for(self.fine, self.device)
        ones = torch.ones(self.fine.ndof_scalar, dtype=real_t(self.dtype),
                          device=self.device)
        self.mult_f = self.Rf.mult_transpose(self.Rf.mult(ones))
        self.inv_mult_f = 1.0 / self.mult_f

    def prolongate(self, uc: torch.Tensor) -> torch.Tensor:
        e = eval_values(self.db, self.Rc.mult(uc))
        return self.inv_mult_f * self.Rf.mult_transpose(e)

    def restrict_t(self, rf: torch.Tensor) -> torch.Tensor:
        """Exact adjoint of prolongate."""
        e = self.Rf.mult(self.inv_mult_f * rf)
        return self.Rc.mult_transpose(eval_values_t(self.db, e))


@dataclasses.dataclass(eq=False)
class HTransfer:
    """Uniform-refinement transfer (one order, parent → 2^dim children, 4
    for triangles) on ``device`` (``None``: the card).  ``I`` is the
    (nchild, nd, nd) child interpolation: row = child node, column =
    parent basis function."""

    coarse: FESpace
    fine: FESpace
    dtype: object = None
    device: object = None

    def __post_init__(self):
        geom = self.coarse.mesh.geom
        p = self.coarse.order
        if self.fine.order != p:
            raise ValueError("HTransfer needs two spaces of one order")
        dim = self.coarse.mesh.dim
        nchild = 4 if geom == Geometry.TRIANGLE else 2 ** dim
        ne_c = self.coarse.mesh.ne
        if self.fine.mesh.ne != nchild * ne_c:
            raise ValueError("the fine mesh is not a uniform refinement of the "
                             "coarse one")
        self.device = resolve_device(self.device)
        rt = real_t(self.dtype)
        self.I = torch.as_tensor(child_interpolation(geom, p), dtype=rt,
                                 device=self.device)
        self.nchild, self.ne_c = nchild, ne_c
        self.Rc = restriction_for(self.coarse, self.device)
        self.Rf = restriction_for(self.fine, self.device)
        ones = torch.ones(self.fine.ndof_scalar, dtype=rt, device=self.device)
        self.inv_mult_f = 1.0 / self.Rf.mult_transpose(self.Rf.mult(ones))

    def prolongate(self, uc: torch.Tensor) -> torch.Tensor:
        e_c = self.Rc.mult(uc)                          # (ne_c, nd)
        e_f = torch.einsum("omn,en->oem", self.I, e_c).reshape(
            self.nchild * self.ne_c, -1)
        return self.inv_mult_f * self.Rf.mult_transpose(e_f)

    def restrict_t(self, rf: torch.Tensor) -> torch.Tensor:
        """Exact adjoint of prolongate."""
        e_f = self.Rf.mult(self.inv_mult_f * rf).reshape(self.nchild,
                                                          self.ne_c, -1)
        return self.Rc.mult_transpose(torch.einsum("omn,oem->en", self.I, e_f))


def child_interpolation(geom: Geometry, p: int) -> np.ndarray:
    """(nchild, nd, nd) float64: per refinement child, the order-p parent
    basis at the child's nodes (row = child node, column = parent basis),
    in the child order of ``Mesh.uniform_refinement`` (tensor geometries
    and triangles, the ones it refines)."""
    from ..mesh.mesh import _child_corner_coords

    if IS_TENSOR.get(geom, False):
        return np.stack([_tensor_child_interp(geom, p, off)
                         for off in REF_VERTS[geom].astype(np.float64)])
    if geom != Geometry.TRIANGLE:
        raise NotImplementedError(f"refinement transfer for {geom}")
    ref = h1_nodes(geom, p)
    mats = []
    for v0, v1, v2 in _child_corner_coords(geom):
        pts = v0 + ref[:, :1] * (v1 - v0) + ref[:, 1:] * (v2 - v0)
        mats.append(simplex_basis_matrices(geom, p, pts)[0])
    return np.stack(mats)


def _tensor_child_interp(geom: Geometry, p: int, off: np.ndarray) -> np.ndarray:
    """Dense (nd, nd) child-node interpolation on a tensor geometry in
    lexicographic order (row = child node, column = parent basis)."""
    dim = DIMENSION[geom]
    x1 = h1_nodes_1d(p)
    axes = [lagrange_matrices(x1, (off[d] + x1) / 2.0)[0] for d in range(dim)]
    n1 = p + 1
    if dim == 1:
        return axes[0]
    if dim == 2:
        return np.einsum("ai,bj->abij", axes[1], axes[0]).reshape(n1 ** 2, n1 ** 2)
    M = np.einsum("ai,bj,ck->abcijk", axes[2], axes[1], axes[0])
    return M.reshape(n1 ** 3, n1 ** 3)
