"""Order transfer between two spaces on one mesh (``_interp_db`` and
``PTransfer`` of ``cardiac_ablation_ecm2_tpu/fem/transfer.py``; MFEM's
``PRefinementTransferOperator``).

The transfer is element-local interpolation: the coarse basis evaluated at
the fine space's nodes, as the ``eval_values`` contraction of a
``DeviceBasis`` whose "quadrature points" are those nodes (per axis on
hexes, dense on tets), then averaged into the fine L-vector by the fine
dofs' multiplicity (exact for continuous data).  ``restrict_t`` is the
exact adjoint of ``prolongate``.  Both run through the two spaces'
restrictions (``fem/build.py``: the gather and segment-sum kernels on the
card).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.config import real_t, resolve_device
from .basis import h1_nodes, h1_nodes_1d, lagrange_matrices, simplex_basis_matrices
from .build import restriction_for
from .fespace import FESpace
from .geometry import DIMENSION, IS_TENSOR, Geometry
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
