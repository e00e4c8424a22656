"""Element restriction: L-vector ↔ E-vector (counterpart of
``cardiac_ablation_ecm2_tpu/fem/restriction.py``).

Both directions run on the ops of ``ops/block_gather.py``:

* L→E is a gather through the (ne, nd) gather map: ``gather_sum`` with one
  plane for the element-major layout, ``gather_transpose`` for the
  transposed (nd, ne) layout the lane-major applies consume
  (``ops/lanemajor.py``).
* A byNODES vector's components are contiguous (ndof,) slices: the vector
  E-vector (ne, nd, vdim) takes one gather and one segment-sum per
  component (``mult_vec``, ``mult_transpose_vec``).
* E→L is the sorted segment-sum of the JAX package's base restriction:
  the E-slots of every dof in ascending slot order (a stable counting sort
  by destination dof), summed in that order by ``segment_sum``, one slot
  list for each E-layout.  Hexes have multiplicity ≤ 8, order-2 tets of
  the cardiac mesh up to 46.  The fixed order and the absence of atomics
  make E→L deterministic.

Every direction is differentiable, through the kernels themselves: the
L→E gather and the E→L segment-sum over the same map are each other's
adjoints, so each is a ``torch.autograd.Function`` whose ``backward``
calls the other direction's Function (a gradient of a gradient, or the
jvp of a gradient that Newton's tangent is, goes through them again) and
whose ``jvp`` applies the same linear map to the tangent.  Their
``forward`` sees plain tensors, so on the card it launches the kernels.
``torch.func.linearize`` cannot trace them (a ctypes launch reads
``data_ptr()``); ``torch.func.jvp`` and ``torch.func.grad`` can.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.block_gather import gather_sum, gather_transpose, segment_sum
from ..utils.config import resolve_device
from ..utils.native import counting_argsort


def scatter_slots(flat: np.ndarray, ndof: int) -> Tuple[np.ndarray, np.ndarray]:
    """The E→L slot list of the E-slot → dof map ``flat``: int32 slots
    sorted by dof, ascending within a dof, and the (ndof + 1,) int64
    offsets of each dof's run."""
    flat = np.asarray(flat, dtype=np.int64)
    if flat.size > np.iinfo(np.int32).max:
        raise ValueError(f"{flat.size} E-slots do not fit int32 slot indices")
    order = counting_argsort(flat, int(ndof) + 1)
    offsets = np.zeros(int(ndof) + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat, minlength=ndof), out=offsets[1:])
    return order.astype(np.int32), offsets


def scatter_planes(flat: np.ndarray, ndof: int) -> np.ndarray:
    """The same slots as (max multiplicity, ndof) int32 planes for
    ``gather_sum``: plane k holds every dof's k-th slot, the sentinel
    ``flat.size`` where a dof has fewer."""
    order, offsets = scatter_slots(flat, ndof)
    counts = np.diff(offsets)
    planes = np.full((int(counts.max(initial=0)), ndof), np.size(flat), np.int32)
    for k in range(planes.shape[0]):
        sel = counts > k
        planes[k, sel] = order[offsets[:-1][sel] + k]
    return planes


class _LtoE(torch.autograd.Function):
    """L→E through the restriction ``r``: (ndof,) → (ne·nd,) flat
    element-major (``gather_sum``), or (nd, ne) with ``transposed``
    (``gather_transpose``)."""

    @staticmethod
    def forward(u, r, transposed):
        if transposed:
            return gather_transpose(u, r.gm)
        return gather_sum(u, r.g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.r, ctx.transposed = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _EtoL.apply(grad.contiguous().view(-1), ctx.r, ctx.transposed), None, None

    @staticmethod
    def jvp(ctx, du, _r, _t):
        return _LtoE.apply(du.contiguous(), ctx.r, ctx.transposed)


class _EtoL(torch.autograd.Function):
    """E→L sum through the restriction ``r``: a flat element-major E-vector
    (``slots``), or a flat (nd, ne) one with ``transposed`` (``slotsT``),
    → (ndof,) by ``segment_sum``."""

    @staticmethod
    def forward(u_e, r, transposed):
        return segment_sum(u_e, r.slotsT if transposed else r.slots, r.offsets)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.r, ctx.transposed = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _LtoE.apply(grad.contiguous(), ctx.r, ctx.transposed).view(-1), None, None

    @staticmethod
    def jvp(ctx, du, _r, _t):
        return _EtoL.apply(du.contiguous(), ctx.r, ctx.transposed)


class ElementRestriction:
    """The gather map and the E→L slot lists of one (ne, nd) gather map, on
    one device (``None``: the card)."""

    def __init__(self, gather_map: np.ndarray, ndof: int, device=None):
        device = resolve_device(device)
        gm = np.asarray(gather_map)
        self.ne, self.nd = gm.shape
        self.ndof = int(ndof)
        flat = gm.reshape(-1)
        slots, offsets = scatter_slots(flat, self.ndof)
        slotsT, _ = scatter_slots(gm.T.reshape(-1), self.ndof)

        def dev(a, dtype=np.int32):
            return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

        self.g = dev(flat[None, :])                 # (1, ne·nd)
        self.gm = self.g.view(self.ne, self.nd)     # the same map, (ne, nd)
        self.offsets = dev(offsets, np.int64)       # (ndof + 1,), both layouts
        self.slots = dev(slots)                     # (ne·nd,), (ne, nd) E-vector
        self.slotsT = dev(slotsT)                   # (nd·ne,), (nd, ne) E-vector

    def mult(self, u: torch.Tensor) -> torch.Tensor:
        """L→E: (ndof,) → (ne, nd)."""
        return _LtoE.apply(u, self, False).view(self.ne, self.nd)

    def mult_t(self, u: torch.Tensor) -> torch.Tensor:
        """L→E in the transposed layout: (ndof,) → (nd, ne)."""
        return _LtoE.apply(u, self, True)

    def mult_transpose(self, u_e: torch.Tensor) -> torch.Tensor:
        """E→L sum: (ne, nd) → (ndof,), deterministic."""
        return _EtoL.apply(u_e.reshape(-1), self, False)

    def mult_transpose_t(self, u_eT: torch.Tensor) -> torch.Tensor:
        """E→L sum from the transposed layout: (nd, ne) → (ndof,)."""
        return _EtoL.apply(u_eT.reshape(-1), self, True)

    def mult_vec(self, u: torch.Tensor, vdim: int) -> torch.Tensor:
        """L→E of a byNODES vector: (vdim·ndof,) → (ne, nd, vdim), one
        gather per component (each a contiguous (ndof,) slice)."""
        us = u.view(vdim, self.ndof)
        return torch.stack([self.mult(us[c]) for c in range(vdim)], dim=-1)

    def mult_transpose_vec(self, u_e: torch.Tensor) -> torch.Tensor:
        """E→L of a vector E-vector: (ne, nd, vdim) → (vdim·ndof,) byNODES,
        one segment-sum per component."""
        comps = u_e.permute(2, 0, 1).contiguous()
        return torch.cat([self.mult_transpose(comps[c])
                          for c in range(comps.shape[0])])
