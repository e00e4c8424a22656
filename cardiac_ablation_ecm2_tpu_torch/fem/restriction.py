"""Element restriction: L-vector ↔ E-vector (counterpart of
``cardiac_ablation_ecm2_tpu/fem/restriction.py``).

Both directions run on one op, ``ops/block_gather.gather_sum``:

* L→E is one gather plane: the flattened gather map, for the element-major
  (ne, nd) layout or for the transposed (nd, ne) layout the lane-major
  applies consume (``ops/lanemajor.py``).
* E→L is a destination-sorted gather-sum over multiplicity planes: plane j
  holds, for every dof, its j-th E-slot in ascending slot order (a stable
  counting sort by destination dof); a dof with fewer than j+1 slots points
  at the sentinel slot, which reads zero.  Hexes have multiplicity ≤ 8,
  order-2 tets of the cardiac mesh up to 46.
  The fixed order and the absence of atomics make E→L deterministic.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.block_gather import gather_sum
from ..utils.config import resolve_device
from ..utils.native import counting_argsort


def scatter_planes(flat: np.ndarray, ndof: int) -> np.ndarray:
    """(max multiplicity, ndof) int32 planes for the E→L sum of the E-slot
    → dof map ``flat``; the sentinel is ``flat.size``."""
    flat = np.asarray(flat, dtype=np.int64)
    order = counting_argsort(flat, int(ndof) + 1)
    counts = np.bincount(flat, minlength=ndof)
    starts = np.zeros(ndof + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    planes = np.full((int(counts.max(initial=0)), ndof), flat.size, np.int32)
    for k in range(planes.shape[0]):
        sel = counts > k
        planes[k, sel] = order[starts[:-1][sel] + k]
    return planes


class ElementRestriction:
    """Gather/scatter planes of one (ne, nd) gather map, on one device
    (``None``: the card)."""

    def __init__(self, gather_map: np.ndarray, ndof: int, device=None):
        device = resolve_device(device)
        gm = np.asarray(gather_map)
        self.ne, self.nd = gm.shape
        self.ndof = int(ndof)
        flat = gm.reshape(-1)
        flatT = gm.T.reshape(-1)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=device)

        self.g = dev(flat[None, :])                      # (1, ne·nd)
        self.gT = dev(flatT[None, :])                    # (1, nd·ne)
        self.s = dev(scatter_planes(flat, self.ndof))    # (J, ndof)
        self.sT = dev(scatter_planes(flatT, self.ndof))

    def mult(self, u: torch.Tensor) -> torch.Tensor:
        """L→E: (ndof,) → (ne, nd)."""
        return gather_sum(u, self.g).view(self.ne, self.nd)

    def mult_t(self, u: torch.Tensor) -> torch.Tensor:
        """L→E in the transposed layout: (ndof,) → (nd, ne)."""
        return gather_sum(u, self.gT).view(self.nd, self.ne)

    def mult_transpose(self, u_e: torch.Tensor) -> torch.Tensor:
        """E→L sum: (ne, nd) → (ndof,), deterministic."""
        return gather_sum(u_e.reshape(-1), self.s)

    def mult_transpose_t(self, u_eT: torch.Tensor) -> torch.Tensor:
        """E→L sum from the transposed layout: (nd, ne) → (ndof,)."""
        return gather_sum(u_eT.reshape(-1), self.sT)
