"""The DG operators' route between elements and faces (no JAX module of its
own: the JAX package writes ``u[e0]`` and ``y.at[e0].add(...)`` inline in
``ops/dg_advection.py``, ``ops/dg_diffusion.py``, ``ops/dg_elasticity.py``,
``ops/hyperbolic.py`` and ``parallel/dg.py``).

An element array is viewed as (ne, width) rows, width = nd·(components).
A :class:`FaceSum` holds groups of element ids (the volume's identity, the
interior faces' two sides, the boundary faces, ...):

* :meth:`FaceSum.read` is the face read ``u[e]`` of one group, the
  ``take_rows`` kernel on the card (``ops/gather_probes.py``);
* :meth:`FaceSum.sum` sums the groups' contributions into the elements
  with ONE ``segment_sum`` (``ops/block_gather.py``): the flat source is
  the groups' values in group order, and the slot list
  (``fem/restriction.scatter_slots`` over their (element, node) targets)
  is built on the host once per set of groups present.  Each element
  entry sums its contributions in source order (the volume term first,
  then the faces in group and face order), with no atomics, so an apply
  repeats bit for bit.

A CPU tensor takes the kernels' plain versions, as everywhere in the port.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fem.restriction import scatter_slots
from .block_gather import segment_sum
from .gather_probes import take_rows


class FaceSum:
    """Face reads and the one segment-sum of a set of element-id groups."""

    def __init__(self, ne: int, width: int, groups: Sequence[np.ndarray], device):
        self.ne, self.width = int(ne), int(width)
        self.device = torch.device(device)
        self._groups = [np.asarray(g, dtype=np.int64) for g in groups]
        self.idx = [torch.as_tensor(g.astype(np.int32), device=self.device)
                    for g in self._groups]
        #: the (slots, offsets) built so far, by the groups they take
        self.slot_lists: Dict[Tuple[bool, ...], Tuple[torch.Tensor, torch.Tensor]] = {}

    def read(self, u: torch.Tensor, group: int) -> torch.Tensor:
        """Rows ``u[groups[group]]`` of the (ne, ...) element array ``u``
        (any row width) → (n, ...)."""
        rows = take_rows(u.reshape(u.shape[0], -1), self.idx[group])
        return rows.view(rows.shape[0], *u.shape[1:])

    def slots(self, present: Tuple[bool, ...]):
        """The (slots, offsets) of the groups marked in ``present``."""
        if present not in self.slot_lists:
            w = np.arange(self.width, dtype=np.int64)
            flat = np.concatenate([(g[:, None] * self.width + w).reshape(-1)
                                   for g, on in zip(self._groups, present) if on])
            self.slot_lists[present] = tuple(
                torch.as_tensor(a, device=self.device)
                for a in scatter_slots(flat, self.ne * self.width))
        return self.slot_lists[present]

    def sum(self, parts: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """Σ of each group's rows (n_g, ...) into its elements → (ne, ...)
        in one ``segment_sum``; a ``None`` part leaves its group out."""
        present = tuple(p is not None for p in parts)
        shape = next(p for p in parts if p is not None).shape[1:]
        src = torch.cat([p.reshape(-1) for p in parts if p is not None])
        slots, offsets = self.slots(present)
        return segment_sum(src, slots, offsets).view(self.ne, *shape)
