"""Masked-lattice (inactive-element) support for structured spaces (numpy
copy of ``cardiac_ablation_ecm2_tpu/fem/masked_lattice.py``).

A carved lattice-topology geometry (the cardiac hex mesh's electrode notch,
``mesh/cardiac.make_cardiac_hex_lattice``) runs on the gather-free
``CartesianFESpace`` restriction: the removed elements' qdata is zeroed
(``BioheatOperator.elem_mask``), so their element matrices are exactly
zero, and every dof that is not strictly inside the kept region is pinned
as essential.  The operator on the free dofs is then the one assembled on
the carved mesh (same element contributions, same quadrature): equal by
construction, not an approximation.
"""

from __future__ import annotations

import numpy as np


def _axis_windows(n: int, p: int):
    """For each lattice index along an axis of n elements, the lowest and
    highest element touching it."""
    i = np.arange(p * n + 1)
    return np.maximum(0, (i - 1) // p), np.minimum(n - 1, i // p)


def _corner_windows(shape_n, order: int, keep: np.ndarray):
    """The (Nz, Ny, Nx) lattice's eight corner-element keep flags."""
    p = int(order)
    nx, ny, nz = (int(v) for v in shape_n)
    keep3 = np.asarray(keep, bool).reshape(nz, ny, nx)   # [ez, ey, ex]
    xw, yw, zw = (_axis_windows(n, p) for n in (nx, ny, nz))
    for ez in zw:
        for ey in yw:
            for ex in xw:
                yield keep3[np.ix_(ez, ey, ex)]


def masked_lattice_essential(shape_n, order: int, keep: np.ndarray,
                             outer_essential: bool = True) -> np.ndarray:
    """Essential dof ids of the carved problem on the FULL dof lattice.

    A dof is free iff every lattice element touching it is kept and, with
    ``outer_essential``, it is not on the outer box boundary; everything
    else (outer boundary, carved surface, dofs only inside the carved
    region) is pinned.  ``shape_n``: elements per axis (nx, ny, nz);
    ``keep``: (ne,) bool in the x-fastest element order.  Returns sorted
    int32 ids in the lattice numbering ``gx + Nx*(gy + Ny*gz)``."""
    if len(shape_n) != 3:
        raise NotImplementedError("masked lattice: 3D only")
    free = None
    for k in _corner_windows(shape_n, order, keep):
        free = k.copy() if free is None else free & k
    if outer_essential:
        interior = np.zeros_like(free)
        interior[1:-1, 1:-1, 1:-1] = True
        free &= interior
    return np.nonzero(~free.reshape(-1))[0].astype(np.int32)


def masked_lattice_active_count(shape_n, order: int, keep: np.ndarray) -> int:
    """Number of dofs touched by at least one kept element: the carved
    mesh's dof count, which a DOF/s figure counts."""
    active = None
    for k in _corner_windows(shape_n, order, keep):
        active = k.copy() if active is None else active | k
    return int(active.sum())
