"""Per-space build products on a device (counterpart of
``cardiac_ablation_ecm2_tpu/fem/build.py``).  Nothing is cached: an
operator builds each once and keeps it.  ``device=None`` is the card."""

from __future__ import annotations

from .quadinterp import DeviceBasis, device_basis
from .restriction import ElementRestriction


def restriction_for(fes, device=None) -> ElementRestriction:
    return ElementRestriction(fes.gather_map, fes.ndof_scalar, device)


def basis_for(fes, dtype=None, device=None) -> DeviceBasis:
    return device_basis(fes.d2q, dtype, device)
