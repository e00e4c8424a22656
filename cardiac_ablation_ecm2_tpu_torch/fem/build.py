"""Per-space build products on a device (counterpart of
``cardiac_ablation_ecm2_tpu/fem/build.py``).  Nothing is cached: an
operator builds each once and keeps it.  ``device=None`` is the card."""

from __future__ import annotations

from ..utils.config import resolve_device
from .quadinterp import DeviceBasis, device_basis
from .restriction import ElementRestriction


def restriction_for(fes, device=None):
    """A Cartesian space's own gather-free ``StructuredRestriction`` (it
    holds no tensors and runs on the device of its argument), else the
    gather-plane ``ElementRestriction`` of the space's map on ``device``."""
    device = resolve_device(device)
    if hasattr(fes, "restriction"):
        return fes.restriction
    return ElementRestriction(fes.gather_map, fes.ndof_scalar, device)


def basis_for(fes, dtype=None, device=None) -> DeviceBasis:
    return device_basis(fes.d2q, dtype, device)
