"""Per-space build products on a device (counterpart of
``cardiac_ablation_ecm2_tpu/fem/build.py``).  ``device=None`` is the card.

The restriction and the geometric factors are kept on the space itself, one
per (device) and per (quadrature, dtype, device): the RF solve, the bioheat
operator and the Arrhenius damage of the ablation app share them, as the JAX
package's memoized functions let them.  They live as long as the space.
"""

from __future__ import annotations

from typing import Optional

from ..utils.config import real_t, resolve_device
from .fespace import element_node_coords
from .geom_factors import GeometricFactors, compute_geometric_factors
from .quadinterp import DeviceBasis, device_basis
from .restriction import ElementRestriction


def _kept(fes, name: str, key, make):
    """``make()`` once per ``key``, kept in ``fes.<name>``."""
    cache = fes.__dict__.setdefault(name, {})
    if key not in cache:
        cache[key] = make()
    return cache[key]


def restriction_for(fes, device=None):
    """A Cartesian space's own gather-free ``StructuredRestriction`` (it
    holds no tensors and runs on the device of its argument), else the
    gather-plane ``ElementRestriction`` of the space's map on ``device``,
    built once per device."""
    device = resolve_device(device)
    if hasattr(fes, "restriction"):
        return fes.restriction
    return _kept(fes, "_restrictions", device, lambda: ElementRestriction(
        fes.gather_map, fes.ndof_scalar, device))


def basis_for(fes, dtype=None, device=None, nq1d: Optional[int] = None) -> DeviceBasis:
    return device_basis(fes.dof_to_quad(nq1d), dtype, device)


def geom_factors_for(fes, nq1d: Optional[int] = None, dtype=None,
                     device=None) -> GeometricFactors:
    """Isoparametric geometric factors at the space's quadrature rule (or
    ``nq1d`` points per direction), built once per (nq1d, dtype, device)."""
    device = resolve_device(device)
    dt = real_t(dtype)
    return _kept(fes, "_geom_factors", (nq1d, dt, device),
                 lambda: compute_geometric_factors(
                     element_node_coords(fes.mesh, fes.order),
                     fes.dof_to_quad(nq1d), dt, device))
