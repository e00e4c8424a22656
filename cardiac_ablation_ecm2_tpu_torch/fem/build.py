"""Per-space build products on a device (counterpart of
``cardiac_ablation_ecm2_tpu/fem/build.py``, with the boundary-face
factors of ``_bdr_geom_cached`` in its ``ops/bilinearform.py`` and
``_bdr_geom`` in its ``ops/linearform.py``).  ``device=None`` is the card.

The restrictions and the geometric factors are kept on the space itself,
one per (device) and per (quadrature, dtype, device): the RF solve, the
bioheat operator and the Arrhenius damage of the ablation app share them,
as the JAX package's memoized functions let them; so are the DG face
tables (host numpy, one per quadrature).  They live as long as the space.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.config import real_t, resolve_device
from .basis import make_dof_to_quad
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


def bdr_restriction_for(fes, device=None) -> ElementRestriction:
    """The boundary faces' restriction into the volume's scalar L-dofs
    (``fes.bdr_gather_map``), built once per device."""
    device = resolve_device(device)
    return _kept(fes, "_bdr_restrictions", device, lambda: ElementRestriction(
        fes.bdr_gather_map, fes.ndof_scalar, device))


def bdr_mesh(mesh):
    """The boundary faces as a mesh of their own (quads or triangles,
    through their Q1/P1 map)."""
    from ..mesh.mesh import Mesh

    return Mesh(geom=mesh.bdr_geom, vertices=mesh.vertices,
                elements=mesh.boundary, attributes=mesh.bdr_attributes,
                boundary=np.zeros((0, 1), dtype=np.int64),
                bdr_attributes=np.zeros(0, dtype=np.int64))


def bdr_dof_to_quad(fes, nq1d: Optional[int] = None):
    """The boundary faces' basis at ``nq1d`` points per direction (default
    p + 2, as the JAX package)."""
    return make_dof_to_quad(fes.mesh.bdr_geom, fes.order, nq1d or (fes.order + 2))


def bdr_marker_mask(mesh, marker, dtype, device) -> torch.Tensor:
    """0/1 per boundary face: its attribute is in ``marker``."""
    sel = np.isin(mesh.bdr_attributes, np.asarray(list(marker)))
    return torch.as_tensor(sel, dtype=dtype, device=device)


def bdr_geom_for(fes, nq1d: Optional[int] = None, dtype=None, device=None):
    """(GeometricFactors, DeviceBasis) of the boundary faces
    (:func:`bdr_mesh`, :func:`bdr_dof_to_quad`), built once per (nq1d,
    dtype, device).  The face Jacobians are 3×2: ``det`` is the surface
    measure."""
    device = resolve_device(device)
    dt = real_t(dtype)

    def make():
        d2q = bdr_dof_to_quad(fes, nq1d)
        X = element_node_coords(bdr_mesh(fes.mesh), fes.order)
        return (compute_geometric_factors(X, d2q, dt, device),
                device_basis(d2q, dt, device))

    return _kept(fes, "_bdr_geom", (nq1d, dt, device), make)


def face_data_for(fes, nq1d: Optional[int] = None, with_gradients: bool = False):
    """The DG face tables of the space's mesh and order
    (``fem/faces.build_face_data``, host numpy), built once per nq1d and
    kept on the space: the operators of one space (advection, SIPG, BR2,
    elasticity, the sharded setups) share them.  A request without
    gradients takes the tables with gradients when those exist."""
    from .faces import build_face_data

    cache = fes.__dict__.setdefault("_face_data", {})
    if not with_gradients and (nq1d, True) in cache:
        return cache[(nq1d, True)]
    return _kept(fes, "_face_data", (nq1d, with_gradients), lambda: build_face_data(
        fes.mesh, fes.order, nq1d, with_gradients=with_gradients))


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
