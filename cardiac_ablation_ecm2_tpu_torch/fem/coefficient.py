"""Coefficients evaluated at quadrature points (counterpart of
``cardiac_ablation_ecm2_tpu/fem/coefficient.py``).

* ``None`` → no coefficient
* python scalar / 0-d array → constant, broadcast to (ne, nq)
* callable ``f(x)`` with ``x`` the (ne, nq, sdim) tensor of physical
  quadrature points → evaluated there (write it with torch operations)
* array or tensor of shape (ne, nq) → a precomputed Q-vector, taken as is
  (cast to the working dtype and moved to the factors' device); a grid
  function becomes one through ``gridfunction.values_at_quad``
* piecewise constant by element attribute → :func:`attribute_coefficient`

Vector coefficients (velocities, loads) go through :func:`eval_vector_coeff`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import real_t, resolve_device
from .geom_factors import GeometricFactors


def eval_coeff(coeff, gf: GeometricFactors, dtype=None):
    """Evaluate a scalar coefficient to an (ne, nq) Q-vector (or None)."""
    if coeff is None:
        return None
    kw = dict(dtype=real_t(dtype), device=gf.det.device)
    if callable(coeff):
        return torch.as_tensor(coeff(gf.x), **kw)
    arr = torch.as_tensor(coeff, **kw)
    if arr.ndim == 0:
        return arr.expand(gf.det.shape)
    return arr


def eval_vector_coeff(coeff, gf: GeometricFactors, dtype=None) -> torch.Tensor:
    """Evaluate a vector coefficient to an (ne, nq, k) Q-vector: a callable
    of x, a constant vector (k,), or an (ne, nq, k) array."""
    kw = dict(dtype=real_t(dtype), device=gf.det.device)
    if callable(coeff):
        return torch.as_tensor(coeff(gf.x), **kw)
    arr = torch.as_tensor(coeff, **kw)
    if arr.ndim == 1:
        return arr[None, None, :].expand(*gf.det.shape, arr.shape[0])
    return arr


def attribute_coefficient(values: dict, default=0.0):
    """Piecewise constant by element attribute (PWConstCoefficient).

    Returns ``make(attributes (ne,), nq, dtype=None, device=None)`` → the
    (ne, nq) Q-vector, ``values[attr]`` on elements of attribute ``attr`` and
    ``default`` elsewhere; ``device=None`` is the card."""

    def make(attributes: np.ndarray, nq: int, dtype=None, device=None):
        attributes = np.asarray(attributes)
        out = np.full(len(attributes), default, dtype=float)
        for attr, v in values.items():
            out[attributes == attr] = v
        arr = torch.as_tensor(out, dtype=real_t(dtype),
                              device=resolve_device(device))
        return arr[:, None].expand(len(attributes), nq)

    return make
