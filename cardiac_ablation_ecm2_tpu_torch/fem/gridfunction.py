"""Grid-function operations: projection, values and gradients at quadrature
points, integration and error norms (counterpart of
``cardiac_ablation_ecm2_tpu/fem/gridfunction.py``).

A grid function is a flat dof vector (a tensor); the space interprets it.
Every function runs on the device of its tensor argument, with the space's
restriction, basis and geometric factors there (``fem/build.py``);
:func:`project` makes a new vector on ``device`` (``None``: the card).
Callables take the physical points as a tensor and are written with torch
operations.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..utils.config import real_t, resolve_device
from .build import basis_for, geom_factors_for, restriction_for
from .geom_factors import adjugate
from .quadinterp import eval_grad, eval_values


def project(fes, f: Callable, dtype=None, device=None) -> torch.Tensor:
    """Nodal interpolation of f(x) onto the space → (ndof,) L-vector."""
    kw = dict(dtype=real_t(dtype), device=resolve_device(device))
    vals = f(torch.as_tensor(fes.dof_coords, **kw))
    return torch.as_tensor(vals, **kw).reshape(-1)


def values_at_quad(fes, u: torch.Tensor, nq1d=None, dtype=None) -> torch.Tensor:
    """u_h at quadrature points → (ne, nq)."""
    db = basis_for(fes, dtype, u.device, nq1d)
    return eval_values(db, restriction_for(fes, u.device).mult(u))


def phys_grad_at_quad(fes, u: torch.Tensor, nq1d=None, dtype=None) -> torch.Tensor:
    """Physical gradient ∇_x u_h at quadrature points → (ne, nq, dim)."""
    db = basis_for(fes, dtype, u.device, nq1d)
    gf = geom_factors_for(fes, nq1d, dtype, u.device)
    g = eval_grad(db, restriction_for(fes, u.device).mult(u))   # reference grads
    # ∇_x = J^{-T} ∇_ξ = adjᵀ/det ∇_ξ
    return torch.einsum("eqab,eqa->eqb", adjugate(gf.jac), g) / gf.det[..., None]


def integrate(fes, q: torch.Tensor, nq1d=None, dtype=None) -> torch.Tensor:
    """∫ q dΩ for an (ne, nq) Q-vector."""
    gf = geom_factors_for(fes, nq1d, dtype, q.device)
    return torch.sum(gf.wdet * q)


def l2_error(fes, u: torch.Tensor, exact: Callable, nq1d=None, dtype=None):
    """‖u_h − exact‖_L2 by quadrature (ComputeL2Error)."""
    gf = geom_factors_for(fes, nq1d, dtype, u.device)
    uq = values_at_quad(fes, u, nq1d, dtype)
    eq = torch.as_tensor(exact(gf.x), dtype=uq.dtype, device=uq.device)
    return torch.sqrt(torch.sum(gf.wdet * (uq - eq) ** 2))


def h1_seminorm_error(fes, u: torch.Tensor, exact_grad: Callable, nq1d=None,
                      dtype=None):
    """|u_h − exact|_H1 by quadrature (ComputeH1Error)."""
    gf = geom_factors_for(fes, nq1d, dtype, u.device)
    gq = phys_grad_at_quad(fes, u, nq1d, dtype)
    eg = torch.as_tensor(exact_grad(gf.x), dtype=gq.dtype, device=gq.device)
    return torch.sqrt(torch.sum(gf.wdet * torch.sum((gq - eg) ** 2, dim=-1)))


def l2_norm(fes, u: torch.Tensor, nq1d=None, dtype=None):
    gf = geom_factors_for(fes, nq1d, dtype, u.device)
    uq = values_at_quad(fes, u, nq1d, dtype)
    return torch.sqrt(torch.sum(gf.wdet * uq ** 2))
