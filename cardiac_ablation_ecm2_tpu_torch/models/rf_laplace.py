"""Electrostatic RF potential and SAR (Joule) heating (counterpart of
``cardiac_ablation_ecm2_tpu/models/rf_laplace.py``; MFEM's ``volta.cpp`` and
``joule.cpp``).

The quasi-static potential solves ∇·(σ∇Φ) = 0 with Φ = V₀ on the electrode
and Φ = 0 on the ground pad; the volumetric heat source is σ|∇Φ|² [W/m³].

:func:`solve` runs the partially assembled diffusion operator
(``BilinearForm.assemble``: lane-major or affine apply between the
restriction's L→E and E→L, the ``gather_sum`` kernel on a generic space);
:class:`RFOperator` re-solves with a conductivity Q-vector through the
element-major diffusion apply (``ops/diffusion.apply``, the
``fused_diffusion`` kernel on the card).  Both run eagerly (the JAX package
jits ``resolve``) with Jacobi-PCG, one host read per CG iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.coefficient import eval_coeff
from ..fem.fespace import FESpace
from ..fem.geom_factors import adjugate
from ..fem.gridfunction import phys_grad_at_quad, values_at_quad
from ..fem.quadinterp import eval_grad
from ..linalg.smoothers import jacobi
from ..linalg.solvers import cg
from ..ops import diffusion
from ..ops.bilinearform import BilinearForm
from ..ops.operators import form_linear_system
from ..utils.config import real_t, resolve_device


@dataclasses.dataclass
class RFResult:
    fes: object
    phi: torch.Tensor          # potential L-vector
    sar_q: torch.Tensor        # σ|∇Φ|² at quadrature points (ne, nq)
    iterations: int
    converged: bool


def _boundary(fes, electrode_bdr, ground_bdr):
    """Electrode dofs and all Dirichlet dofs (sorted, unique)."""
    ess_e = fes.essential_dofs(electrode_bdr)
    ess_g = fes.essential_dofs(ground_bdr)
    return ess_e, np.unique(np.concatenate([ess_e, ess_g]))


def solve(
    mesh,
    order: int = 2,
    sigma: object = 0.54,            # myocardium electrical conductivity [S/m]
    electrode_bdr: Sequence[int] = (1,),
    ground_bdr: Sequence[int] = (2,),
    voltage: float = 30.0,
    rel_tol: float = 1e-12,
    max_iter: int = 2000,
    dtype=None,
    fes=None,
    device=None,
) -> RFResult:
    """Solve ∇·(σ∇Φ) = 0, Φ = V₀ on the electrode, Φ = 0 on the ground;
    return Φ and the SAR.  ``fes`` may be a prebuilt space (a
    ``CartesianFESpace`` for the structured path); by default a generic
    ``FESpace``.  ``device=None`` is the card."""
    device = resolve_device(device)
    if fes is None:
        fes = FESpace(mesh, order)
    A = BilinearForm(fes, device).add_domain_integrator(
        "diffusion", sigma).assemble(dtype).operator()
    ess_e, ess = _boundary(fes, electrode_bdr, ground_bdr)
    kw = dict(dtype=real_t(dtype), device=device)
    x0 = torch.zeros(fes.ndof, **kw)
    x0[torch.as_tensor(ess_e, dtype=torch.int64, device=device)] = voltage
    Ac, B = form_linear_system(A, ess, x0, torch.zeros(fes.ndof, **kw))
    phi, info = cg(Ac.mult, B, x0=x0, M=jacobi(Ac.diagonal()), rel_tol=rel_tol,
                   max_iter=max_iter)
    return RFResult(fes=fes, phi=phi, sar_q=sar(fes, phi, sigma, dtype),
                    iterations=info.iterations, converged=info.converged)


@dataclasses.dataclass(eq=False)
class RFOperator:
    """Re-solvable electrostatic operator for a temperature-dependent σ(T)
    (joule.cpp's per-step field re-solve): ``resolve(sigma_q, phi0)`` solves
    with the conductivity Q-vector ``sigma_q``, warm-started from ``phi0``,
    and returns (Φ, σ|∇Φ|², SolveInfo).  Each solve appends its CG
    iteration count to ``cg_iterations``.  ``device=None`` is the card."""

    fes: object
    electrode_bdr: Sequence[int] = (1,)
    ground_bdr: Sequence[int] = (2,)
    voltage: float = 30.0
    rel_tol: float = 1e-10
    max_iter: int = 2000
    dtype: object = None
    device: object = None

    def __post_init__(self):
        self.device = dev = resolve_device(self.device)
        fes = self.fes
        self.gf = geom_factors_for(fes, None, self.dtype, dev)
        self.restr = restriction_for(fes, dev)
        self.db = basis_for(fes, self.dtype, dev)
        ess_e, ess = _boundary(fes, self.electrode_bdr, self.ground_bdr)
        kw = dict(dtype=real_t(self.dtype), device=dev)
        x_bc = torch.zeros(fes.ndof, **kw)
        x_bc[torch.as_tensor(ess_e, dtype=torch.int64, device=dev)] = self.voltage
        m = np.ones(fes.ndof)
        m[ess] = 0.0
        self.emask = torch.as_tensor(m, **kw)
        self.phi0 = self.x_bc = x_bc
        self.cg_iterations = []

    def resolve(self, sigma_q: torch.Tensor, phi0: torch.Tensor):
        """(σ at quadrature points, warm start) → (Φ, σ|∇Φ|² Q-vector,
        SolveInfo)."""
        gf, restr, db = self.gf, self.restr, self.db
        emask, x_bc = self.emask, self.x_bc
        qd = diffusion.setup_packed(gf, sigma_q)

        def raw(v):
            return restr.mult_transpose(diffusion.apply(db, qd, restr.mult(v)))

        def lhs(v):
            z = v * emask
            return raw(z) * emask + (v - z)

        # boundary values eliminated into the right-hand side
        b = (-raw(x_bc)) * emask + x_bc * (1.0 - emask)
        diag = restr.mult_transpose(diffusion.diagonal(db, qd))
        inv = 1.0 / (diag * emask + (1.0 - emask))
        phi0 = phi0 * emask + x_bc * (1.0 - emask)
        phi, info = cg(lhs, b, x0=phi0, M=lambda r: inv * r,
                       rel_tol=self.rel_tol, max_iter=self.max_iter)
        self.cg_iterations.append(info.iterations)
        g = eval_grad(db, restr.mult(phi))                  # reference grads
        gx = torch.einsum("eqab,eqa->eqb", adjugate(gf.jac), g) / gf.det[..., None]
        return phi, sigma_q * torch.sum(gx * gx, dim=-1), info

    def sigma_of_T_q(self, sigma_fn, T: torch.Tensor) -> torch.Tensor:
        """σ(T) at quadrature points from a nodal T."""
        return sigma_fn(values_at_quad(self.fes, T, dtype=self.dtype))


def sar(fes, phi: torch.Tensor, sigma=1.0, dtype=None) -> torch.Tensor:
    """Joule heating density σ|∇Φ|² at quadrature points → (ne, nq)."""
    g = phys_grad_at_quad(fes, phi, dtype=dtype)
    sq = eval_coeff(sigma, geom_factors_for(fes, None, dtype, phi.device), dtype)
    e2 = torch.sum(g * g, dim=-1)
    return e2 if sq is None else sq * e2


def total_power(fes, sar_q: torch.Tensor, dtype=None) -> torch.Tensor:
    """∫ σ|∇Φ|² dΩ, the delivered RF power [W]."""
    gf = geom_factors_for(fes, None, dtype, sar_q.device)
    return torch.sum(gf.wdet * sar_q)
