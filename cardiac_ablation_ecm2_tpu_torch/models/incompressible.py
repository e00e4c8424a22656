"""Incompressible neo-Hookean hyperelasticity, MFEM's ex19 (counterpart of
``cardiac_ablation_ecm2_tpu/models/incompressible.py``).

Only the Lagrangian is written,

    L(u, p) = ∫ W_dev(F) + p (J − 1),    F = I + ∇u,

on a Taylor–Hood pair (vector H1_p × H1_{p−1}, one shared quadrature rule
of p + 2 points a direction); ``torch.func.grad`` gives the coupled
residual through the restriction's autograd Functions, and Newton's
tangent (``torch.func.jvp`` of the residual) the saddle-point operator,
solved by GMRES.  (``linalg/newton.gradient_tangent`` would build the
Hessian once a step, as hyperelastic and eikonal do, but on this
indefinite system GMRES then counts differently from JAX's by round-off:
35, 38, 44 against 36, 38, 42 on the one-hex uniaxial test.)
``device=None`` is the card.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.fespace import FESpace
from ..fem.geom_factors import adjugate, determinant
from ..fem.quadinterp import eval_grad, eval_values
from ..linalg.newton import newton
from ..utils.config import real_t, resolve_device


def dev_neo_hookean_W(F: torch.Tensor, mu: float) -> torch.Tensor:
    """Deviatoric neo-Hookean energy μ/2 (J^{-2/d} I₁ − d)."""
    d = F.shape[-1]
    I1 = torch.einsum("...ab,...ab->...", F, F)
    Js = torch.clamp_min(determinant(F), 1e-8)
    return 0.5 * mu * (Js ** (-2.0 / d) * I1 - d)


@dataclasses.dataclass(eq=False)
class IncompressibleHyperelastic:
    """Stationary point of L(u, p) with per-component essential BCs."""

    mesh: object
    order: int = 2
    mu: float = 1.0
    #: list of (component, bdr_attrs, value) roller/stretch constraints
    ess: Sequence = ()
    dtype: object = None
    device: object = None

    def __post_init__(self):
        mesh = self.mesh
        dim = mesh.dim
        dev = self.device = resolve_device(self.device)
        rt = real_t(self.dtype)
        self.sfes = FESpace(mesh, self.order)           # scalar components
        self.pfes = FESpace(mesh, max(self.order - 1, 1))
        self.dim = dim
        ns = self.sfes.ndof_scalar
        self.ns = ns
        self.nu = dim * ns
        self.np_ = self.pfes.ndof_scalar
        nq1d = self.order + 2                   # one shared rule
        self.gf = geom_factors_for(self.sfes, nq1d, self.dtype, dev)
        self.db_u = basis_for(self.sfes, self.dtype, dev, nq1d)
        self.db_p = basis_for(self.pfes, self.dtype, dev, nq1d)
        self.Ru = restriction_for(self.sfes, dev)
        self.Rp = restriction_for(self.pfes, dev)
        self._adj = adjugate(self.gf.jac)

        mask = np.ones(self.nu + self.np_)
        vals = np.zeros(self.nu + self.np_)
        for (comp, attrs, value) in self.ess:
            sd = self.sfes.essential_dofs(attrs)
            mask[sd + comp * ns] = 0.0
            vals[sd + comp * ns] = value
        self.mask = torch.as_tensor(mask, dtype=rt, device=dev)
        self.vals = torch.as_tensor(vals, dtype=rt, device=dev)

    def _grad_u(self, u_flat: torch.Tensor) -> torch.Tensor:
        """∇ₓu at the quadrature points, (ne, nq, c, s) = ∂u_c/∂x_s."""
        ns = self.ns
        cols = []
        for c in range(self.dim):
            ghat = eval_grad(self.db_u, self.Ru.mult(u_flat[c * ns:(c + 1) * ns]))
            cols.append((self._adj * ghat[..., :, None]).sum(-2)
                        / self.gf.det[..., None])
        return torch.stack(cols, dim=2)

    def lagrangian(self, x: torch.Tensor) -> torch.Tensor:
        u, p = x[: self.nu], x[self.nu:]
        F = self._grad_u(u) + torch.eye(self.dim, dtype=x.dtype, device=x.device)
        W = dev_neo_hookean_W(F, self.mu)
        pq = eval_values(self.db_p, self.Rp.mult(p))
        return torch.sum(self.gf.wdet * (W + pq * (determinant(F) - 1.0)))

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        r = torch.func.grad(self.lagrangian)(x)
        return r * self.mask + (x - self.vals) * (1 - self.mask)

    def solve(self, rel_tol=1e-9, max_iter=30, linear_max_iter=2000):
        return newton(self.residual, self.vals, rel_tol=rel_tol,
                      max_iter=max_iter, linear_solver="gmres",
                      linear_max_iter=linear_max_iter)

    def deformation_stats(self, x):
        """(min J, max J) over quadrature points."""
        F = self._grad_u(x[: self.nu]) + torch.eye(self.dim, dtype=x.dtype,
                                                   device=x.device)
        J = determinant(F)
        return float(J.min()), float(J.max())
