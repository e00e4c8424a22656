"""The distance function by p-Laplacian continuation, MFEM's ex40 class
(counterpart of ``cardiac_ablation_ecm2_tpu/models/eikonal.py``): the
p-torsion minimiser

    min E_p(u) = ∫ (|∇u|² + ε)^{p/2} / p − u,    u = 0 on ∂Ω,

tends to the distance to the boundary as p → ∞.  Only the energy is
written; ``torch.func.grad`` gives the p-Laplacian residual and its
Hessian through the gradient's graph (built once a Newton step) the
tangent, continued in p with warm starts.
``device=None`` is the card.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.fespace import FESpace
from ..fem.geom_factors import adjugate
from ..fem.quadinterp import eval_grad
from ..linalg.newton import gradient_tangent, newton
from ..ops.linearform import domain_lf
from ..utils.config import real_t, resolve_device


@dataclasses.dataclass(eq=False)
class EikonalSolver:
    mesh: object
    order: int = 2
    p_schedule: Sequence[float] = (2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)
    eps: float = 1e-12
    rel_tol: float = 1e-9
    dtype: object = None
    device: object = None

    def __post_init__(self):
        dev = self.device = resolve_device(self.device)
        self.fes = FESpace(self.mesh, self.order)
        self.gf = geom_factors_for(self.fes, dtype=self.dtype, device=dev)
        self.db = basis_for(self.fes, self.dtype, dev)
        self.R = restriction_for(self.fes, dev)
        self._adj = adjugate(self.gf.jac)
        mask = torch.ones(self.fes.ndof_scalar, dtype=real_t(self.dtype),
                          device=dev)
        mask[torch.as_tensor(self.fes.essential_dofs(), device=dev)] = 0.0
        self.mask = mask
        self.b1 = domain_lf(self.fes, 1.0, dtype=self.dtype, device=dev)
        #: Newton's info after each p of the schedule
        self.infos = []

    def _phys_grad(self, u):
        g = eval_grad(self.db, self.R.mult(u))
        return (self._adj * g[..., :, None]).sum(-2) / self.gf.det[..., None]

    def energy(self, u, p):
        g2 = torch.sum(self._phys_grad(u) ** 2, dim=-1)
        return (torch.sum(self.gf.wdet * (g2 + self.eps) ** (p / 2) / p)
                - torch.dot(self.b1, u))

    def solve(self):
        """The distance-function approximation (L-vector) after the p
        continuation, and the last Newton info."""
        m = self.mask
        u = torch.zeros_like(m)
        self.infos = []
        for p in self.p_schedule:
            def res(v, p=p):
                r = torch.func.grad(lambda w: self.energy(w, p))(v)
                return r * m + v * (1 - m)

            u, info = newton(res, u, rel_tol=self.rel_tol, max_iter=40,
                             linear_solver="cg", line_search=8,
                             tangent=lambda v, p=p: gradient_tangent(
                                 lambda w: self.energy(w, p), v, m))
            self.infos.append(info)
        return u, info
