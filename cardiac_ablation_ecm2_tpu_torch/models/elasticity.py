"""Linear elasticity, MFEM's ex2 (counterpart of
``cardiac_ablation_ecm2_tpu/models/elasticity.py``): a vector H1 space,
the ``ElasticityIntegrator`` (λ, μ), u = 0 on the fixed boundary
attributes and a traction ``force`` on the loaded ones
(``VectorBoundaryLFIntegrator``), solved by Jacobi-PCG on the constrained
system.  ``device=None`` is the card."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..fem.fespace import FESpace
from ..linalg.smoothers import jacobi
from ..linalg.solvers import cg
from ..ops.bilinearform import BilinearForm
from ..ops.linearform import boundary_lf_vector
from ..ops.operators import form_linear_system
from ..utils.config import real_t, resolve_device


@dataclasses.dataclass
class ElasticityResult:
    fes: FESpace
    u: torch.Tensor     # (ndof_scalar·vdim,) byNODES displacement
    iterations: int
    converged: bool

    def displacement(self) -> np.ndarray:
        """(ndof_scalar, vdim) displacement per node."""
        v = self.u.cpu().numpy().reshape(self.fes.vdim, self.fes.ndof_scalar)
        return v.T


def solve(
    mesh,
    order: int = 1,
    lam: object = 1.0,
    mu: object = 1.0,
    fixed_bdr: Sequence[int] = (1,),
    force_bdr: Sequence[int] = (2,),
    force=None,
    rel_tol: float = 1e-10,
    max_iter: int = 5000,
    dtype=None,
    device=None,
) -> ElasticityResult:
    """Cantilever: −div σ(u) = 0, u = 0 on ``fixed_bdr``, σ·n = ``force``
    (default (0, …, −0.01)) on ``force_bdr``."""
    device = resolve_device(device)
    dim = mesh.dim
    fes = FESpace(mesh, order, vdim=dim)
    if force is None:
        force = np.zeros(dim)
        force[-1] = -1.0e-2
    a = BilinearForm(fes, device).add_domain_integrator("elasticity",
                                                        coeff=(lam, mu))
    A = a.assemble(dtype).operator()
    b = boundary_lf_vector(fes, force, bdr_marker=force_bdr, dtype=dtype,
                           device=device)
    ess_scalar = fes.essential_dofs(fixed_bdr).astype(np.int64)
    ess = np.concatenate([ess_scalar + c * fes.ndof_scalar for c in range(dim)])
    x0 = torch.zeros(fes.ndof, dtype=real_t(dtype), device=device)
    Ac, B = form_linear_system(A, ess, x0, b)
    x, info = cg(Ac.mult, B, M=jacobi(Ac.diagonal()), rel_tol=rel_tol,
                 max_iter=max_iter)
    return ElasticityResult(fes=fes, u=x, iterations=info.iterations,
                            converged=info.converged)
