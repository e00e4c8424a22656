"""Poisson solver, the ex1 slice (counterpart of
``cardiac_ablation_ecm2_tpu/models/poisson.py``; MFEM's ``ex1 -pa``): an
H1 space, the partially assembled diffusion operator, essential boundary
conditions through ``form_linear_system`` and PCG with one of the JAX
package's device preconditioners:

* ``"jacobi"``: the assembled diagonal;
* ``"chebyshev"``: order-4 Chebyshev-Jacobi on the constrained operator
  (``linalg/smoothers.chebyshev``, its eigenvalue bound from a seeded
  20-step power method, as in the JAX package).  It can report a false
  convergence: where λ_max(D⁻¹A) exceeds the estimate by more than
  1.1 + 1/30, the smoother's polynomial is negative at the top of the
  spectrum, the preconditioner is indefinite, and CG stops on a negative
  (r, z) with ``converged`` set.  On the 995,336-hex cardiac mesh in
  float64 the ratio is 1.1337 and the solve stops after 84 iterations
  with a true relative residual of 2.85 (``profile_step.py
  chebyshev126`` on an NVIDIA H100); check the true residual, or pass a safe bound to
  ``linalg/smoothers.chebyshev`` directly;
* ``"lor"``: the all-device LOR multigrid (``ops/lor_device``), hex
  spaces only (a tet space raises ``ValueError``, as in the JAX package);
* ``None``: plain CG.

Hex and tet spaces both run: the operator is ``BilinearForm.assemble``'s
(lane-major or affine apply).

It runs eagerly on ``device`` (``None``: the card), one host read per CG
iteration (and per coarse CG iteration inside each LOR V-cycle).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import torch

from ..fem.fespace import FESpace
from ..fem.gridfunction import project
from ..linalg.smoothers import chebyshev, jacobi
from ..linalg.solvers import cg
from ..ops.bilinearform import BilinearForm
from ..ops.linearform import domain_lf
from ..ops.operators import form_linear_system
from ..utils.config import elapsed, real_t, resolve_device


@dataclasses.dataclass
class PoissonResult:
    """The solution and its solve.  ``setup_seconds`` holds ``space``,
    ``operator`` (assembly, right-hand side, constrained system) and
    ``preconditioner``; ``solve_seconds`` the PCG; ``multigrid`` the LOR
    multigrid (its V-cycle count and setup split) for ``"lor"``."""

    fes: FESpace
    u: torch.Tensor
    iterations: int
    final_norm: float
    converged: bool
    setup_seconds: dict = dataclasses.field(default_factory=dict)
    solve_seconds: float = 0.0
    multigrid: object = None


def solve(
    mesh,
    order: int = 2,
    rhs: object = 1.0,
    kappa: object = None,
    ess_bdr: Optional[Sequence[int]] = None,
    bc: Optional[Callable] = None,
    rel_tol: float = 1e-12,
    max_iter: int = 2000,
    preconditioner: Optional[str] = "jacobi",
    dtype=None,
    device=None,
    fes=None,
) -> PoissonResult:
    """Solve −∇·(κ∇u) = rhs with u = bc on the marked boundary attributes
    (``None``: all of them).  ``rhs`` and ``kappa`` are scalars or callables
    of the physical points (written with torch operations), ``bc`` a
    callable; ``fes`` may be a prebuilt order-``order`` space on ``mesh``.
    With ``"chebyshev"``, ``converged`` can be false convergence (in float64
    on the 995,336-hex cardiac mesh it is): the module docstring says why
    and what to check."""
    if preconditioner not in ("jacobi", "chebyshev", "lor", None):
        raise ValueError(preconditioner)
    device = resolve_device(device)
    seconds = {}
    t0 = time.perf_counter()
    if fes is None:
        fes = FESpace(mesh, order)
    seconds["space"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    A = BilinearForm(fes, device).add_domain_integrator(
        "diffusion", kappa).assemble(dtype).operator()
    b = domain_lf(fes, rhs if callable(rhs) or rhs is None else float(rhs),
                  dtype=dtype, device=device)
    ess = fes.essential_dofs(ess_bdr)
    if bc is not None:
        x0 = project(fes, bc, dtype, device)
    else:
        x0 = torch.zeros(fes.ndof, dtype=real_t(dtype), device=device)
    Ac, B = form_linear_system(A, ess, x0, b)
    diag = Ac.diagonal()
    seconds["operator"] = elapsed(t0, device)

    t0 = time.perf_counter()
    mg = None
    if preconditioner == "jacobi":
        M = jacobi(diag)
    elif preconditioner == "chebyshev":
        M = chebyshev(Ac.mult, diag)
    elif preconditioner == "lor":
        from ..ops.lor_device import make_lor_multigrid

        mg = make_lor_multigrid(fes, kappa if kappa is not None else 1.0,
                                ess_bdr=ess_bdr, dtype=dtype, device=device)
        M = mg.preconditioner()
    else:
        M = None
    seconds["preconditioner"] = elapsed(t0, device)

    t0 = time.perf_counter()
    x, info = cg(Ac.mult, B, x0=x0, M=M, rel_tol=rel_tol, max_iter=max_iter)
    solve_s = elapsed(t0, device)
    return PoissonResult(fes=fes, u=x, iterations=info.iterations,
                         final_norm=info.final_norm, converged=info.converged,
                         setup_seconds=seconds, solve_seconds=solve_s,
                         multigrid=mg)
