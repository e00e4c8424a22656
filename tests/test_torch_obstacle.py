"""The port's obstacle solver (``linalg/obstacle.py``) against the JAX
package, float64 on the CPU: JAX's membrane on a flat obstacle (touching,
and one too deep to touch): equal outer and inner CG counts, u and λ
within 1e-10 (λ 1e-9)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.linalg.obstacle import obstacle_solve as jobstacle
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.ops import BilinearForm as JBilinearForm
from cardiac_ablation_ecm2_tpu.ops.linearform import domain_lf as jdomain_lf
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg.obstacle import obstacle_solve
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d
from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf
from test_torch_constrained import _one_thread, close  # noqa: F401 (a fixture)


def _obstacle(n, deep):
    out = []
    for fes, form, lf, arr in (
            (JFESpace(jquad(n, n), 1), JBilinearForm, jdomain_lf, jnp.asarray),
            (FESpace(make_cartesian_2d(n, n), 1), lambda f: BilinearForm(f, "cpu"),
             lambda f, c: domain_lf(f, c, device="cpu"), torch.as_tensor)):
        A = form(fes).add_domain_integrator("diffusion").assemble()
        b = lf(fes, -8.0)
        fm = np.zeros(fes.ndof_scalar)
        fm[fes.essential_dofs()] = 1.0
        psi = arr(np.full(fes.ndof_scalar, -10.0 if deep else -0.08))
        out.append((A, b, psi, arr(fm)))
    return out


@pytest.mark.parametrize("n,deep", [(12, False), (8, True)])
def test_obstacle(n, deep):
    (Aj, bj, pj, fj), (At, bt, pt, ft) = _obstacle(n, deep)
    uj, lj, oj = jobstacle(Aj.mult, bj, pj, diag=Aj.diagonal(), fixed_mask=fj)
    ut, lt, ot = obstacle_solve(At.mult, bt, pt, diag=At.diagonal(), fixed_mask=ft)
    assert ot == oj
    close(ut, uj)
    if deep:
        assert float(lt.abs().max()) == 0.0 and float(jnp.abs(lj).max()) == 0.0
    else:
        close(lt, lj, 1e-9)
        assert (lt.numpy() > 1e-10).any()
