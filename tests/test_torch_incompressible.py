"""The port's incompressible hyperelastic model (``models/incompressible.py``)
against the JAX package, float64 on the CPU: JAX's 2D shear and 3D
uniaxial stretch at smaller sizes (GMRES Newton): equal Newton and GMRES
counts, x to 1e-10, the volume kept."""

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_3d as jhex
from cardiac_ablation_ecm2_tpu.models import incompressible as jinc
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2_tpu_torch.models import incompressible as tinc
from test_torch_newton import jax_newton
from torch_threads import beside

RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


INCOMPRESSIBLE = {
    # JAX's 2D shear, at 2×2 and a shear of 0.1 (its 3×3 case at 0.3 runs
    # GMRES to its 2,000-iteration cap in two Newton steps)
    "shear 2d": ((2, 2), [(0, [1], 0.0), (1, [1], 0.0), (0, [3], 0.1), (1, [3], 0.0)],
                 1e-9, 1e-9),
    # JAX's uniaxial stretch, on one hex and a stretch of 1.2; at rel_tol
    # 1e-9 the fourth Newton step's GMRES starts from a residual at the
    # round-off floor (3e-15) and its count differs (48 against 54), as it
    # does at 1e-7; at 1e-5 Newton stops after three steps, with the volume
    # kept to 3.4e-8
    "uniaxial 3d": ((1, 1, 1), [(0, [5], 0.0), (0, [3], 0.2), (1, [2], 0.0),
                                (2, [1], 0.0)], 1e-5, 1e-7),
}


@pytest.mark.parametrize("case", sorted(INCOMPRESSIBLE))
def test_incompressible(case):
    from cardiac_ablation_ecm2_tpu_torch.fem.geom_factors import determinant

    shape, ess, rel_tol, vol_tol = INCOMPRESSIBLE[case]
    jm, tm = ((jquad(*shape), make_cartesian_2d(*shape)) if len(shape) == 2
              else (jhex(*shape), make_cartesian_3d(*shape)))
    jp = jinc.IncompressibleHyperelastic(jm, order=2, mu=1.0, ess=ess)
    tp = tinc.IncompressibleHyperelastic(tm, order=2, mu=1.0, ess=ess, device="cpu")

    # JAX's solve and its loop written out, each in a thread of its own
    solve_run = beside(lambda: jp.solve(rel_tol=rel_tol))
    newton_run = beside(lambda: jax_newton(
        jp.residual, jp.vals, rel_tol=rel_tol, max_iter=30, linear_max_iter=2000,
        linear_solver="gmres"))
    xt, it = tp.solve(rel_tol=rel_tol)
    (xj, ij), (_, kj, its) = solve_run.result(), newton_run.result()
    assert kj == int(ij.iterations)
    assert it.converged and it.iterations == kj and list(it.linear_iterations) == its
    close(xt, xj)
    F = tp._grad_u(xt[: tp.nu]) + torch.eye(tp.dim, dtype=xt.dtype)
    assert abs(float(torch.sum(tp.gf.wdet * (determinant(F) - 1.0)))) < vol_tol
    assert np.allclose(tp.deformation_stats(xt), jp.deformation_stats(xj), rtol=1e-10)
