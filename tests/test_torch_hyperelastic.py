"""The port's hyperelastic model against the JAX package, float64 on the
CPU (``models/hyperelastic.py``): ``neo_hookean_W`` at random
deformation gradients; on a 3D beam at order 2 the energy, the residual
(``torch.func.grad`` through the restriction's autograd Functions against
``jax.grad``) and the tangent apply (``torch.func.jvp`` of the residual,
and the once-built ``HyperelasticProblem.tangent`` that ``solve`` uses,
against ``jax.linearize``) on the same vectors, to 1e-10; the Newton solve
on JAX's 2D beam with JAX's tiny load and on the 3D beam: equal Newton
iterations and CG counts in every step, u to 1e-10; the small-strain solve
within 5e-3 of the port's linear elasticity (JAX's
``test_small_strain_matches_linear_elasticity``).  The incompressible
model is in ``test_torch_incompressible.py``, the eikonal one in
``test_torch_eikonal.py``.

The loads are small enough that full Newton steps lower ‖F‖: JAX's line
search keeps only steps that lower it, so at larger loads on a slender
beam it takes tiny steps for many iterations (the port does the same).
They are large enough that rel_tol·‖F0‖ lies above the residual's
round-off floor.  The 3D load, 2e-4, is one where every CG count agrees:
at 3e-4 and 1e-3 a count differs by one in some step, where the CG
residual crosses its threshold within round-off of the two packages'
contractions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_3d as jhex
from cardiac_ablation_ecm2_tpu.models import hyperelastic as jhyp
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg.newton import jacobian_action
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2_tpu_torch.models import elasticity as telasticity
from cardiac_ablation_ecm2_tpu_torch.models import hyperelastic as thyp
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


BEAM2D = dict(mesh=(8, 2, 4.0, 1.0), order=1,
              kw=dict(fixed_bdr=[4], force_bdr=[2], force=np.array([0.0, -1e-4])))
BEAM3D = dict(mesh=(4, 1, 1, 2.0), order=2,
              kw=dict(fixed_bdr=[5], force_bdr=[3], force=np.array([0.0, 0.0, -2e-4])))


def _beam(case):
    c = {"2d": BEAM2D, "3d": BEAM3D}[case]
    if case == "2d":
        jm, tm = jquad(*c["mesh"]), make_cartesian_2d(*c["mesh"])
    else:
        nx, ny, nz, sx = c["mesh"]
        jm, tm = jhex(nx, ny, nz, sx=sx), make_cartesian_3d(nx, ny, nz, sx=sx)
    jp = jhyp.HyperelasticProblem(fes=JFESpace(jm, c["order"], vdim=jm.dim), **c["kw"])
    tp = thyp.HyperelasticProblem(fes=FESpace(tm, c["order"], vdim=tm.dim),
                                  device="cpu", **c["kw"])
    return jp, tp


@pytest.fixture(scope="module")
def beams():
    return {case: _beam(case) for case in ("2d", "3d")}


def test_neo_hookean_W():
    rng = np.random.default_rng(0)
    F = np.eye(3) + 0.2 * rng.standard_normal((5, 7, 3, 3))
    close(thyp.neo_hookean_W(torch.as_tensor(F), 1.0, 10.0),
          jhyp.neo_hookean_W(jnp.asarray(F), 1.0, 10.0))
    assert abs(float(thyp.neo_hookean_W(torch.eye(2, dtype=torch.float64)[None, None],
                                        1.0, 10.0)[0, 0])) < 1e-14


def test_energy_residual_tangent(beams):
    """E, ∂E/∂u and the tangent apply against jax.grad / jax.linearize at a
    random displacement and direction on the 3D beam."""
    jp, tp = beams["3d"]
    rng = np.random.default_rng(1)
    u = 1e-2 * rng.standard_normal(tp.fes.ndof)
    v = rng.standard_normal(tp.fes.ndof)
    ut, vt = torch.as_tensor(u), torch.as_tensor(v)
    uj, vj = jnp.asarray(u), jnp.asarray(v)
    close(tp.energy(ut), jax.jit(jp.energy)(uj), 1e-12)
    close(tp.residual(ut), jax.jit(jp.residual)(uj))
    ref = jax.jit(lambda a, b: jax.linearize(jp.residual, a)[1](b))(uj, vj)
    close(jacobian_action(tp.residual, ut)(vt), ref)
    close(tp.tangent(ut)(vt), ref)
    close(tp.deformation_gradient(ut), jp.deformation_gradient(uj))
    close(tp._prec_inv, jp._prec_inv)


@pytest.mark.parametrize("case", ["2d", "3d"])
def test_solve(beams, case):
    jp, tp = beams[case]

    inv = jp._prec_inv
    # JAX's solve and its loop written out, each in a thread of its own
    solve_run = beside(lambda: jp.solve(rel_tol=1e-10))
    newton_run = beside(lambda: jax_newton(
        jp.residual, jnp.zeros(jp.fes.ndof), rel_tol=1e-10, max_iter=30,
        linear_max_iter=800, line_search=12, precond=lambda u: (lambda r: inv * r)))
    ut, it = tp.solve(rel_tol=1e-10)
    (uj, ij), (_, kj, its) = solve_run.result(), newton_run.result()
    assert kj == int(ij.iterations)
    assert it.converged and bool(ij.converged)
    assert it.iterations == kj and list(it.linear_iterations) == its, (it, its)
    assert it.iterations <= 4
    close(ut, uj)


def test_small_strain_matches_linear_elasticity(beams):
    jp, tp = beams["2d"]
    u, info = tp.solve(rel_tol=1e-10)
    lin = telasticity.solve(tp.fes.mesh, order=1, lam=10.0 - 2.0 / 2, mu=1.0,
                            fixed_bdr=[4], force_bdr=[2], force=BEAM2D["kw"]["force"],
                            rel_tol=1e-12, device="cpu")
    d_lin = lin.displacement()
    scale = np.abs(d_lin).max()
    assert scale > 1e-7
    assert np.abs(tp.displacement(u) - d_lin).max() / scale < 5e-3
