"""The port's energy-based nonlinear models against the JAX package,
float64 on the CPU:

* ``models/hyperelastic.py``: ``neo_hookean_W`` at random deformation
  gradients; on a 3D beam at order 2 the energy, the residual
  (``torch.func.grad`` through the restriction's autograd Functions
  against ``jax.grad``) and the tangent apply (``torch.func.jvp`` of the
  residual, and the once-built ``HyperelasticProblem.tangent`` that
  ``solve`` uses, against ``jax.linearize``) on the same vectors, to
  1e-10; the
  Newton solve on JAX's 2D beam with JAX's tiny load and on the 3D beam:
  equal Newton iterations and CG counts in every step, u to 1e-10; the
  small-strain solve within 5e-3 of the port's linear elasticity (JAX's
  ``test_small_strain_matches_linear_elasticity``);
* ``models/incompressible.py``: JAX's 2D shear and 3D uniaxial stretch at
  smaller sizes (GMRES Newton): equal Newton and GMRES counts, x to 1e-10,
  the volume kept;
* ``models/eikonal.py``: the p continuation on a 6×6 order-2 square
  (p = 2, 3, 4): equal Newton and CG counts at every p, u to 1e-10.

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
from cardiac_ablation_ecm2_tpu.models import eikonal as jeik
from cardiac_ablation_ecm2_tpu.models import hyperelastic as jhyp
from cardiac_ablation_ecm2_tpu.models import incompressible as jinc
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg.newton import jacobian_action
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2_tpu_torch.models import elasticity as telasticity
from cardiac_ablation_ecm2_tpu_torch.models import eikonal as teik
from cardiac_ablation_ecm2_tpu_torch.models import hyperelastic as thyp
from cardiac_ablation_ecm2_tpu_torch.models import incompressible as tinc
from test_torch_newton import jax_newton

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
    uj, ij = jp.solve(rel_tol=1e-10)
    inv = jp._prec_inv
    _, kj, its = jax_newton(jp.residual, jnp.zeros(jp.fes.ndof), rel_tol=1e-10,
                            max_iter=30, linear_max_iter=800, line_search=12,
                            precond=lambda u: (lambda r: inv * r))
    assert kj == int(ij.iterations)
    ut, it = tp.solve(rel_tol=1e-10)
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
    xj, ij = jp.solve(rel_tol=rel_tol)
    _, kj, its = jax_newton(jp.residual, jp.vals, rel_tol=rel_tol, max_iter=30,
                            linear_max_iter=2000, linear_solver="gmres")
    assert kj == int(ij.iterations)
    xt, it = tp.solve(rel_tol=rel_tol)
    assert it.converged and it.iterations == kj and list(it.linear_iterations) == its
    close(xt, xj)
    F = tp._grad_u(xt[: tp.nu]) + torch.eye(tp.dim, dtype=xt.dtype)
    assert abs(float(torch.sum(tp.gf.wdet * (determinant(F) - 1.0)))) < vol_tol
    assert np.allclose(tp.deformation_stats(xt), jp.deformation_stats(xj), rtol=1e-10)


def test_eikonal():
    sched = (2.0, 3.0, 4.0)
    js = jeik.EikonalSolver(jquad(6, 6), order=2, p_schedule=sched)
    ts = teik.EikonalSolver(make_cartesian_2d(6, 6), order=2, p_schedule=sched,
                            device="cpu")
    uj, ij = js.solve()
    ut, it = ts.solve()
    # JAX's continuation with every Newton step's CG count visible
    m = js.mask

    def res(v, p):
        return jax.grad(lambda w: js.energy(w, p))(v) * m + v * (1 - m)

    u = jnp.zeros(js.fes.ndof_scalar)
    for p, info in zip(sched, ts.infos):
        u, k, its = jax_newton(res, u, rel_tol=js.rel_tol, max_iter=40,
                               line_search=8, args=(jnp.float64(p),))
        assert (info.iterations, list(info.linear_iterations)) == (k, its), (p, info)
    assert it.converged and it.iterations == int(ij.iterations)
    close(ut, uj)
