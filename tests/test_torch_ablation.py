"""The port's coupled RF-ablation app (``models/rf_laplace.py``,
``models/ablation.py`` and what they run: the partially assembled operator,
grid functions, the constrained system) against the JAX package, float64 on
the CPU: the 4³ box with plate electrodes (the JAX package's own test case)
and the cardiac hex mesh n=6 (electrode notch 2, ground pad 3, body 1).

Everything is held to 1e-10 relative (round-off in the contractions passes
through the CG solves; the Arrhenius rate is computed as exp(log A − Eₐ/RT)
where JAX multiplies by A), and every CG solve, RF and thermal stage, must
take as many iterations as JAX's.  JAX's stage solves run in
``_JaxStages``, its implicit stage written out and jitted over the
operator's arrays so that the counts are visible; its results are held to
the app's own jitted ``step`` / ``step_coupled`` as well."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.fem import gridfunction as jgf
from cardiac_ablation_ecm2_tpu.fem.build import basis_for as jbasis_for
from cardiac_ablation_ecm2_tpu.fem.build import geom_factors_for as jgeom_for
from cardiac_ablation_ecm2_tpu.fem.build import restriction_for as jrestr_for
from cardiac_ablation_ecm2_tpu.fem.quadinterp import eval_values as jeval_values
from cardiac_ablation_ecm2_tpu.fem.quadinterp import eval_values_t as jeval_values_t
from cardiac_ablation_ecm2_tpu.linalg import ode as jode
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_hex_mesh as jcardiac
from cardiac_ablation_ecm2_tpu.mesh.mesh import make_cartesian_3d as jcart
from cardiac_ablation_ecm2_tpu.models import ablation as jab
from cardiac_ablation_ecm2_tpu.models import bioheat as jbio
from cardiac_ablation_ecm2_tpu.models import rf_laplace as jrf
from cardiac_ablation_ecm2_tpu.ops import bilinearform as jbf
from cardiac_ablation_ecm2_tpu.ops import diffusion as jdiffusion
from cardiac_ablation_ecm2_tpu.ops import mass as jmass
from cardiac_ablation_ecm2_tpu_torch.fem import gridfunction as tgf
from cardiac_ablation_ecm2_tpu_torch.fem.coefficient import attribute_coefficient
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg.smoothers import jacobi
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
from cardiac_ablation_ecm2_tpu_torch.models import ablation as tab
from cardiac_ablation_ecm2_tpu_torch.models import rf_laplace as trf
from cardiac_ablation_ecm2_tpu_torch.ops import bilinearform as tbf
from cardiac_ablation_ecm2_tpu_torch.ops import lanemajor
from cardiac_ablation_ecm2_tpu_torch.ops.operators import identity

DT = 0.5
RTOL = 1e-10
#: mesh makers (JAX, port) and the app's boundary attributes per case
CASES = {
    "box": (lambda: jcart(4, 4, 4, 0.02, 0.02, 0.02),
            lambda: make_cartesian_3d(4, 4, 4, 0.02, 0.02, 0.02),
            dict(electrode_bdr=[6], ground_bdr=[1], sigma=0.5, voltage=60.0)),
    "cardiac": (lambda: jcardiac(6, lengths=(0.04, 0.04, 0.02),
                                 electrode_radius=0.004),
                lambda: make_cardiac_hex_mesh(6, lengths=(0.04, 0.04, 0.02),
                                              electrode_radius=0.004),
                dict(electrode_bdr=[2], ground_bdr=[3], sigma=0.54,
                     voltage=30.0)),
}
SIGMA_T = (lambda Tq: 0.54 * (1.0 + 0.015 * (Tq - 37.0)))
K_T = (lambda Tq: 0.54 * (1.0 + 0.02 * (Tq - 37.0)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


def _sims(case, **extra):
    """The JAX and the port simulation of one case (w_cb 2e4, body_bdr 1 on
    the cardiac mesh, rel_tol 1e-11)."""
    jm, tm, kw = CASES[case]
    kw = dict(kw, order=2, w_cb=2e4, rel_tol=1e-11,
              body_bdr=[1] if case == "cardiac" else None, **extra)
    return (jab.AblationSim(mesh=jm(), **kw),
            tab.AblationSim(mesh=tm(), dtype="float64", device="cpu", **kw))


@functools.lru_cache(maxsize=None)
def _plain_sims(case):
    """Sims without coupling, built once per module (the JAX setup compiles)."""
    return _sims(case)


class _JaxStages:
    """JAX ``BioheatOperator.implicit_solve`` written out and jitted with γ,
    T and the operator's big arrays traced (one compile per array layout),
    so each stage solve's CG count is visible."""

    def __init__(self, base_op):
        self.iters = []

        def stage(gamma, T, big):
            op = base_op.override(**big)
            rhs = op._zero_ess(op.residual(T))
            mask = op.ess_mask

            def lhs(v):
                z = v * mask
                return op._implicit_lhs_apply(gamma, z) * mask + (v - z)

            diag = op.Mrc_diag + gamma * op.A_diag
            if op.has_ess:
                diag = diag * mask + (1.0 - mask)
            inv = 1.0 / diag
            k, info = jsolvers.cg(lhs, rhs, M=lambda r: inv * r, rel_tol=op.rel_tol,
                                  max_iter=op.max_iter, dot=op._dot())
            return op._zero_ess(k), info.iterations

        self._solve = jax.jit(stage)

    def step(self, view, T, t, dt):
        """One SDIRK33 step of ``view`` (an override of the base operator)."""
        stages = self

        class Op:
            def implicit_solve(self, gamma, t, T):
                k, n = stages._solve(gamma, T, jbio.big_arrays(view))
                stages.iters.append(int(n))
                return k

        return jode.select("sdirk33").step(Op(), T, t, dt)


def _jax_view(jsim, T, sar_q):
    """The JAX app's ``_view`` (a closure there), written out."""
    op, fes = jsim.op, jsim.fes
    gf, restr, db = jgeom_for(fes), jrestr_for(fes), jbasis_for(fes)
    q = op.Mw_qd * jsim.T_a + gf.wdet * sar_q
    kw = dict(b_const=restr.mult_transpose(jeval_values_t(db, q)))
    if jsim.k_T is not None:
        K_qd = jdiffusion.setup_packed(gf, jsim.k_T(jeval_values(db, restr.mult(T))))
        kw["K_qd"] = K_qd
        kw["A_diag"] = restr.mult_transpose(jdiffusion.diagonal(db, K_qd)
                                            + jmass.diagonal(db, op.Mw_qd))
    return op.override(**kw)


@pytest.mark.parametrize("case", list(CASES))
def test_rf_solve_matches_jax(case):
    jm, tm, kw = CASES[case]
    jr = jrf.solve(jm(), 2, **kw)
    tr = trf.solve(tm(), 2, **kw, dtype="float64", device="cpu")
    assert (tr.iterations, tr.converged) == (int(jr.iterations), bool(jr.converged))
    close(tr.phi, jr.phi)
    close(tr.sar_q, jr.sar_q)
    close(trf.total_power(tr.fes, tr.sar_q),
          jrf.total_power(jr.fes, jr.sar_q))
    assert float(trf.total_power(tr.fes, tr.sar_q)) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax(case):
    """Three plain steps: T and Ω from the JAX app's jitted ``step``, the
    stage CG counts from ``_JaxStages``."""
    jsim, tsim = _plain_sims(case)
    assert (jsim.op._aff is None) == (tsim.op._aff is None) == (case == "cardiac")
    for name in ("b_const", "Mrc_diag", "A_diag"):
        close(getattr(tsim.op, name), getattr(jsim.op, name), 1e-12)
    jT, jom = jsim.initial_state()
    tT, tom = tsim.initial_state()
    stages = _JaxStages(jsim.op)
    cT, t = jT, 0.0
    tsim.op.cg_iterations.clear()
    for _ in range(3):
        cT, _ = stages.step(jsim.op, cT, t, DT)
        jT, jom, t = jsim.step(jT, jom, t, DT)
        tT, tom, _ = tsim.step(tT, tom, t - DT, DT)
    close(cT, jT, 1e-13)
    assert tsim.op.cg_iterations == stages.iters and len(stages.iters) == 9
    close(tT, jT)
    close(tom, jom)
    assert float(jnp.max(jom)) > 0 and float(jnp.max(jT)) > 37.01
    assert tsim.lesion_volume(tom) == jsim.lesion_volume(jom)


@pytest.mark.parametrize("case,coupling", [("cardiac", "sigma_T"), ("cardiac", "k_T"),
                                           ("box", "k_T")])
def test_coupled_run_matches_jax(case, coupling):
    """One plain step, then two coupled steps: σ(T) with a re-solve every
    step, or k(T).  The loop is the JAX app's ``run`` written out, so the
    re-solves' CG counts are visible; the end state must equal the app's own
    ``run``.  The coupling starts after a plain step because at the uniform
    T_a σ(T) is a constant, Φ does not change, and a re-solve there starts
    at its solution and iterates on round-off, whose CG count differs
    between summation orders."""
    extra = (dict(sigma_T=SIGMA_T, resolve_every=1) if coupling == "sigma_T"
             else dict(k_T=K_T))
    jsim, tsim = _sims(case, **extra)
    jT0, jom0, t0 = jsim.step(*jsim.initial_state(), 0.0, DT)
    jT, jom, t = jT0, jom0, t0
    phi, sar_q = jsim.rf.phi, jsim.rf.sar_q
    stages, rf_iters = _JaxStages(jsim.op), []
    for _ in range(2):
        if jsim.resolve_every:
            phi, sar_q, info = jsim.rf_op.resolve(jsim._sigma_q(jT), phi)
            rf_iters.append(int(info.iterations))
        T2, _ = stages.step(_jax_view(jsim, jT, sar_q), jT, t, DT)
        jT, jom, t = jsim.step_coupled(jT, jom, t, DT, sar_q)
        close(T2, jT, 1e-13)
    rT, rom, _ = jsim.run(t0 + 2 * DT, DT, jT0, jom0, t0=t0)
    close(jT, rT, 1e-13)
    tT, tom, tt = tsim.step(*tsim.initial_state(), 0.0, DT)
    tsim.op.cg_iterations.clear()
    tT, tom, tt = tsim.run(tt + 2 * DT, DT, tT, tom, t0=tt)
    assert tt == t
    assert tsim.op.cg_iterations == stages.iters and len(stages.iters) == 6
    close(tT, jT)
    close(tom, jom)
    if jsim.resolve_every:
        assert tsim.rf_op.cg_iterations == rf_iters and min(rf_iters) > 0
        close(tsim.phi, phi)
        close(tsim.sar_q, sar_q)


def test_from_jax_state_continues_a_jax_run():
    """A JAX σ(T) run of one step, carried into the port with
    ``from_jax_state``, continued for one step by both packages (re-solve
    warm-started from the carried Φ, then the coupled step)."""
    jsim, tsim = _sims("cardiac", sigma_T=SIGMA_T, resolve_every=1)
    jT, jom = jsim.initial_state()
    phi, sar_q, _ = jsim.rf_op.resolve(jsim._sigma_q(jT), jsim.rf.phi)
    jT, jom, t = jsim.step_coupled(jT, jom, 0.0, DT, sar_q)
    state = [np.asarray(a) for a in (jT, jom, phi, sar_q)]
    tT, tom, tphi, tsar = tab.from_jax_state(tsim, *state)
    assert tT.dtype == torch.float64 and tT.device.type == "cpu"

    phi, sar_q, info = jsim.rf_op.resolve(jsim._sigma_q(jT), phi)
    jT, jom, _ = jsim.step_coupled(jT, jom, t, DT, sar_q)
    tphi, tsar, tinfo = tsim.rf_op.resolve(tsim._sigma_q(tT), tphi)
    tT, tom, _ = tsim.step_coupled(tT, tom, t, DT, tsar)
    assert tinfo.iterations == int(info.iterations)
    for a, b in ((tphi, phi), (tsar, sar_q), (tT, jT), (tom, jom)):
        close(a, b)
    with pytest.raises(ValueError):
        tab.from_jax_state(tsim, state[0][:-1], state[1])


def test_float32_damage_is_finite_where_jax_is_nan():
    """One 0.5 s step on the 3³ unit cube in float32: JAX's A·exp(−Eₐ/RT)
    overflows A = 7.39e39 to inf and flushes the subnormal exponential to
    0, so every Ω is NaN; the port's exp(log A − Eₐ/RT) is finite and within
    1e-5 (of its largest value) of the port's float64 Ω."""
    kw = dict(order=2, sigma=0.54, voltage=30.0, electrode_bdr=[6], ground_bdr=[1])
    jsim = jab.AblationSim(mesh=jcart(3, 3, 3), dtype="float32", **kw)
    T, om = jsim.initial_state()
    _, jom, _ = jsim.step(T, om, 0.0, DT)
    assert bool(jnp.isnan(jom).all())
    out = []
    for dtype in ("float32", "float64"):
        sim = tab.AblationSim(mesh=make_cartesian_3d(3, 3, 3), dtype=dtype,
                              device="cpu", **kw)
        T, om = sim.initial_state()
        _, om, _ = sim.step(T, om, 0.0, DT)
        out.append(om.double().numpy())
    assert np.isfinite(out[0]).all() and out[1].max() > 1e-4
    close(out[0], out[1], 1e-5)


def test_gridfunction_and_pa_operator_match_jax():
    """``fem/gridfunction.py`` and ``BilinearForm.assemble`` (mass +
    diffusion, one per-point and one affine case) on both meshes."""
    for case in CASES:
        jm, tm, _ = CASES[case]
        jfes, tfes = JFESpace(jm(), 2), FESpace(tm(), 2)

        def f(x, lib):
            return lib.sin(40 * x[..., 0]) + x[..., 1] * x[..., 2] * 100

        ju = jgf.project(jfes, lambda x: f(x, np))
        tu = tgf.project(tfes, lambda x: f(x, torch), dtype="float64", device="cpu")
        close(tu, ju, 1e-14)
        close(tgf.values_at_quad(tfes, tu), jgf.values_at_quad(jfes, ju))
        close(tgf.phys_grad_at_quad(tfes, tu), jgf.phys_grad_at_quad(jfes, ju))
        q = tgf.values_at_quad(tfes, tu)
        close(tgf.integrate(tfes, q), jgf.integrate(jfes, jnp.asarray(q.numpy())))
        close(tgf.l2_norm(tfes, tu), jgf.l2_norm(jfes, ju))
        close(tgf.l2_error(tfes, tu, lambda x: f(x, torch) * 1.01),
              jgf.l2_error(jfes, ju, lambda x: f(x, jnp) * 1.01))
        close(tgf.h1_seminorm_error(tfes, tu, lambda x: x * 3.0),
              jgf.h1_seminorm_error(jfes, ju, lambda x: x * 3.0))

        jA = jbf.BilinearForm(jfes).add_domain_integrator("mass", 2.0) \
            .add_domain_integrator("diffusion", 0.7).assemble()
        tA = tbf.BilinearForm(tfes, "cpu").add_domain_integrator("mass", 2.0) \
            .add_domain_integrator("diffusion", 0.7).assemble("float64")
        assert (tA.lane.aff_terms == ()) == (jA.lane.aff_terms == ()) \
            == (case == "cardiac")
        close(tA.mult(tu), jA.mult(ju))
        if case == "box":        # the diffusion term alone, affine
            d = next(d for k, d in tA.lane.aff_terms if k == "diffusion")
            eT = tA.restr.mult_t(tu)
            close(lanemajor.affine_diffusion_apply(tA.lane.af, d, eT),
                  lanemajor.diffusion_apply(tA.lane.lb, lanemajor.transpose_qdata(
                      "diffusion", tA.terms[1].qdata), eT), 1e-12)
        close(tA.diagonal(), jA.diagonal())
        op = tA.operator()
        close((op + identity(tfes.ndof, "float64", "cpu")).diagonal(),
              jA.diagonal() + 1.0)
        close(jacobi(op.diagonal(), 0.5)(tu), 0.5 * ju / jA.diagonal())


def test_attribute_coefficient():
    make = attribute_coefficient({2: 5.0, 3: -1.0}, default=0.5)
    q = make(np.array([1, 2, 3, 2]), 4, "float64", "cpu")
    assert q.shape == (4, 4)
    assert q[:, 0].tolist() == [0.5, 5.0, -1.0, 5.0]
