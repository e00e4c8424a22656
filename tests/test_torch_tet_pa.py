"""The port's tet partial-assembly path against the JAX package, float64 on
the CPU, on the cardiac tet mesh n=5 (327 tets, 634 dofs at order 2) with
the benchmark's quadrature (quad_extra 0): the geometric affine detector,
the dense lane-major basis and reference matrices, the bioheat operator on
the affine and the lane-major paths (the latter with ``affine_collapse``
"off" in both packages, restored after) over three SDIRK33 steps, the
explicit stage ``mult`` under forward Euler and RK4, ``qdata_bf16``,
``PAOperator`` on tets, ``cg_merged``, the RF solve and the coupled app,
and every ODE solver JAX's ``select`` accepts.

Host arrays are held to 1e-12 relative (or exactly), states after the CG
solves to 1e-10, and every CG solve must take as many iterations as JAX's.
JAX's stage and explicit solves are written out and jitted over the
operator's arrays (one compile per array layout), so that their counts are
visible."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.fem import geom_factors as jgfm
from cardiac_ablation_ecm2_tpu.fem.build import basis_for as jbasis_for
from cardiac_ablation_ecm2_tpu.linalg import ode as jode
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_hex_mesh as jhex
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_tet_mesh as jtet
from cardiac_ablation_ecm2_tpu.models import ablation as jab
from cardiac_ablation_ecm2_tpu.models import bioheat as jbio
from cardiac_ablation_ecm2_tpu.models import rf_laplace as jrf
from cardiac_ablation_ecm2_tpu.ops import bilinearform as jbf
from cardiac_ablation_ecm2_tpu.ops import lanemajor as jlane
from cardiac_ablation_ecm2_tpu.utils.config import config as jcfg
from cardiac_ablation_ecm2_tpu.utils.config import configure as jconfigure
from cardiac_ablation_ecm2_tpu_torch.fem import geom_factors as tgfm
from cardiac_ablation_ecm2_tpu_torch.fem.build import basis_for as tbasis_for
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import ode as tode
from cardiac_ablation_ecm2_tpu_torch.linalg import solvers as tsolvers
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh as thex
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_tet_mesh as ttet
from cardiac_ablation_ecm2_tpu_torch.models import ablation as tab
from cardiac_ablation_ecm2_tpu_torch.models import bioheat as tbio
from cardiac_ablation_ecm2_tpu_torch.models import rf_laplace as trf
from cardiac_ablation_ecm2_tpu_torch.ops import bilinearform as tbf
from cardiac_ablation_ecm2_tpu_torch.ops import lanemajor as tlane
from cardiac_ablation_ecm2_tpu_torch.utils.config import config as tcfg
from cardiac_ablation_ecm2_tpu_torch.utils.config import configure as tconfigure

L = 0.04
KW = dict(lengths=(L, L, L / 2), electrode_radius=0.004)
N = 5
DT = 0.25
RTOL = 1e-10
CTR = (L / 2, L / 2, L / 4)
#: the bench's Pennes settings on the tet mesh's attributes (1 body,
#: 2 electrode, 3 ground), all held at T_a
PARAMS = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0, ess_bdr=[1, 2, 3],
              rel_tol=1e-5, max_iter=300, dtype="float64", theta_form=True)
ABLATION = dict(order=2, electrode_bdr=[2], ground_bdr=[3], body_bdr=[1],
                sigma=0.54, voltage=30.0, w_cb=2e4, rel_tol=1e-11)


def _src(exp):
    def src(x):
        r2 = sum((x[..., i] - CTR[i]) ** 2 for i in range(3))
        return 2e7 * exp(-r2 / (2 * 0.004 ** 2))
    return src


@pytest.fixture(scope="module", autouse=True)
def _bench_config():
    """quad_extra 0 in both packages (bench.py's setting), one torch thread;
    the previous values come back afterwards."""
    n = torch.get_num_threads()
    old = jcfg.quad_extra, tcfg.quad_extra
    torch.set_num_threads(1)
    jconfigure(quad_extra=0)
    tconfigure(quad_extra=0)
    yield
    jconfigure(quad_extra=old[0])
    tconfigure(quad_extra=old[1])
    torch.set_num_threads(n)


def _affine(mode):
    """``affine_collapse`` set to ``mode`` in both packages; returns the
    previous values for :func:`_restore`."""
    old = jcfg.affine_collapse, tcfg.affine_collapse
    jconfigure(affine_collapse=mode)
    tconfigure(affine_collapse=mode)
    return old


def _restore(old):
    jconfigure(affine_collapse=old[0])
    tconfigure(affine_collapse=old[1])


def close(a, b, rtol=RTOL):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


@pytest.fixture(scope="module")
def spaces():
    """The JAX and the port space on the cardiac tet mesh n=5, order 2."""
    jfes, tfes = JFESpace(jtet(N, **KW), 2), FESpace(ttet(N, **KW), 2)
    assert np.array_equal(tfes.gather_map, jfes.gather_map)
    return jfes, tfes


class _JaxSolves:
    """JAX ``BioheatOperator.implicit_solve`` and ``mult`` written out and
    jitted with γ, T and the operator's big arrays traced, so that each
    solve's CG count is visible."""

    def __init__(self, base_op):
        self.base, self.iters = base_op, []

        def pcg(op, apply, diag, rhs):
            mask = op.ess_mask

            def lhs(v):
                z = v * mask
                return apply(z) * mask + (v - z)

            if op.has_ess:
                diag = diag * mask + (1.0 - mask)
            inv = 1.0 / diag
            x, info = jsolvers.cg(lhs, rhs, M=lambda r: inv * r,
                                  rel_tol=op.rel_tol, max_iter=op.max_iter,
                                  dot=op._dot())
            return op._zero_ess(x), info.iterations

        def stage(gamma, T, big):
            op = base_op.override(**big)
            rhs = op._zero_ess(op.residual(T))
            return pcg(op, lambda v: op._implicit_lhs_apply(gamma, v),
                       op.Mrc_diag + gamma * op.A_diag, rhs)

        def explicit(T, big):
            op = base_op.override(**big)
            return pcg(op, op._Mrc_apply, op.Mrc_diag,
                       op._zero_ess(op.residual(T)))

        self._stage, self._explicit = jax.jit(stage), jax.jit(explicit)

    def implicit_solve(self, gamma, t, T):
        k, n = self._stage(gamma, T, jbio.big_arrays(self.base))
        self.iters.append(int(n))
        return k

    def mult(self, t, T):
        k, n = self._explicit(T, jbio.big_arrays(self.base))
        self.iters.append(int(n))
        return k


def _run(f, solver, T, steps, dt=DT):
    t = 0.0
    for _ in range(steps):
        T, t = solver.step(f, T, t, dt)
    return T


def _jax_op(jfes, **extra):
    return jbio.BioheatOperator(fes=jfes, q_met=_src(jnp.exp), **PARAMS, **extra)


def _port_op(tfes, **extra):
    return tbio.BioheatOperator(tfes, q_met=_src(torch.exp), device="cpu",
                                **PARAMS, **extra)


@pytest.fixture(scope="module")
def affine_ops(spaces):
    """The JAX and the port tet operator on the (default) affine path."""
    jfes, tfes = spaces
    return _jax_op(jfes), _port_op(tfes)


@pytest.fixture(scope="module")
def lane_ops(spaces):
    """The JAX and the port tet operator with the affine collapse off (the
    lane-major per-point apply)."""
    jfes, tfes = spaces
    old = _affine("off")
    try:
        return _jax_op(jfes), _port_op(tfes)
    finally:
        _restore(old)


# -- geometry, basis -------------------------------------------------------

def test_affine_factors_equal_jax(spaces):
    jfes, tfes = spaces
    jJ = jgfm.affine_element_jacobians(jfes.mesh)
    tJ = tgfm.affine_element_jacobians(tfes.mesh)
    assert tJ.shape == (tfes.mesh.ne, 3, 3)
    close(tJ, jJ, 1e-15)
    for a, b in zip(tgfm.affine_packed_factors(tJ), jgfm.affine_packed_factors(jJ)):
        close(a, b, 1e-14)
    for a, b in zip(tgfm._np_det_adj(tJ), jgfm._np_det_adj(jJ)):
        close(a, b, 1e-14)
    # hexes are not affine by construction
    assert tgfm.affine_element_jacobians(thex(3, **KW)) is None
    assert jgfm.affine_element_jacobians(jhex(3, **KW)) is None


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dense_lane_basis_and_affine_ops_equal_jax(spaces, dtype):
    """The dense lane-major matrices equal JAX's bit for bit, and the
    reference matrices, formed in float64 from the device-dtype basis, too."""
    jfes, tfes = spaces
    jdb, tdb = jbasis_for(jfes, dtype=dtype), tbasis_for(tfes, dtype, "cpu")
    assert tlane.supports(tdb) and jlane.supports(jdb)
    jlb, tlb = jlane.lane_basis(jdb), tlane.lane_basis(tdb)
    assert tlb.S.shape == (4 * 27, 10)
    for a, b in [(tlb.Bf, jlb.Bf), (tlb.S, jlb.S), (tlb.SG, jlb.SG)] + list(
            zip(tlb.G, jlb.G)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    jaf, taf = jlane.affine_ops(jdb), tlane.affine_ops(tdb, tlb)
    for a, b in [(taf.Mhat, jaf.Mhat)] + list(zip(taf.Khat, jaf.Khat)):
        assert np.array_equal(a.numpy(), np.asarray(b))


# -- the bioheat operator --------------------------------------------------

def _three_steps(jop, top):
    T0 = np.zeros(jop.fes.ndof)
    f = _JaxSolves(jop)
    jT = _run(f, jode.select("sdirk33"), jnp.asarray(T0), 3)
    top.cg_iterations.clear()
    tT = _run(top, tode.select("sdirk33"), torch.as_tensor(T0), 3)
    assert top.cg_iterations == f.iters and len(f.iters) == 9
    close(tT, jT)
    assert float(jnp.max(jT)) > 0.1
    return jT


@pytest.mark.parametrize("path", ["affine", "lane"])
def test_tet_operator_matches_jax(request, path):
    """Setup arrays and three SDIRK33 steps of the port's own tet operator
    and of one built from the JAX operator's arrays (``from_jax_arrays``)."""
    jop, top = request.getfixturevalue(f"{path}_ops")
    assert (top._aff is not None) == (jop._aff is not None) == (path == "affine")
    assert top._lane is not None and jop._lane is not None
    for name in ("b_const", "Mrc_diag", "A_diag", "ess_mask"):
        close(getattr(top, name), getattr(jop, name), 1e-12)
    if path == "affine":
        for name in ("_dm", "_dw", "_dk"):
            close(getattr(top, name), getattr(jop, name), 1e-14)
    _three_steps(jop, top)
    arrays = {k: np.asarray(v) for k, v in jbio.big_arrays(jop).items()
              if k != "restr"}
    arrays["gather_map"] = np.asarray(jop.fes.gather_map)
    assert ("_dk" in arrays) == (path == "affine")
    params = {k: PARAMS[k] for k in ("rel_tol", "max_iter", "dtype")}
    lop = tbio.from_jax_arrays(top.fes, arrays, device="cpu", **params)
    assert (lop._aff is not None) == (path == "affine")
    _three_steps(jop, lop)


@pytest.mark.parametrize("name", ["forward_euler", "rk4"])
def test_explicit_mult_matches_jax(affine_ops, name):
    """One explicit step (the M_ρc solve in each stage) from a warm θ."""
    jop, top = affine_ops
    theta = np.random.default_rng(3).uniform(0.0, 0.5, jop.fes.ndof)
    theta *= np.asarray(jop.ess_mask)
    f = _JaxSolves(jop)
    jT = _run(f, jode.select(name), jnp.asarray(theta), 1, dt=0.01)
    top.cg_iterations.clear()
    tT = _run(top, tode.select(name), torch.as_tensor(theta), 1, dt=0.01)
    assert top.cg_iterations == f.iters and len(f.iters) == (
        1 if name == "forward_euler" else 4)
    close(tT, jT)
    # the JAX operator's own mult gives the same stage
    close(top.mult(0.0, torch.as_tensor(theta)),
          jop.mult(0.0, jnp.asarray(theta)))


def test_qdata_bf16_matches_jax(spaces, lane_ops):
    """``qdata_bf16`` on the lane-major path (the affine one streams no
    qdata, so neither package casts there).  The port's cast of JAX's
    float64 K_qd (through ``from_jax_arrays``) has the bits of JAX's
    ``astype(bfloat16)``, and a step on it matches JAX's.  The port's own
    setup differs from JAX's float64 K_qd by round-off, which moves a value
    on a bfloat16 rounding tie by one bfloat16 ulp (and flips the sign of
    round-off-sized values), and by no more.""" 
    jfes, tfes = spaces
    jlane_op, tlane_op = lane_ops
    top_aff = _port_op(tfes, qdata_bf16=True)
    assert top_aff._aff is not None and top_aff.K_qd.dtype == torch.float64
    old = _affine("off")
    try:
        jop = _jax_op(jfes, qdata_bf16=True)
        top = _port_op(tfes, qdata_bf16=True)
    finally:
        _restore(old)
    assert top.K_qd.dtype == torch.bfloat16 and top._qkT.dtype == torch.bfloat16
    close(tlane_op.K_qd, jlane_op.K_qd, 1e-12)
    jbits = np.asarray(jop.K_qd).view(np.int16)
    jk = np.asarray(jop.K_qd).astype(np.float64)
    tk = top.K_qd.double().numpy()
    assert (np.abs(tk - jk) <= 2.0 ** -8 * np.abs(jk)
            + 1e-12 * np.abs(jk).max()).all()
    arrays = {k: np.asarray(v) for k, v in jbio.big_arrays(jop).items()
              if k not in ("restr", "_qkT", "_qmT", "_qwT")}
    arrays["K_qd"] = np.asarray(jlane_op.K_qd)           # float64, uncast
    lop = tbio.from_jax_arrays(tfes, arrays, device="cpu", qdata_bf16=True,
                               **{k: PARAMS[k] for k in ("rel_tol", "max_iter",
                                                         "dtype")})
    assert lop.K_qd.dtype == torch.bfloat16
    assert np.array_equal(lop.K_qd.view(torch.int16).numpy(), jbits)
    theta = np.random.default_rng(4).uniform(0.0, 0.5, jfes.ndof)
    theta *= np.asarray(jop.ess_mask)
    f = _JaxSolves(jop)
    jT = _run(f, jode.select("sdirk33"), jnp.asarray(theta), 1)
    tT = _run(lop, tode.select("sdirk33"), torch.as_tensor(theta), 1)
    assert lop.cg_iterations == f.iters
    close(tT, jT)


def test_merged_cg_stage_equals_classic(spaces, affine_ops):
    """``cg_variant="merged"`` takes the classic solve's iterations in
    every stage and lands within 1e-10 (the same iterates in exact
    arithmetic)."""
    _, tfes = spaces
    _, top = affine_ops
    mop = _port_op(tfes, cg_variant="merged")
    T0 = torch.zeros(tfes.ndof, dtype=torch.float64)
    top.cg_iterations.clear()
    a = _run(top, tode.select("sdirk33"), T0, 2)
    b = _run(mop, tode.select("sdirk33"), T0, 2)
    assert mop.cg_iterations == top.cg_iterations
    close(b, a.numpy())
    with pytest.raises(ValueError):
        _port_op(tfes, cg_variant="pipelined")


def test_elem_mask_on_the_affine_path(spaces):
    """With ``elem_mask`` the vertex factors of inactive elements are zero,
    so the affine path applies what the per-point path does (the JAX
    package's vertex factors keep the masked elements; ROADMAP Queue 3)."""
    _, tfes = spaces
    mask = (np.arange(tfes.mesh.ne) % 7 != 0).astype(np.float64)
    ess = np.unique(tfes.gather_map[mask == 0])
    kw = dict(elem_mask=mask, ess_dofs=ess)
    aop = _port_op(tfes, **kw)
    old = _affine("off")
    try:
        lop = _port_op(tfes, **kw)
    finally:
        _restore(old)
    assert aop._aff is not None and lop._aff is None
    v = torch.as_tensor(np.random.default_rng(7).standard_normal(tfes.ndof))
    close(aop._stage_apply(0.1)(v), lop._stage_apply(0.1)(v).numpy(), 1e-12)
    close(aop.residual(v), lop.residual(v).numpy(), 1e-12)


# -- PAOperator, cg_merged -------------------------------------------------

@pytest.fixture(scope="module")
def pa_ops(spaces):
    jfes, tfes = spaces
    jA = jbf.BilinearForm(jfes).add_domain_integrator("mass", 2.0e3) \
        .add_domain_integrator("diffusion", 0.7).assemble()
    tA = tbf.BilinearForm(tfes, "cpu").add_domain_integrator("mass", 2.0e3) \
        .add_domain_integrator("diffusion", 0.7).assemble("float64")
    return jA, tA


def test_pa_operator_on_tets_matches_jax(spaces, pa_ops):
    """Both terms affine from the geometry; also the lane-major per-point
    group with the affine collapse off, and a callable coefficient."""
    jfes, tfes = spaces
    jA, tA = pa_ops
    assert [k for k, _ in tA.lane.aff_terms] == ["mass", "diffusion"]
    assert len(jA.lane.aff_terms) == 2 and tA.lane.terms == ()
    for (_, a), (_, b) in zip(tA.lane.aff_terms, jA.lane.aff_terms):
        close(a, b, 1e-14)
    u = np.random.default_rng(5).standard_normal(jfes.ndof)
    tu = torch.as_tensor(u)
    close(tA.mult(tu), jA.mult(jnp.asarray(u)), 1e-12)
    close(tA.diagonal(), jA.diagonal(), 1e-12)
    old = _affine("off")
    try:
        jB = jbf.BilinearForm(jfes).add_domain_integrator("mass", 2.0e3) \
            .add_domain_integrator("diffusion", 0.7).assemble()
        tB = tbf.BilinearForm(tfes, "cpu").add_domain_integrator("mass", 2.0e3) \
            .add_domain_integrator("diffusion", 0.7).assemble("float64")
    finally:
        _restore(old)
    assert tB.lane.aff_terms == () and len(tB.lane.terms) == 2
    close(tB.mult(tu), jB.mult(jnp.asarray(u)), 1e-12)
    close(tB.mult(tu), tA.mult(tu).numpy(), 1e-12)
    jC = jbf.BilinearForm(jfes).add_domain_integrator(
        "diffusion", lambda x: 1.0 + x[..., 0] * 10).assemble()
    tC = tbf.BilinearForm(tfes, "cpu").add_domain_integrator(
        "diffusion", lambda x: 1.0 + x[..., 0] * 10).assemble("float64")
    close(tC.mult(tu), jC.mult(jnp.asarray(u)), 1e-12)


@pytest.mark.parametrize("check", [True, False])
def test_cg_merged_matches_jax(spaces, pa_ops, check):
    """``cg_merged`` on the tet operator with Jacobi: the same iterates and
    count as JAX's, and with ``check_convergence=False`` exactly max_iter
    iterations."""
    jfes, _ = spaces
    jA, tA = pa_ops
    b = np.random.default_rng(6).standard_normal(jfes.ndof)
    jd, td = jA.diagonal(), tA.diagonal()
    kw = dict(rel_tol=1e-9, max_iter=200 if check else 25,
              check_convergence=check)
    jx, jinfo = jsolvers.cg_merged(jA.mult, jnp.asarray(b),
                                   M=lambda r: r / jd, **kw)
    tx, tinfo = tsolvers.cg_merged(tA.mult, torch.as_tensor(b),
                                   M=lambda r: r / td, **kw)
    assert tinfo.iterations == int(jinfo.iterations)
    assert tinfo.converged == bool(jinfo.converged)
    assert tinfo.converged if check else tinfo.iterations == 25
    close(tx, jx)
    if check:      # classic CG reaches the same solution
        cx, _ = tsolvers.cg(tA.mult, torch.as_tensor(b), M=lambda r: r / td,
                            rel_tol=1e-9, max_iter=200)
        close(tx, cx.numpy(), 1e-8)


# -- the RF solve and the coupled app --------------------------------------

def test_rf_solve_and_ablation_steps_match_jax(spaces):
    """The RF solve (PAOperator, Jacobi-PCG) and two steps of the coupled
    app on the tet mesh: Φ, SAR, T and Ω within 1e-10, equal CG counts."""
    jsim = jab.AblationSim(mesh=jtet(N, **KW), **ABLATION)
    tsim = tab.AblationSim(mesh=ttet(N, **KW), dtype="float64", device="cpu",
                           **ABLATION)
    assert (tsim.rf.iterations, tsim.rf.converged) == (
        int(jsim.rf.iterations), bool(jsim.rf.converged))
    close(tsim.rf.phi, jsim.rf.phi)
    close(tsim.rf.sar_q, jsim.rf.sar_q)
    close(trf.total_power(tsim.fes, tsim.rf.sar_q),
          jrf.total_power(jsim.fes, jsim.rf.sar_q))
    assert (tsim.op._aff is not None) and (jsim.op._aff is not None)
    f = _JaxSolves(jsim.op)
    cT = _run(f, jode.select("sdirk33"), jsim.initial_state()[0], 2, dt=0.5)
    jT, jom = jsim.initial_state()
    tT, tom = tsim.initial_state()
    t = 0.0
    for _ in range(2):
        jT, jom, t = jsim.step(jT, jom, t, 0.5)
        tT, tom, _ = tsim.step(tT, tom, t - 0.5, 0.5)
    close(cT, jT, 1e-13)
    assert tsim.op.cg_iterations == f.iters and len(f.iters) == 6
    close(tT, jT)
    close(tom, jom)
    assert float(jnp.max(jT)) > 37.01 and float(jnp.max(jom)) > 0


def test_sigma_T_resolve_on_tets_matches_jax(spaces):
    """One σ(T) re-solve on the tet mesh (``RFOperator``: the element-major
    diffusion apply on the dense basis) from a warm temperature."""
    jfes, tfes = spaces
    kw = dict(electrode_bdr=[2], ground_bdr=[3], voltage=30.0, rel_tol=1e-10)
    jr = jrf.RFOperator(fes=jfes, **kw)
    tr = trf.RFOperator(fes=tfes, dtype="float64", device="cpu", **kw)
    rng = np.random.default_rng(8)
    sig = 0.54 * (1.0 + 0.2 * rng.uniform(size=(jfes.mesh.ne, 27)))
    phi0 = np.array(jr.phi0)
    jphi, jsar, jinfo = jr.resolve(jnp.asarray(sig), jnp.asarray(phi0))
    tphi, tsar, tinfo = tr.resolve(torch.as_tensor(sig), torch.as_tensor(phi0))
    assert tinfo.iterations == int(jinfo.iterations) > 0
    close(tphi, jphi)
    close(tsar, jsar)


# -- the ODE family --------------------------------------------------------

class _Linear:
    """du/dt = A u + g(t) split as stiff A u (implicit) plus g (explicit),
    with the exact implicit solve; JAX's side on numpy arrays, the port's
    on tensors."""

    def __init__(self, lib):
        rng = np.random.default_rng(9)
        Q = rng.standard_normal((6, 6))
        A = -(Q @ Q.T) - 0.5 * np.eye(6)
        self.lib = lib
        self.A = A if lib is np else torch.as_tensor(A)
        self.I = np.eye(6) if lib is np else torch.eye(6, dtype=torch.float64)

    def _g(self, t, u):
        return 0.0 * u + math.cos(t)

    def mult(self, t, u):
        return self.A @ u + self._g(t, u)

    def mult_explicit(self, t, u):
        return self._g(t, u)

    def implicit_solve(self, gamma, t, u):
        rhs = self.A @ u + self._g(t, u)
        M = self.I - gamma * self.A
        return (np.linalg.solve(M, rhs) if self.lib is np
                else torch.linalg.solve(M, rhs))


SOLVERS = (sorted(jode._REGISTRY) + sorted(jode._IDS) + ["imex_euler", "imex_rk2"]
           + [f"ab{k}" for k in range(1, 6)] + [f"am{k}" for k in range(1, 5)])


@pytest.mark.parametrize("which", SOLVERS)
def test_ode_solver_matches_jax(which):
    """Six steps of each solver JAX's ``select`` accepts (by name and by
    MFEM id; the multistep ones past their RK4 bootstrap) on a small stiff
    linear system, to 1e-13."""
    u0 = np.linspace(0.5, 1.5, 6)
    js, ts = jode.select(which), tode.select(which)
    assert type(ts).__name__ == type(js).__name__
    jf, tf = _Linear(np), _Linear(torch)
    ju, tu, t = u0.copy(), torch.as_tensor(u0), 0.0
    for _ in range(6):
        ju, jt = js.step(jf, ju, t, 0.05)
        tu, tt = ts.step(tf, tu, t, 0.05)
        assert tt == jt
        t = jt
    assert isinstance(tu, torch.Tensor)
    close(tu, ju, 1e-13)


def test_function_operator_matches_jax():
    jf = jode.FunctionOperator(lambda t, u: -2.0 * u + t)
    tf = tode.FunctionOperator(lambda t, u: -2.0 * u + t)
    u0 = np.array([1.0, 2.0])
    close(tf.implicit_solve(0.1, 0.3, torch.as_tensor(u0)),
          jf.implicit_solve(0.1, 0.3, u0), 1e-14)
    close(tf.mult(0.3, torch.as_tensor(u0)), jf.mult(0.3, u0), 1e-15)
    for name in ("rk4", "sdirk34", "esdirk33"):
        jt, tt = jode.select(name).tableau, tode.select(name).tableau
        assert np.array_equal(tt.a, jt.a) and tt.is_explicit == jt.is_explicit
