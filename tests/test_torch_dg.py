"""The port's DG operators (``ops/dg_advection``, ``ops/dg_diffusion`` with
BR2, ``models/advection_diffusion``, ``ops/face_sum`` and the ex9 example)
against the JAX package, float64 on the CPU.

Tolerances: one apply, diagonal or right-hand side within 1e-12 of JAX's
largest entry (the port sums a side's face terms on the face and every
term into the elements in one segment-sum, JAX one ``.at[].add`` per
term: 1e-15 apart, measured); RK trajectories and solutions within 1e-10;
CG counts equal.  The spaces are shared through ``_spaces`` and JAX's
loops are jitted once a test.
"""

import functools

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem.fespace import L2FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import ode
from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.models.advection_diffusion import (
    DGAdvectionDiffusion,
)
from cardiac_ablation_ecm2_tpu_torch.ops import face_sum
from cardiac_ablation_ecm2_tpu_torch.ops.dg_advection import DGAdvection, project_l2
from cardiac_ablation_ecm2_tpu_torch.ops.dg_diffusion import DGDiffusion, DGDiffusionBR2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = dict(device="cpu")
MESHES = {
    "quad": (lambda m: m.make_cartesian_2d(5, 4), 2),
    "tri": (lambda m: m.make_cartesian_2d_tri(3, 3), 2),
    "hex": (lambda m: m.make_cartesian_3d(3, 2, 2), 2),
    "tet": (lambda m: m.make_cartesian_3d_tet(2, 2, 2), 1),
}


@functools.lru_cache(maxsize=None)
def _spaces(kind, n=None, p=None):
    """(JAX L2 space, port L2 space) of a MESHES kind, or of the n × n
    quad mesh at order p."""
    from cardiac_ablation_ecm2_tpu import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.fem.fespace import L2FESpace as JL2

    if n is not None:
        return JL2(jmesh.make_cartesian_2d(n, n), p), L2FESpace(
            tmesh.make_cartesian_2d(n, n), p)
    make, p = MESHES[kind]
    return JL2(make(jmesh), p), L2FESpace(make(tmesh), p)


def _vel_np(x):
    x = np.asarray(x)
    v = np.zeros(x.shape)
    v[..., 0], v[..., 1] = 1.0, 0.5
    if x.shape[-1] == 3:
        v[..., 2] = -0.3
    return v


def _vel_t(x):
    v = torch.zeros_like(x)
    v[..., 0], v[..., 1] = 1.0, 0.5
    if x.shape[-1] == 3:
        v[..., 2] = -0.3
    return v


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def _pulse_np(x):
    x = np.asarray(x)
    return np.exp(-((x[..., 0] - 0.3) ** 2 + (x[..., 1] - 0.3) ** 2) / 0.005)


def _pulse_t(x):
    return torch.exp(-((x[..., 0] - 0.3) ** 2 + (x[..., 1] - 0.3) ** 2) / 0.005)


# ----------------------------------------------------------------------------
# advection
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["quad", "tet"])
def test_advection_apply(kind):
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.ops.dg_advection import DGAdvection as JA

    js, ts = _spaces(kind)
    ja = JA(js, _vel_np, inflow=lambda x: np.sin(3 * np.asarray(x)[..., 0]))
    ta = DGAdvection(ts, _vel_t, inflow=lambda x: torch.sin(3 * x[..., 0]), **CPU)
    u = np.random.default_rng(0).standard_normal(js.ndof)
    yj, rj = jax.jit(lambda v: (ja.mult(0.0, v), ja.rhs(v)))(jnp.asarray(u))
    assert _rel(yj, ta.mult(0.0, torch.as_tensor(u))) <= 1e-12
    assert _rel(rj, ta.rhs(torch.as_tensor(u))) <= 1e-12
    # u ≡ 1 with inflow 1 is a steady state (free-stream preservation)
    ones = DGAdvection(ts, _vel_t, inflow=lambda x: torch.ones(x.shape[:-1]), **CPU)
    assert float(ones.rhs(torch.ones(ts.ndof, dtype=torch.float64)).abs().max()) < 1e-12


def test_advection_transport_rk3():
    """The ex9 problem (24 RK3-SSP steps on 12 × 12 quads, order 2) against
    JAX's jitted step; ∫u kept while the pulse is inside."""
    import jax

    from cardiac_ablation_ecm2_tpu.linalg import ode as jode
    from cardiac_ablation_ecm2_tpu.ops.dg_advection import DGAdvection as JA
    from cardiac_ablation_ecm2_tpu.ops.dg_advection import project_l2 as jproject

    js, ts = _spaces(None, 12, 2)
    zero_np = lambda x: np.zeros(np.asarray(x).shape[:-1])
    ja = JA(js, _vel_np, inflow=zero_np)
    ta = DGAdvection(ts, _vel_t, inflow=lambda x: torch.zeros(x.shape[:-1]), **CPU)
    jsolver, tsolver = jode.select("rk3_ssp"), ode.select("rk3_ssp")
    jstep = jax.jit(lambda u, t, dt: jsolver.step(ja, u, t, dt))
    uj, ut = jproject(js, _pulse_np), project_l2(ts, _pulse_t, **CPU)
    assert _rel(uj, ut) == 0.0
    tj = tt = 0.0
    for _ in range(24):
        uj, tj = jstep(uj, tj, 0.002)
        ut, tt = tsolver.step(ta, ut, tt, 0.002)
    assert _rel(uj, ut) <= 1e-10
    from cardiac_ablation_ecm2_tpu_torch.fem.build import basis_for, geom_factors_for
    from cardiac_ablation_ecm2_tpu_torch.fem.quadinterp import eval_values

    db, gf = basis_for(ts, None, "cpu"), geom_factors_for(ts, None, None, "cpu")
    mass = lambda u: float(torch.sum(gf.wdet * eval_values(db, u.view(ts.mesh.ne, -1))))
    u0 = project_l2(ts, _pulse_t, **CPU)
    assert abs(mass(ut) - mass(u0)) <= 1e-6 * mass(u0)


def test_face_route(monkeypatch):
    """An apply reads each face side with take_rows and sums into the
    elements with ONE segment_sum; two applies agree bitwise."""
    calls = {"take_rows": 0, "segment_sum": 0}

    def counted(name, fn):
        def wrap(*a):
            calls[name] += 1
            return fn(*a)
        return wrap

    _, ts = _spaces("quad")
    for Op, args in ((DGAdvection, (_vel_t,)), (DGDiffusion, ())):
        op = Op(ts, *args, **CPU)
        monkeypatch.setattr(face_sum, "take_rows", counted("take_rows", face_sum.take_rows))
        monkeypatch.setattr(face_sum, "segment_sum",
                            counted("segment_sum", face_sum.segment_sum))
        u = torch.as_tensor(np.random.default_rng(1).standard_normal(ts.ndof))
        y1 = op.mult(0.0, u) if Op is DGAdvection else op.mult(u)
        assert calls == {"take_rows": 3, "segment_sum": 1}, (Op, calls)
        y2 = op.mult(0.0, u) if Op is DGAdvection else op.mult(u)
        assert torch.equal(y1, y2)
        monkeypatch.undo()
        calls.update(take_rows=0, segment_sum=0)


# ----------------------------------------------------------------------------
# SIPG and BR2
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("kind,br2", [("quad", True), ("hex", False)])
def test_sipg_apply(kind, br2):
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.ops import dg_diffusion as jdg

    js, ts = _spaces(kind)
    J, T = (jdg.DGDiffusionBR2, DGDiffusionBR2) if br2 else (jdg.DGDiffusion,
                                                             DGDiffusion)
    jd, td = J(js, kappa=1.3, penalty=8.0), T(ts, kappa=1.3, penalty=8.0, **CPU)
    u = np.random.default_rng(2).standard_normal(js.ndof)
    yj, dj = jax.jit(lambda v: (jd.mult(v), jd.diagonal()))(jnp.asarray(u))
    assert _rel(yj, td.mult(torch.as_tensor(u))) <= 1e-12
    assert _rel(dj, td.diagonal()) <= 1e-12
    g_np = lambda x: np.cos(np.asarray(x)[..., 0]) + np.asarray(x)[..., 1]
    g_t = lambda x: torch.cos(x[..., 0]) + x[..., 1]
    assert _rel(jd.dirichlet_rhs(g_np), td.dirichlet_rhs(g_t)) <= 1e-12


def test_sipg_hex_volume_takes_fused_diffusion(monkeypatch):
    """The hex SIPG volume term goes through ops/diffusion.apply's fused
    route (diffusion_apply), the card's fused_diffusion kernel."""
    from cardiac_ablation_ecm2_tpu_torch.ops import diffusion as dmod

    seen = []
    real = dmod.diffusion_apply
    monkeypatch.setattr(dmod, "diffusion_apply",
                        lambda *a: seen.append(a[1].shape) or real(*a))
    _, ts = _spaces("hex")
    DGDiffusion(ts, **CPU).mult(torch.ones(ts.ndof, dtype=torch.float64))
    assert seen and seen[0][0] == 6


@pytest.mark.parametrize("br2", [False, True])
def test_sipg_poisson_solve(br2):
    """−Δu = 2π² sin sin, weak u = 0: the Jacobi-PCG solve against JAX's,
    equal CG counts."""
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem.build import basis_for as jbasis
    from cardiac_ablation_ecm2_tpu.fem.build import geom_factors_for as jgf
    from cardiac_ablation_ecm2_tpu.fem.quadinterp import eval_values_t as jevt
    from cardiac_ablation_ecm2_tpu.linalg.solvers import cg as jcg
    from cardiac_ablation_ecm2_tpu.ops import dg_diffusion as jdg
    from cardiac_ablation_ecm2_tpu_torch.fem.build import basis_for, geom_factors_for
    from cardiac_ablation_ecm2_tpu_torch.fem.quadinterp import eval_values_t

    js, ts = _spaces(None, 6, 2)
    J, T = (jdg.DGDiffusionBR2, DGDiffusionBR2) if br2 else (jdg.DGDiffusion,
                                                             DGDiffusion)
    jd, td = J(js), T(ts, **CPU)
    f_np = lambda x: 2 * np.pi ** 2 * np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])
    gj, gt = jgf(js), geom_factors_for(ts, None, None, "cpu")
    bj = (jevt(jbasis(js), gj.wdet * jnp.asarray(f_np(np.asarray(gj.x)))).reshape(-1)
          + jd.dirichlet_rhs(lambda x: np.zeros(x.shape[:-1])))
    bt = (eval_values_t(basis_for(ts, None, "cpu"),
                        gt.wdet * torch.as_tensor(f_np(gt.x.numpy()))).reshape(-1)
          + td.dirichlet_rhs(lambda x: torch.zeros(x.shape[:-1])))
    assert _rel(bj, bt) <= 1e-12
    dj, dt_ = jd.diagonal(), td.diagonal()
    xj, ij = jax.jit(lambda b: jcg(jd.mult, b, M=lambda r: r / dj, rel_tol=1e-10,
                                   max_iter=2000))(bj)
    xt, it = cg(td.mult, bt, M=lambda r: r / dt_, rel_tol=1e-10, max_iter=2000)
    assert it.converged and it.iterations == int(ij.iterations)
    assert _rel(xj, xt) <= 1e-10


# ----------------------------------------------------------------------------
# IMEX advection–diffusion
# ----------------------------------------------------------------------------


def test_advection_diffusion_imex():
    """The implicit stage solve against JAX's, with its CG count, and the
    explicit part (the IMEX steppers themselves are ``linalg/ode``'s)."""
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.linalg.solvers import cg as jcg
    from cardiac_ablation_ecm2_tpu.models.advection_diffusion import (
        DGAdvectionDiffusion as JAD,
    )
    from cardiac_ablation_ecm2_tpu.ops.dg_advection import project_l2 as jproject

    js, ts = _spaces(None, 6, 2)
    ja = JAD(js, _vel_np, epsilon=5e-3, inflow=lambda x: np.zeros(x.shape[:-1]),
             rel_tol=1e-12)
    ta = DGAdvectionDiffusion(ts, _vel_t, epsilon=5e-3,
                              inflow=lambda x: torch.zeros(x.shape[:-1]),
                              rel_tol=1e-12, **CPU)
    uj, ut = jproject(js, _pulse_np), project_l2(ts, _pulse_t, **CPU)
    gamma = 0.01 * (1 - 1 / np.sqrt(2))
    kj, info = jax.jit(lambda u: jcg(
        lambda v: ja._M_apply(v) + gamma * ja.dif.mult(v), -ja.dif.mult(u),
        M=lambda r: r / (ja.mass_diag + gamma * ja.dif_diag), rel_tol=1e-12,
        max_iter=500))(uj)
    kt = ta.implicit_solve(gamma, 0.0, ut)
    assert ta.cg_iterations == [int(info.iterations)]
    assert _rel(kj, kt) <= 1e-10
    assert _rel(jax.jit(lambda u: ja.mult_explicit(0.0, u))(uj),
                ta.mult_explicit(0.0, ut)) <= 1e-12
    uts, _ = ode.select("imex_rk2").step(ta, ut, 0.0, 0.01)
    assert len(ta.cg_iterations) == 3 and bool(torch.isfinite(uts).all())


# ----------------------------------------------------------------------------
# the ex9 example program
# ----------------------------------------------------------------------------


def test_ex9_prints_jax_line(capsys, monkeypatch):
    from test_torch_examples import _jax_lines

    from cardiac_ablation_ecm2_tpu_torch.examples import ex9_dg_advection

    argv = ["-m", "inline-quad-8", "--steps", "20", "--cpu", "--x64"]
    want = _jax_lines("ex9_dg_advection", argv, capsys, monkeypatch)[-1]
    ex9_dg_advection.main(argv)
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and got.startswith("ndof=576"), (got, want)
