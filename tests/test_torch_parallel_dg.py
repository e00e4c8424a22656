"""The port's sharded DG (``parallel/dg.py``: upwind advection and SIPG
with the ghost-face exchange) over 2 and 4 gloo ranks against the JAX
package's serial operators, float64 on the CPU.

The ranks are spawned once per world size in a background thread while
JAX computes in this process; the rank bodies live in this module, which
imports JAX only inside the tests.  Tolerances: five RK4 steps of
advection within 1e-12 of JAX's serial operator (the faces between ranks
are summed after the rest); the 2D SIPG solve within 1e-10 with JAX's
serial CG count, the 3D one likewise against the port's serial solve
(whose hex operator ``test_torch_dg`` holds to JAX's).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem.fespace import L2FESpace
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.ops.dg_advection import project_l2
from cardiac_ablation_ecm2_tpu_torch.parallel import dg as pdg
from cardiac_ablation_ecm2_tpu_torch.parallel import launch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DT, STEPS = 0.004, 5


def _vel(x):
    v = torch.zeros_like(x)
    v[..., 0], v[..., 1] = 0.6, 0.4
    return v


def _vel_np(x):
    x = np.asarray(x)
    return np.stack([0.6 * np.ones_like(x[..., 0]), 0.4 * np.ones_like(x[..., 1])], -1)


def _zero(x):
    return torch.zeros(x.shape[:-1], dtype=x.dtype)


def _blob(X):
    return torch.exp(-60 * ((X[..., 0] - 0.4) ** 2 + (X[..., 1] - 0.5) ** 2))


def _sines(x):
    return 2 * np.pi ** 2 * torch.sin(np.pi * x[..., 0]) * torch.sin(np.pi * x[..., 1])


def _rk4(mult, u, t):
    k1 = mult(t, u)
    k2 = mult(t + DT / 2, u + DT / 2 * k1)
    k3 = mult(t + DT / 2, u + DT / 2 * k2)
    k4 = mult(t + DT, u + DT * k3)
    return u + DT / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def _rank_cases(rank, world, dev):
    """Every case of one world size on this rank."""
    fes = L2FESpace(tmesh.make_cartesian_2d(8, 8), 2)
    par = pdg.setup(fes, _vel, inflow=_zero, device=dev)
    u = par.scatter(project_l2(fes, _blob, device="cpu"))
    t = 0.0
    for _ in range(STEPS):
        u = _rk4(par.mult, u, t)
        t += DT
    out = dict(adv=par.gather(u))
    fes = L2FESpace(tmesh.make_cartesian_2d(6, 6), 2)
    s = pdg.setup_sipg(fes, kappa=1.0, penalty=10.0, g=_zero, f_rhs=_sines, device=dev)
    x, info = s.solve(rel_tol=1e-10, max_iter=2000)
    out["sipg2d"] = (s.gather(x), info.iterations)
    fes = L2FESpace(tmesh.make_cartesian_3d(3, 3, 3), 1)
    s = pdg.setup_sipg(fes, kappa=2.0, penalty=12.0,
                       f_rhs=lambda x: torch.ones(x.shape[:-1], dtype=x.dtype),
                       device=dev)
    x, info = s.solve(rel_tol=1e-10, max_iter=2000)
    out["sipg3d"] = (s.gather(x), info.iterations)
    out["rounds"] = len(s.layout.rounds)
    return out


@pytest.fixture(scope="module")
def ranks():
    with ThreadPoolExecutor(2) as pool:
        yield {w: pool.submit(launch.spawn, _rank_cases, w, "cpu") for w in (2, 4)}


@functools.lru_cache(maxsize=None)
def _jax_sipg2d():
    """JAX's serial 2D SIPG solve: (x, CG iterations)."""
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem.build import basis_for, geom_factors_for
    from cardiac_ablation_ecm2_tpu.fem.fespace import L2FESpace as JL2
    from cardiac_ablation_ecm2_tpu.fem.quadinterp import eval_values_t
    from cardiac_ablation_ecm2_tpu.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu.ops.dg_diffusion import DGDiffusion

    from cardiac_ablation_ecm2_tpu import mesh as jmesh

    fes = JL2(jmesh.make_cartesian_2d(6, 6), 2)
    ser = DGDiffusion(fes=fes, kappa=1.0, penalty=10.0)
    gf = geom_factors_for(fes)
    x = np.asarray(gf.x)
    f = 2 * np.pi ** 2 * np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])
    b = (eval_values_t(basis_for(fes), gf.wdet * jnp.asarray(f)).reshape(-1)
         + ser.dirichlet_rhs(lambda x: np.zeros(x.shape[:-1])))
    dd = ser.diagonal()
    x, info = jax.jit(lambda b: cg(ser.mult, b, M=lambda r: r / dd, rel_tol=1e-10,
                                   max_iter=2000))(b)
    return np.asarray(x), int(info.iterations)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_advection_matches_jax_serial(ranks, world):
    import jax

    from cardiac_ablation_ecm2_tpu import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.fem.fespace import L2FESpace as JL2
    from cardiac_ablation_ecm2_tpu.ops.dg_advection import DGAdvection, project_l2 as jproj

    fes = JL2(jmesh.make_cartesian_2d(8, 8), 2)
    op = DGAdvection(fes=fes, velocity=_vel_np,
                     inflow=lambda x: np.zeros(np.asarray(x).shape[:-1]))
    step = jax.jit(lambda u, t: _rk4(op.mult, u, t))
    u = jproj(fes, lambda X: np.exp(-60 * ((X[..., 0] - 0.4) ** 2
                                           + (X[..., 1] - 0.5) ** 2)))
    t = 0.0
    for _ in range(STEPS):
        u = step(u, t)
        t += DT
    got = ranks[world].result()[0]["adv"]
    assert np.abs(got - np.asarray(u)).max() <= 1e-12 * np.abs(np.asarray(u)).max()


@functools.lru_cache(maxsize=None)
def _serial_sipg3d():
    """The port's serial 3D SIPG solve: (x, CG iterations)."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import basis_for, geom_factors_for
    from cardiac_ablation_ecm2_tpu_torch.fem.quadinterp import eval_values_t
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_diffusion import DGDiffusion

    fes = L2FESpace(tmesh.make_cartesian_3d(3, 3, 3), 1)
    ser = DGDiffusion(fes, kappa=2.0, penalty=12.0, device="cpu")
    gf = geom_factors_for(fes, None, None, "cpu")
    b = eval_values_t(basis_for(fes, None, "cpu"), gf.wdet).reshape(-1)
    dd = ser.diagonal()
    x, info = cg(ser.mult, b, M=lambda r: r / dd, rel_tol=1e-10, max_iter=2000)
    return x.numpy(), info.iterations


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_sipg_matches_serial(ranks, world):
    out = ranks[world].result()
    assert out[0]["rounds"] >= 1 and all(o["adv"] is None for o in out[1:])
    for key, (x, its) in (("sipg2d", _jax_sipg2d()), ("sipg3d", _serial_sipg3d())):
        got, got_its = out[0][key]
        assert got_its == its, (key, got_its, its)
        assert np.abs(got - x).max() <= 1e-10 * np.abs(x).max(), key


def test_world_one_is_serial():
    """At world size 1 (gloo in this process) every face is the rank's own:
    the sharded apply equals the serial operator's bit for bit."""
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_diffusion import DGDiffusion

    fes = L2FESpace(tmesh.make_cartesian_2d(4, 3), 2)

    def body(rank, world, dev):
        s = pdg.setup_sipg(fes, kappa=1.5, device=dev)
        u = torch.as_tensor(np.random.default_rng(3).standard_normal(fes.ndof))
        return s.mult(s.scatter(u)), s.layout.rounds, u

    y, rounds, u = launch.run_single(body, "cpu")
    assert rounds == [] and torch.equal(y, DGDiffusion(fes, kappa=1.5, device="cpu").mult(u))
    assert pdg._edge_color([(0, 1), (1, 2), (0, 2), (2, 3)]) == [
        [(0, 1), (2, 3)], [(0, 2)], [(1, 2)]]
