"""The port's Navier–Stokes split step (``models/navier.py``) against the
JAX package, float64 on the CPU: the 3D wall-bounded vortex of JAX's
``test_navier_3d_dissipation_and_divergence`` (4×4×2, order 2, three
steps: BDF1 then BDF2) and the Kovasznay flow (order 3 on 4×4, Dirichlet
data, three steps from the exact state) and the Taylor–Green run with
time-dependent data: u and p within 1e-10 relative after each step, and
each step's four Jacobi-PCG sub-solves with JAX's CG counts (recorded by
an ordered host callback around JAX's ``cg`` inside its jitted step)."""

import numpy as np
import pytest
import torch

import jax

from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_3d as jhex
from cardiac_ablation_ecm2_tpu.mesh.mesh import Mesh as JMesh
from cardiac_ablation_ecm2_tpu.models import navier as jnav
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import Mesh, make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2_tpu_torch.models import navier as tnav

RTOL = 1e-10
RE = 40.0
LAM = RE / 2 - np.sqrt(RE * RE / 4 + 4 * np.pi ** 2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_counts(monkeypatch):
    """JAX's CG counts, in call order, through the patched ``cg``."""
    counts = []
    real = jnav.cg

    def recording_cg(*a, **k):
        x, info = real(*a, **k)
        jax.debug.callback(lambda it: counts.append(int(it)), info.iterations,
                           ordered=True)
        return x, info

    monkeypatch.setattr(jnav, "cg", recording_cg)
    return counts


def close(a, b, rtol=RTOL):
    a, b = a.numpy(), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= rtol, err


def kovasznay_u(x):
    x = np.asarray(x)
    ex = np.exp(LAM * x[..., 0])
    return np.stack([1 - ex * np.cos(2 * np.pi * x[..., 1]),
                     LAM / (2 * np.pi) * ex * np.sin(2 * np.pi * x[..., 1])], axis=-1)


def _kov_mesh(make, cls, nx, ny):
    m0 = make(nx, ny)
    V = m0.vertices.copy()
    V[:, 0] = -0.5 + 2.5 * V[:, 0]
    V[:, 1] = -0.5 + 2.0 * V[:, 1]
    return cls(geom=m0.geom, vertices=V, elements=m0.elements, attributes=m0.attributes,
               boundary=m0.boundary, bdr_attributes=m0.bdr_attributes)


def vortex(x):
    x = np.asarray(x)
    return np.stack([np.sin(np.pi * x[..., 0]) ** 2 * np.sin(2 * np.pi * x[..., 1]),
                     -np.sin(2 * np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]) ** 2,
                     0 * x[..., 0]], axis=-1)


CASES = {
    "vortex 3d": (lambda: jhex(4, 4, 2), lambda: make_cartesian_3d(4, 4, 2),
                  dict(order=2, kin_vis=0.05,
                       vel_bc=lambda x: np.zeros(np.asarray(x).shape[:-1] + (3,))),
                  vortex, 0.005),
    "kovasznay": (lambda: _kov_mesh(jquad, JMesh, 4, 4),
                  lambda: _kov_mesh(make_cartesian_2d, Mesh, 4, 4),
                  dict(order=3, kin_vis=1.0 / RE, vel_bc=kovasznay_u),
                  kovasznay_u, 2e-3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_steps(case, jax_counts):
    jm, tm, kw, u0, dt = CASES[case]
    js = jnav.NavierSolver(jm(), **kw)
    ts = tnav.NavierSolver(tm(), device="cpu", **kw)
    uj, pj = js.initial_state(u0)
    ut, pt = ts.initial_state(u0)
    close(ut, uj, 1e-14)
    steps = [(js._make_step(dt, k), ts._make_step(dt, k)) for k in (1, 2)]
    histj, histt = (uj,), (ut,)
    for i in range(3):
        sj, st = steps[min(i, 1)]
        del jax_counts[:]
        uj, pj = sj(histj, pj, js.u_bc, js.b_f)
        jax.effects_barrier()
        ut, pt = st(histt, pt, ts.u_bc, ts.b_f)
        assert [info.iterations for info in ts.last_infos] == jax_counts
        assert all(info.converged for info in ts.last_infos)
        close(ut, uj)
        close(pt, pj)
        histj, histt = (uj, histj[0]), (ut, histt[0])
    assert abs(ts.div_norm(ut) - js.div_norm(uj)) <= 1e-9 * js.div_norm(uj)


def tg_u(x, t, nu):
    x = np.asarray(x)
    F = np.exp(-2 * np.pi ** 2 * nu * t)
    return np.stack([np.cos(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]),
                     -np.sin(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1])], axis=-1) * F


def test_run_taylor_green():
    nu, T, n = 0.05, 0.1, 4
    kw = dict(order=4, kin_vis=nu, rel_tol=1e-12)
    run = dict(dt=T / n, nsteps=n, u0=lambda x: tg_u(x, 0.0, nu),
               vel_bc_t=lambda x, t: tg_u(x, t, nu))
    js = jnav.NavierSolver(jquad(3, 3), **kw)
    ts = tnav.NavierSolver(make_cartesian_2d(3, 3), device="cpu", **kw)
    uj, pj = js.run(**run)
    ut, pt = ts.run(**run)
    close(ut, uj)
    close(pt, pj)
    exact = lambda x: tg_u(x, T, nu)
    assert abs(ts.velocity_error(ut, exact) - js.velocity_error(uj, exact)) \
        <= 1e-8 * js.velocity_error(uj, exact)
