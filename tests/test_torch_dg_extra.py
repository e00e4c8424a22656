"""The port's DG elasticity (``ops/dg_elasticity``), hyperbolic DG
(``ops/hyperbolic``: Burgers and Euler with Rusanov fluxes) and the error
estimators (``fem/estimators``: ZZ, LSZZ, Kelly) against the JAX package,
float64 on the CPU.

Tolerances: one apply, diagonal or right-hand side within 1e-12 of JAX's
largest entry (the sums' order differs: 1e-15 apart, measured); RK
trajectories and solutions within 1e-10 with equal CG counts; the
estimators within 1e-12.
"""

import functools

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem import estimators as tes
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace, L2FESpace, element_node_coords
from cardiac_ablation_ecm2_tpu_torch.linalg import ode
from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.ops.dg_elasticity import DGElasticity
from cardiac_ablation_ecm2_tpu_torch.ops.hyperbolic import HyperbolicDG


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


@functools.lru_cache(maxsize=None)
def _l2(n, p, dim=2):
    from cardiac_ablation_ecm2_tpu import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.fem.fespace import L2FESpace as JL2

    if dim == 3:
        return (JL2(jmesh.make_cartesian_3d(n, n, n), p),
                L2FESpace(tmesh.make_cartesian_3d(n, n, n), p))
    return JL2(jmesh.make_cartesian_2d(n, n), p), L2FESpace(tmesh.make_cartesian_2d(n, n), p)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


# ----------------------------------------------------------------------------
# DG elasticity
# ----------------------------------------------------------------------------


def test_dg_elasticity_apply_and_solve():
    """Apply, diagonal and weak-Dirichlet RHS, and the Jacobi-PCG solve of
    a linear displacement (recovered exactly) with JAX's CG count."""
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.linalg.solvers import cg as jcg
    from cardiac_ablation_ecm2_tpu.ops.dg_elasticity import DGElasticity as JE

    js, ts = _l2(3, 2)
    je, te = JE(js, lam=1.5, mu=0.8), DGElasticity(ts, lam=1.5, mu=0.8, **CPU)
    u = np.random.default_rng(0).standard_normal(je.ndof)
    yj, dj = jax.jit(lambda v: (je.mult(v), je.diagonal()))(jnp.asarray(u))
    assert _rel(yj, te.mult(torch.as_tensor(u))) <= 1e-12
    assert _rel(dj, te.diagonal()) <= 1e-12

    def g(x, mod):
        return mod.stack([0.3 * x[..., 0] - 0.2 * x[..., 1] + 0.1,
                          0.5 * x[..., 1] + 0.4 * x[..., 0]], -1)

    bj = je.dirichlet_rhs(lambda x: g(np.asarray(x), np))
    bt = te.dirichlet_rhs(lambda x: g(x, torch))
    assert _rel(bj, bt) <= 1e-12
    xj, ij = jax.jit(lambda b: jcg(je.mult, b, M=lambda r: r / dj, rel_tol=1e-11,
                                   max_iter=3000))(bj)
    dt_ = te.diagonal()
    xt, it = cg(te.mult, bt, M=lambda r: r / dt_, rel_tol=1e-11, max_iter=3000)
    assert it.converged and it.iterations == int(ij.iterations)
    assert _rel(xj, xt) <= 1e-10
    X = torch.as_tensor(element_node_coords(ts.mesh, ts.order))
    assert float((xt.view(X.shape) - g(X, torch)).abs().max()) < 1e-8


# ----------------------------------------------------------------------------
# hyperbolic DG
# ----------------------------------------------------------------------------


def _euler_state(X, mod):
    """A smooth density pulse in a uniform flow, (ρ, ρv, E) at X."""
    gamma = 1.4
    rho = 1.0 + 0.2 * mod.exp(-20 * ((X[..., 0] - 0.5) ** 2 + (X[..., 1] - 0.5) ** 2))
    vx, vy, p = 0.3, 0.2, 1.0
    E = p / (gamma - 1) + 0.5 * rho * (vx ** 2 + vy ** 2)
    return mod.stack([rho, rho * vx, rho * vy, E], -1)


@pytest.mark.parametrize("law", ["burgers", "euler"])
def test_hyperbolic(law):
    """One apply in 2D and 3D, then five RK3-SSP steps in 2D against JAX's
    jitted step."""
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.linalg import ode as jode
    from cardiac_ablation_ecm2_tpu.ops.hyperbolic import HyperbolicDG as JH

    for dim in (3, 2):
        js, ts = _l2(2 if dim == 3 else 5, 1 if dim == 3 else 2, dim)
        jh, th = JH(js, law=law), HyperbolicDG(ts, law=law, **CPU)
        X = element_node_coords(ts.mesh, ts.order)
        if law == "burgers":
            u = (0.5 + 0.4 * np.sin(np.pi * X[..., 0]))[..., None]
        elif dim == 2:
            u = _euler_state(X, np)
        else:
            u = np.concatenate([_euler_state(X, np)[..., :3], 0.1 + 0 * X[..., :1],
                                _euler_state(X, np)[..., 3:]], -1)
        u = u.reshape(-1)
        jmult = jax.jit(lambda v: jh.mult(0.0, v))
        assert _rel(jmult(jnp.asarray(u)), th.mult(0.0, torch.as_tensor(u))) <= 1e-12
    jsolver, tsolver = jode.select("rk3_ssp"), ode.select("rk3_ssp")
    jstep = jax.jit(lambda v: jsolver.step(jh, v, 0.0, 0.01)[0])
    uj, ut = jnp.asarray(u), torch.as_tensor(u)
    for _ in range(5):
        uj = jstep(uj)
        ut, _ = tsolver.step(th, ut, 0.0, 0.01)
    assert _rel(uj, ut) <= 1e-10


# ----------------------------------------------------------------------------
# estimators
# ----------------------------------------------------------------------------


def test_estimators():
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.fem import estimators as jes

    js, ts = JFESpace(jmesh.make_cartesian_2d(5, 4), 2), FESpace(
        tmesh.make_cartesian_2d(5, 4), 2)
    x = ts.dof_coords
    u = np.sin(3 * x[:, 0]) * np.exp(x[:, 1]) + x[:, -1] ** 2
    for name in ("zz_estimator", "kelly_estimator", "lszz_estimator"):
        a = getattr(jes, name)(js, jnp.asarray(u))
        b = getattr(tes, name)(ts, torch.as_tensor(u))
        assert b.shape == (ts.mesh.ne,) and _rel(a, b) <= 1e-12, name
