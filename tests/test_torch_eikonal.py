"""The port's eikonal model (``models/eikonal.py``) against the JAX
package, float64 on the CPU: the p continuation on a 6×6 order-2 square
(p = 2, 3, 4): equal Newton and CG counts at every p, u to 1e-10."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.models import eikonal as jeik
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d
from cardiac_ablation_ecm2_tpu_torch.models import eikonal as teik
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


def test_eikonal():
    sched = (2.0, 3.0, 4.0)
    js = jeik.EikonalSolver(jquad(6, 6), order=2, p_schedule=sched)
    ts = teik.EikonalSolver(make_cartesian_2d(6, 6), order=2, p_schedule=sched,
                            device="cpu")
    m = js.mask

    def res(v, p):
        return jax.grad(lambda w: js.energy(w, p))(v) * m + v * (1 - m)

    def jax_steps():
        """JAX's continuation with every Newton step's CG count visible."""
        u, steps = jnp.zeros(js.fes.ndof_scalar), []
        for p in sched:
            u, k, its = jax_newton(res, u, rel_tol=js.rel_tol, max_iter=40,
                                   line_search=8, args=(jnp.float64(p),))
            steps.append((k, its))
        return steps

    solve_run, steps_run = beside(js.solve), beside(jax_steps)
    ut, it = ts.solve()
    (uj, ij), steps = solve_run.result(), steps_run.result()
    assert len(ts.infos) == len(steps)
    for p, info, want in zip(sched, ts.infos, steps):
        assert (info.iterations, list(info.linear_iterations)) == want, (p, info)
    assert it.converged and it.iterations == int(ij.iterations)
    close(ut, uj)
