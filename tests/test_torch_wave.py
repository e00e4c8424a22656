"""The port's ex23 slice (``models/wave.py``: ``WaveOperator``,
``make_stepper``) against the JAX package, float64 on the CPU: five
Newmark steps (and one generalized-α and one central-difference run) on a
2D order-2 square and a 3D order-2 cube, u and v within 1e-10 relative;
the last mass and implicit solves take as many CG iterations as JAX's
(JAX's solves written out on its own operator, whose ``cg`` returns its
count); the discrete energy is conserved under Newmark β = 1/4 (JAX's
``test_energy_conservation``).  The port packs the stiffness qdata, so on
the cube every K apply is ``fused_diffusion``'s plain version here and the
kernel on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.fem.gridfunction import project as jproject
from cardiac_ablation_ecm2_tpu.linalg import ode2 as jode2
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_3d as jhex
from cardiac_ablation_ecm2_tpu.models import wave as jwave
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.fem.gridfunction import project
from cardiac_ablation_ecm2_tpu_torch.linalg import ode2 as tode2
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2_tpu_torch.models import wave as twave

RTOL = 1e-10
DT = 0.01
CASES = {"square": (lambda: jquad(10, 10), lambda: make_cartesian_2d(10, 10)),
         "cube": (lambda: jhex(4, 4, 4), lambda: make_cartesian_3d(4, 4, 4))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL):
    a, b = a.numpy(), np.asarray(b)
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= rtol, err


def u0(x):
    return np.sin(np.pi * x[..., 0]) * np.sin(2 * np.pi * x[..., 1])


@pytest.fixture(scope="module", params=sorted(CASES))
def ops(request):
    jm, tm = CASES[request.param]
    jf, tf = JFESpace(jm(), 2), FESpace(tm(), 2)
    jop = jwave.WaveOperator(jf, c2=1.0, rel_tol=1e-13)
    top = twave.WaveOperator(tf, c2=1.0, rel_tol=1e-13, device="cpu")
    uj = jproject(jf, lambda x: u0(np.asarray(x)))
    ut = project(tf, lambda x: torch.as_tensor(u0(x.numpy())), device="cpu")
    close(ut, uj, 1e-14)
    return jop, top, uj, ut


def jax_counts(op, u, v, dt, beta):
    """JAX's solves of one Newmark step from (u, v), written out on its own
    operator: (mass CG count at u, implicit CG count at the predictor)."""
    c0 = beta * dt * dt
    a0 = op.mult(0.0, u, v)
    up = u + dt * v + (0.5 - beta) * dt * dt * a0
    counts = []
    for x, cm, ck, diag in ((u, 1.0, 0.0, op.M_diag),
                            (up, 1.0, c0, op.M_diag + c0 * op.K_diag)):
        rhs = op._z(-op._apply(op.M_qd, op.K_qd, op._z(x), 0.0, 1.0))
        def A(w, cm=cm, ck=ck):
            z = op._z(w)
            return op._z(op._apply(op.M_qd, op.K_qd, z, cm, ck)) + (w - z)
        d = diag.at[op.ess].set(1.0)
        _, info = jsolvers.cg(A, rhs, M=lambda r: r / d, rel_tol=op.rel_tol,
                              max_iter=op.max_iter)
        counts.append(int(info.iterations))
    return counts


@pytest.mark.parametrize("name,kw", [("newmark", {}), ("generalized_alpha",
                                                        dict(rho_inf=0.5)),
                                     ("central_difference", {})])
def test_steps(ops, name, kw):
    jop, top, uj, ut = ops
    js, ts = jode2.select2(name, **kw), tode2.select2(name, **kw)
    vj, vt = jnp.zeros_like(uj), torch.zeros_like(ut)
    t = 0.0
    if name == "generalized_alpha":
        aj, at = js.init(jop, uj, vj, t), ts.init(top, ut, vt, t)
        for _ in range(5):
            uj, vj, aj, _ = js.step(jop, uj, vj, aj, t, DT)
            ut, vt, at, t = ts.step(top, ut, vt, at, t, DT)
        close(at, aj)
    else:
        step = twave.make_stepper(top, ts)
        jstep = jwave.make_stepper(jop, js)
        for _ in range(5):
            prev = uj, vj
            uj, vj, _ = jstep(uj, vj, t, DT)
            ut, vt, t = step(ut, vt, t, DT)
    close(ut, uj)
    close(vt, vj)
    if name == "newmark":
        mass_its, impl_its = jax_counts(jop, *prev, DT, js.beta)
        assert top.mass_info.iterations == mass_its
        assert top.implicit_info.iterations == impl_its


def test_energy_conservation(ops):
    jop, top, _, ut = ops
    step = twave.make_stepper(top, tode2.select2("newmark"))
    u, v, t = ut, torch.zeros_like(ut), 0.0
    E0 = top.energy(u, v)
    for _ in range(20):
        u, v, t = step(u, v, t, DT)
    assert abs(top.energy(u, v) - E0) < 1e-8 * max(abs(E0), 1)
