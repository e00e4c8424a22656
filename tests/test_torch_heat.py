"""The port's ex16 slice (``models/heat.py``: ``ConductionOperator``,
``make_stepper``) against the JAX package, float64 on the CPU, quad_extra
0 in both packages, ex16's κ = 0.5 and α = 0.01 on the unit cube (natural
boundary conditions, as ex16) and on the cardiac hex mesh (faces 2 and 3
held).

``mult``, ``implicit_solve`` and three SDIRK33 steps are held to
1e-10·max (round-off in the contractions passes through the CG solves),
and every stage solve must take as many CG iterations as JAX's; JAX's
stage solve is written out and jitted so that its counts are visible, and
held to JAX's own jitted stepper to 1e-13.  Without essential boundaries
‖u‖_L2 may not grow from step to step (JAX's
``test_nonlinear_heat_energy_decay``)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.fem import gridfunction as jgf
from cardiac_ablation_ecm2_tpu.linalg import ode as jode
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_hex_mesh as jcardiac
from cardiac_ablation_ecm2_tpu.mesh.mesh import make_cartesian_3d as jcart
from cardiac_ablation_ecm2_tpu.models import heat as jheat
from cardiac_ablation_ecm2_tpu.ops import diffusion as jdiffusion
from cardiac_ablation_ecm2_tpu.utils.config import config as jcfg
from cardiac_ablation_ecm2_tpu.utils.config import configure as jconfigure
from cardiac_ablation_ecm2_tpu_torch.fem import gridfunction as tgf
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import ode as tode
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
from cardiac_ablation_ecm2_tpu_torch.models import heat
from cardiac_ablation_ecm2_tpu_torch.utils.config import config as tcfg
from cardiac_ablation_ecm2_tpu_torch.utils.config import configure as tconfigure

DT = 0.01
GAMMA = DT * 0.435866521508458999416019          # dt · a_ii of SDIRK33
CASES = {
    "cube": (lambda: jcart(3, 3, 3), lambda: make_cartesian_3d(3, 3, 3), 1.0, ()),
    "cardiac": (lambda: jcardiac(2, lengths=(0.04, 0.04, 0.02), electrode_radius=0.004),
                lambda: make_cardiac_hex_mesh(2, lengths=(0.04, 0.04, 0.02),
                                              electrode_radius=0.004),
                0.04, (2, 3)),
}


@pytest.fixture(autouse=True)
def _config():
    """quad_extra=0 in both packages, one torch thread; restored after."""
    n = torch.get_num_threads()
    old = jcfg.quad_extra, tcfg.quad_extra
    torch.set_num_threads(1)
    jconfigure(quad_extra=0)
    tconfigure(quad_extra=0)
    yield
    jconfigure(quad_extra=old[0])
    tconfigure(quad_extra=old[1])
    torch.set_num_threads(n)


def close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


def _ops(case):
    """JAX and port operators of one case and the initial state
    u₀ = exp(−20 r²/L²) about the centre (numpy, from the dof coordinates)."""
    jm, tm, L, ess = CASES[case]
    jf, tf = JFESpace(jm(), 2), FESpace(tm(), 2)
    kw = dict(kappa=0.5, alpha=0.01, ess_bdr=ess)
    x = tf.dof_coords / L
    u0 = np.exp(-20.0 * ((x - x.mean(axis=0)) ** 2).sum(axis=1))
    return (jheat.ConductionOperator(jf, **kw),
            heat.ConductionOperator(tf, dtype="float64", device="cpu", **kw), u0)


class _JaxStages:
    """JAX ``ConductionOperator.implicit_solve`` written out and jitted with
    γ and u traced, so each stage solve's CG count is visible."""

    def __init__(self, op):
        self.op, self.iters = op, []

        def stage(gamma, u):
            qd = jdiffusion.setup_packed(op.gf, op._kappa_q(u))

            def T_apply(v):
                z = op._zero_ess(v)
                y = op._M_apply(z) + gamma * op._K_apply(qd, z)
                return op._zero_ess(y) + (v - z)

            rhs = op._zero_ess(-op._K_apply(qd, u))
            diag = op.mass_diag + gamma * op.restr.mult_transpose(
                jdiffusion.diagonal(op.db, qd))
            if op.has_ess:
                diag = diag * op.ess_mask + (1.0 - op.ess_mask)
            inv = 1.0 / diag
            k, info = jsolvers.cg(T_apply, rhs, M=lambda r: inv * r,
                                  rel_tol=op.rel_tol, max_iter=op.max_iter)
            return op._zero_ess(k), info.iterations

        self._stage = jax.jit(stage)

    def implicit_solve(self, gamma, t, u):
        k, n = self._stage(gamma, u)
        self.iters.append(int(n))
        return k


@functools.lru_cache(maxsize=None)
def _jax_run(case, steps=3):
    """JAX's states after each step (written-out stages) and their counts."""
    jop, _, u0 = _ops(case)
    stages = _JaxStages(jop)
    u, t, out = jnp.asarray(u0), 0.0, []
    for _ in range(steps):
        u, t = jode.select("sdirk33").step(stages, u, t, DT)
        out.append(np.asarray(u))
    own, t = jnp.asarray(u0), 0.0
    step = jheat.make_stepper(jop, jode.select("sdirk33"))
    for _ in range(steps):
        own, t = step(own, t, DT)
    close(out[-1], own, 1e-13)
    return out, stages.iters


@pytest.mark.parametrize("case", list(CASES))
def test_mult_matches_jax(case):
    jop, top, u0 = _ops(case)
    close(top.mult(0.0, torch.as_tensor(u0)), jop.mult(0.0, jnp.asarray(u0)), 1e-10)


@pytest.mark.parametrize("case", list(CASES))
def test_implicit_solve_matches_jax(case):
    jop, top, u0 = _ops(case)
    stages = _JaxStages(jop)
    close(top.implicit_solve(GAMMA, 0.0, torch.as_tensor(u0)),
          stages.implicit_solve(GAMMA, 0.0, jnp.asarray(u0)), 1e-10)
    assert top.cg_iterations == stages.iters and stages.iters[0] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax(case):
    jstates, jiters = _jax_run(case)
    _, top, u0 = _ops(case)
    step = heat.make_stepper(top, tode.select("sdirk33"))
    u, t = torch.as_tensor(u0), 0.0
    norms = [float(tgf.l2_norm(top.fes, u))]
    for ref in jstates:
        u, t = step(u, t, DT)
        close(u, ref, 1e-10)
        norms.append(float(tgf.l2_norm(top.fes, u)))
    assert t == pytest.approx(3 * DT)
    assert top.cg_iterations == jiters and len(jiters) == 9
    if not CASES[case][3]:
        assert all(b <= a + 1e-12 for a, b in zip(norms, norms[1:])), norms
        close(norms[-1], float(jgf.l2_norm(JFESpace(CASES[case][0](), 2),
                                           jnp.asarray(jstates[-1]))), 1e-10)
