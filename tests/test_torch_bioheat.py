"""The PyTorch port's bioheat slice against the JAX package, float64 on the
CPU, with the benchmark's settings (order 2, quad_extra 0, theta form,
fused setup, SDIRK33, dt 0.25, Jacobi-PCG rel_tol 1e-5).

Setup arrays are held to rtol 1e-12 and θ after three steps to 1e-10
(round-off differences in the contractions pass through nine CG solves);
every CG solve must take the same number of iterations."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.linalg import ode as jode
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_hex_mesh as jmake
from cardiac_ablation_ecm2_tpu.mesh.mesh import make_cartesian_3d as jcart
from cardiac_ablation_ecm2_tpu.models import bioheat as jbio
from cardiac_ablation_ecm2_tpu.utils.config import config as jcfg
from cardiac_ablation_ecm2_tpu.utils.config import configure as jconfigure
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import ode as tode
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
from cardiac_ablation_ecm2_tpu_torch.models import bioheat as tbio
from cardiac_ablation_ecm2_tpu_torch.utils.config import config as tcfg
from cardiac_ablation_ecm2_tpu_torch.utils.config import configure as tconfigure

L = 0.04
CTR = (L / 2, L / 2, L / 2)
DT = 0.25
PARAMS = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0, ess_bdr=[1, 2, 3, 4, 5, 6],
              rel_tol=1e-5, max_iter=300, dtype="float64", fused_setup=True,
              theta_form=True)


def _src(exp):
    def src(x):
        r2 = sum((x[..., i] - CTR[i]) ** 2 for i in range(3))
        return 2e7 * exp(-r2 / (2 * 0.003 ** 2))
    return src


@pytest.fixture(autouse=True)
def _bench_config():
    """quad_extra=0 in both packages (bench.py's setting), one torch
    thread; the previous values come back afterwards."""
    n = torch.get_num_threads()
    old = jcfg.quad_extra, tcfg.quad_extra
    torch.set_num_threads(1)
    jconfigure(quad_extra=0)
    tconfigure(quad_extra=0)
    yield
    jconfigure(quad_extra=old[0])
    tconfigure(quad_extra=old[1])
    torch.set_num_threads(n)


class _CountingJax:
    """JAX ``BioheatOperator.implicit_solve``, written out so the CG
    iteration count of each stage solve is visible."""

    def __init__(self, op):
        self.op, self.iters = op, []

    def implicit_solve(self, gamma, t, T):
        op = self.op
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
        self.iters.append(int(info.iterations))
        return op._zero_ess(k)


def _meshes(kind):
    if kind == "cardiac":
        kw = dict(lengths=(L, L, L / 2), electrode_radius=0.004)
        return jmake(8, **kw), make_cardiac_hex_mesh(8, **kw)
    return jcart(6, 6, 3, L, L, L / 2), make_cartesian_3d(6, 6, 3, L, L, L / 2)


def _extra(kind, fes):
    """The lattice cases also zero a few elements (``elem_mask``) and pin
    every dof they touch (``ess_dofs``), as the masked-lattice path does."""
    if kind == "cardiac":
        return {}
    mask = (np.arange(fes.mesh.ne) % 17 != 0).astype(np.float64)
    return dict(elem_mask=mask,
                ess_dofs=np.unique(fes.gather_map[mask == 0]))


@functools.lru_cache(maxsize=None)
def _jax_op(kind, transposed_apply=True, fused_setup=True):
    """JAX operators are built once per module (their setup compiles)."""
    jm, _ = _meshes(kind)
    jfes = JFESpace(jm, 2)
    params = dict(PARAMS, fused_setup=fused_setup, **_extra(kind, jfes))
    return jbio.BioheatOperator(fes=jfes, q_met=_src(jnp.exp),
                                transposed_apply=transposed_apply, **params)


def _build(kind, transposed_apply=True, fused_setup=True):
    _, tm = _meshes(kind)
    tfes = FESpace(tm, 2)
    params = dict(PARAMS, fused_setup=fused_setup, **_extra(kind, tfes))
    top = tbio.BioheatOperator(tfes, q_met=_src(torch.exp), device="cpu",
                               transposed_apply=transposed_apply, **params)
    return _jax_op(kind, transposed_apply, fused_setup), top


def _run_jax(jop, T, steps):
    f = _CountingJax(jop)
    solver, t = jode.select("sdirk33"), 0.0
    T = jnp.asarray(T)
    for _ in range(steps):
        T, t = solver.step(f, T, t, DT)
    return np.asarray(T), f.iters


def _run_port(top, T, steps):
    step, t = tbio.make_stepper(top, tode.select("sdirk33")), 0.0
    T = torch.as_tensor(T)
    for _ in range(steps):
        T, t = step(T, t, DT)
    return T.numpy(), top.cg_iterations


def close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


@pytest.mark.parametrize("kind,transposed_apply,fused_setup", [
    ("cardiac", True, True), ("cardiac", False, False),
    ("cartesian", True, True)])
def test_three_steps_match_jax(kind, transposed_apply, fused_setup):
    jop, top = _build(kind, transposed_apply, fused_setup)
    assert (top._aff is None) == (jop._aff is None) == (kind == "cardiac"
                                                        or not transposed_apply)
    for name in ("b_const", "Mrc_diag", "A_diag", "ess_mask"):
        close(getattr(top, name), getattr(jop, name), 1e-12)
    T0 = np.zeros(jop.fes.ndof)
    jT, jit = _run_jax(jop, T0, 3)
    tT, tit = _run_port(top, T0, 3)
    assert tit == jit
    assert len(tit) == 9
    close(tT, jT, 1e-10)
    assert np.abs(jT).max() > 0.1


