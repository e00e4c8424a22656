"""The PyTorch port's masked cardiac-hex lattice against the JAX package, on
the CPU: the lattice maker, the essential set and active-dof count of
``fem/masked_lattice.py``, and ``BENCH_MESH=cardiac-hex BENCH_STRUCTURED=1``
(bench.py:104-129,182-197: ``CartesianFESpace`` over the full warped
lattice, ``elem_mask``, pinned carved dofs, no collapse) at n=8 in float64:
θ after three SDIRK33 steps within 1e-10, equal CG iterations per stage."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import masked_lattice as jml
from cardiac_ablation_ecm2_tpu.fem.cartesian import CartesianFESpace as JCart
from cardiac_ablation_ecm2_tpu.linalg import ode as jode
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.mesh import cardiac as jcardiac
from cardiac_ablation_ecm2_tpu.models import bioheat as jbio
from cardiac_ablation_ecm2_tpu.utils.config import config as jcfg
from cardiac_ablation_ecm2_tpu.utils.config import configure as jconfigure
from cardiac_ablation_ecm2_tpu_torch.fem import masked_lattice as tml
from cardiac_ablation_ecm2_tpu_torch.fem.cartesian import CartesianFESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import ode as tode
from cardiac_ablation_ecm2_tpu_torch.mesh import cardiac as tcardiac
from cardiac_ablation_ecm2_tpu_torch.models import bioheat as tbio
from cardiac_ablation_ecm2_tpu_torch.ops import fused_diffusion as fd
from cardiac_ablation_ecm2_tpu_torch.utils.config import config as tcfg
from cardiac_ablation_ecm2_tpu_torch.utils.config import configure as tconfigure

L = 0.04
LENGTHS = (L, L, L / 2)
PARAMS = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0, ess_bdr=None,
              rel_tol=1e-5, max_iter=300, dtype="float64", fused_setup=True,
              theta_form=True)


@pytest.fixture(autouse=True)
def _bench_config():
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


def _lattice(pkg, n):
    return pkg.make_cardiac_hex_lattice(n, lengths=LENGTHS,
                                        electrode_radius=0.004)


@pytest.mark.parametrize("n", [8, 12])
def test_lattice_maker_and_masks_equal_jax(n):
    (jm, jkeep, jns), (tm, tkeep, tns) = _lattice(jcardiac, n), _lattice(tcardiac, n)
    assert tns == jns and tkeep.dtype == jkeep.dtype == bool
    assert np.array_equal(tkeep, jkeep) and 0 < tkeep.sum() < tkeep.size
    for f in ("vertices", "elements", "attributes", "boundary", "bdr_attributes"):
        assert np.array_equal(getattr(tm, f), getattr(jm, f)), f
    for p in (1, 2):
        assert np.array_equal(tml.masked_lattice_essential(tns, p, tkeep),
                              jml.masked_lattice_essential(jns, p, jkeep))
        assert np.array_equal(
            tml.masked_lattice_essential(tns, p, tkeep, outer_essential=False),
            jml.masked_lattice_essential(jns, p, jkeep, outer_essential=False))
        assert (tml.masked_lattice_active_count(tns, p, tkeep)
                == jml.masked_lattice_active_count(jns, p, jkeep))


def _src(exp):
    def src(x):
        r2 = sum((x[..., i] - L / 2) ** 2 for i in range(3))
        return 2e7 * exp(-r2 / (2 * 0.003 ** 2))
    return src


def _masked(pkg, space, n):
    mesh, keep, ns = _lattice(pkg, n)
    ml = jml if pkg is jcardiac else tml
    return space(mesh, 2, ns, LENGTHS), dict(
        elem_mask=keep.astype(np.float64),
        ess_dofs=ml.masked_lattice_essential(ns, 2, keep))


def _run_jax(jop, steps):
    """Three SDIRK33 steps of the JAX operator, its ``implicit_solve``
    written out (jitted whole, γ traced) so each solve's CG count shows."""
    iters = []

    @jax.jit
    def stage_solve(gamma, T):
        rhs = jop._zero_ess(jop.residual(T))
        mask = jop.ess_mask

        def lhs(v):
            z = v * mask
            return jop._implicit_lhs_apply(gamma, z) * mask + (v - z)

        diag = (jop.Mrc_diag + gamma * jop.A_diag) * mask + (1.0 - mask)
        inv = 1.0 / diag
        k, info = jsolvers.cg(lhs, rhs, M=lambda r: inv * r,
                              rel_tol=jop.rel_tol, max_iter=jop.max_iter,
                              dot=jop._dot())
        return jop._zero_ess(k), info.iterations

    class Counting:
        def implicit_solve(self, gamma, t, T):
            k, iterations = stage_solve(gamma, T)
            iters.append(int(iterations))
            return k

    solver, T, t = jode.select("sdirk33"), jnp.zeros(jop.fes.ndof), 0.0
    for _ in range(steps):
        T, t = solver.step(Counting(), T, t, 0.25)
    return np.asarray(T), iters


def test_masked_lattice_three_steps_match_jax():
    jfes, jkw = _masked(jcardiac, JCart, 8)
    tfes, tkw = _masked(tcardiac, CartesianFESpace, 8)
    assert np.array_equal(tkw["ess_dofs"], jkw["ess_dofs"])
    jop = jbio.BioheatOperator(fes=jfes, q_met=_src(jnp.exp), **PARAMS, **jkw)
    before = fd.diffusion_apply.launches
    top = tbio.BioheatOperator(tfes, q_met=_src(torch.exp), device="cpu",
                               **PARAMS, **tkw)
    # warped hexes: per-quadrature-point lane-major stage apply, and the
    # element-major residual (the fused diffusion apply's plain version here)
    assert top._lane is not None and top._aff is None and jop._aff is None
    assert not top.collapsed
    for name in ("b_const", "Mrc_diag", "A_diag", "ess_mask"):
        a, b = getattr(top, name).numpy(), np.asarray(getattr(jop, name))
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), name
    jT, jit = _run_jax(jop, 3)
    step, t = tbio.make_stepper(top, tode.select("sdirk33")), 0.0
    T = torch.zeros(tfes.ndof, dtype=torch.float64)
    for _ in range(3):
        T, t = step(T, t, 0.25)
    assert top.cg_iterations == jit and len(jit) == 9
    assert np.abs(T.numpy() - jT).max() <= 1e-10 * np.abs(jT).max()
    assert np.abs(jT).max() > 0.1
    # pinned dofs stay zero, and CPU tensors never launch the kernel
    assert not T.numpy()[tkw["ess_dofs"]].any()
    assert fd.diffusion_apply.launches == before
