"""The PyTorch port's structured lattice path against the JAX package, on
the CPU: ``StructuredRestriction`` (all four directions bitwise equal to
JAX's, and equal to the gather-plane ``ElementRestriction`` of the same map),
``CartesianFESpace`` (gather map, dof coordinates, essential dofs), and
``bench.py``'s default lattice settings (order 2, quad_extra 0, θ form,
fused setup, uniform-qdata collapse, SDIRK33, Jacobi-PCG rel_tol 1e-5) at
n=6 in float64: θ after three steps within 1e-10, equal CG iterations in
every stage solve, and the same apply branch (collapsed / affine)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem.cartesian import CartesianFESpace as JCart
from cardiac_ablation_ecm2_tpu.linalg import ode as jode
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.mesh.mesh import make_cartesian_3d as jcart
from cardiac_ablation_ecm2_tpu.models import bioheat as jbio
from cardiac_ablation_ecm2_tpu.utils.config import config as jcfg
from cardiac_ablation_ecm2_tpu.utils.config import configure as jconfigure
from cardiac_ablation_ecm2_tpu_torch.fem.build import restriction_for
from cardiac_ablation_ecm2_tpu_torch.fem.cartesian import CartesianFESpace
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import element_node_coords
from cardiac_ablation_ecm2_tpu_torch.fem.restriction import ElementRestriction
from cardiac_ablation_ecm2_tpu_torch.linalg import ode as tode
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
from cardiac_ablation_ecm2_tpu_torch.models import bioheat as tbio
from cardiac_ablation_ecm2_tpu_torch.utils.config import config as tcfg
from cardiac_ablation_ecm2_tpu_torch.utils.config import configure as tconfigure

L = 0.04
SHAPE = (3, 4, 2)
# bench.py:160-197 for the lattice: source amplitude 1e6, width² (L/8)²
PARAMS = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0, ess_bdr=[1, 2, 3, 4, 5, 6],
              rel_tol=1e-5, max_iter=300, fused_setup=True, theta_form=True,
              collapse_uniform_qdata=True)


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


def _spaces(shape, p, lengths=(1.0, 2.0, 0.5)):
    jm = jcart(*shape, *lengths)
    tm = make_cartesian_3d(*shape, *lengths)
    return JCart(jm, p, shape, lengths), CartesianFESpace(tm, p, shape, lengths)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_structured_restriction_equals_jax_and_gather_planes(p):
    jfes, tfes = _spaces(SHAPE, p)
    jr, tr = jfes.restriction, restriction_for(tfes, "cpu")
    assert tr is tfes.restriction
    assert (tr.ne, tr.nd, tr.nshape) == (jr.ne, jr.nd, jr.nshape)
    rng = np.random.default_rng(p)
    u = rng.standard_normal(tfes.ndof)
    ue = rng.standard_normal((tr.ne, tr.nd))
    ueT = np.ascontiguousarray(ue.T)
    tu, tue, tueT = (torch.from_numpy(a) for a in (u, ue, ueT))
    # each JAX direction jitted whole: one compile, not one per primitive
    for port, ref in (
            (tr.mult(tu), jax.jit(jr.mult)(jnp.asarray(u))),
            (tr.mult_t(tu), jax.jit(jr.mult_t)(jnp.asarray(u))),
            (tr.mult_transpose(tue), jax.jit(jr.mult_transpose)(jnp.asarray(ue))),
            (tr.mult_transpose_t(tueT),
             jax.jit(jr.mult_transpose_t)(jnp.asarray(ueT))),
            (tr.counts(), jax.jit(jr.counts)())):
        assert np.array_equal(port.numpy(), np.asarray(ref))
    assert tr.mult_t(tu).is_contiguous()
    # integer values: every sum exact, so any order agrees
    er = ElementRestriction(tfes.gather_map, tfes.ndof, "cpu")
    iu = torch.from_numpy(rng.integers(-99, 99, tfes.ndof).astype(np.float64))
    iue = torch.from_numpy(rng.integers(-99, 99, (tr.ne, tr.nd)).astype(np.float64))
    assert torch.equal(tr.mult(iu), er.mult(iu))
    assert torch.equal(tr.mult_t(iu), er.mult_t(iu))
    assert torch.equal(tr.mult_transpose(iue), er.mult_transpose(iue))
    iueT = iue.T.contiguous()
    assert torch.equal(tr.mult_transpose_t(iueT), er.mult_transpose_t(iueT))


@pytest.mark.parametrize("p", [1, 2, 3])
def test_cartesian_space_equals_jax(p):
    jfes, tfes = _spaces(SHAPE, p)
    assert (tfes.ndof, tfes.nd_elem) == (jfes.ndof, jfes.nd_elem)
    assert np.array_equal(tfes.gather_map, jfes.gather_map)
    assert np.array_equal(tfes.dof_coords, jfes.dof_coords)
    for marker in (None, [1], [2, 3], [1, 2, 3, 4, 5, 6], [4, 6]):
        assert np.array_equal(tfes.essential_dofs(marker),
                              jfes.essential_dofs(marker))
    # the mesh's element order and lex local nodes are the space's: each
    # element's node coordinates land on the dofs its gather row names
    X = element_node_coords(tfes.mesh, p).reshape(-1, 3)
    coords = np.full((tfes.ndof, 3), np.nan)
    coords[tfes.gather_map.reshape(-1)] = X
    assert np.allclose(coords, tfes.dof_coords, rtol=0, atol=1e-14)


def _src(exp):
    def src(x):
        r2 = sum((x[..., i] - L / 2) ** 2 for i in range(3))
        return 1e6 * exp(-r2 / (L / 8) ** 2)
    return src


class _CountingJax:
    """JAX ``BioheatOperator.implicit_solve`` written out, so that each
    stage solve's CG iteration count is visible; jitted whole with γ traced,
    so every stage solve runs one compiled program."""

    def __init__(self, op):
        self.op, self.iters = op, []
        self._solve = jax.jit(self._stage_solve)

    def implicit_solve(self, gamma, t, T):
        k, iterations = self._solve(gamma, T)
        self.iters.append(int(iterations))
        return k

    def _stage_solve(self, gamma, T):
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
        return op._zero_ess(k), info.iterations


def _run_jax(jop, T, steps):
    f, solver, t = _CountingJax(jop), jode.select("sdirk33"), 0.0
    T = jnp.asarray(T)
    for _ in range(steps):
        T, t = solver.step(f, T, t, 0.25)
    return np.asarray(T), f.iters


def _run_port(top, T, steps):
    step, t = tbio.make_stepper(top, tode.select("sdirk33")), 0.0
    T = torch.as_tensor(T)
    for _ in range(steps):
        T, t = step(T, t, 0.25)
    return T.numpy(), top.cg_iterations


def _lattice(n):
    shape, lengths = (n, n, n), (L, L, L)
    return _spaces(shape, 2, lengths)


@functools.lru_cache(maxsize=None)
def _jax_op(n, dtype):
    jfes, _ = _lattice(n)
    return jbio.BioheatOperator(fes=jfes, q_met=_src(jnp.exp), dtype=dtype,
                                **PARAMS)


def _branch(op):
    return (op.K_qd.shape[1] == 1, op._aff is not None)


def test_lattice_three_steps_match_jax():
    """bench.py's 48³ settings at n=6, float64: both packages collapse the
    uniform qdata and take the affine apply."""
    jop = _jax_op(6, "float64")
    _, tfes = _lattice(6)
    top = tbio.BioheatOperator(tfes, q_met=_src(torch.exp), dtype="float64",
                               device="cpu", **PARAMS)
    assert _branch(top) == _branch(jop) == (True, True)
    assert top.collapsed
    for name in ("b_const", "Mrc_diag", "A_diag", "ess_mask"):
        a, b = getattr(top, name).numpy(), np.asarray(getattr(jop, name))
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), name
    T0 = np.zeros(tfes.ndof)
    jT, jit = _run_jax(jop, T0, 3)
    tT, tit = _run_port(top, T0, 3)
    assert tit == jit and len(tit) == 9
    assert np.abs(tT - jT).max() <= 1e-10 * np.abs(jT).max()
    assert np.abs(jT).max() > 0.1


def test_lattice_float32_branch_matches_jax():
    """In float32 the rounded node coordinates defeat the 1e-12 collapse;
    the separable check (rtol 1e-5) then decides, the same way in both
    packages.  At n=6 both pass it and take the affine apply uncollapsed
    (False, True); at n=48 JAX's diffusion qdata deviate 4.6371e-05 from
    W ⊗ d and neither branch is taken (False, False), which
    ``chip_smoke.py`` [9] pins on the card (``PERF.md`` §4)."""
    jop = _jax_op(6, "float32")
    _, tfes = _lattice(6)
    top = tbio.BioheatOperator(tfes, q_met=_src(torch.exp), dtype="float32",
                               device="cpu", **PARAMS)
    assert _branch(top) == _branch(jop) == (False, True)
    assert not top.collapsed


@pytest.mark.parametrize("keys", ["affine", "collapsed qdata"])
def test_from_jax_arrays_on_lattice_matches_jax(keys):
    """The JAX operator's arrays on a ``CartesianFESpace``: its collapsed
    affine factors (1-element axes), or its collapsed qdata (then the port
    takes the lane-major apply, broadcasting (nq, 1))."""
    jop = _jax_op(6, "float64")
    _, tfes = _lattice(6)
    arrays = {k: np.asarray(getattr(jop, k))
              for k in ("b_const", "Mrc_diag", "A_diag", "ess_mask")}
    arrays["gather_map"] = np.asarray(jop.fes.gather_map)
    names = (("_dm", "_dw", "_dk") if keys == "affine"
             else ("Mrc_qd", "Mw_qd", "K_qd"))
    arrays.update({k: np.asarray(getattr(jop, k)) for k in names})
    top = tbio.from_jax_arrays(tfes, arrays, device="cpu", dtype="float64",
                               rel_tol=1e-5, max_iter=300)
    assert (top._aff is not None) == (keys == "affine")
    assert top.collapsed == (keys != "affine")
    theta = np.random.default_rng(2).uniform(0.0, 0.5, tfes.ndof)
    theta *= np.asarray(jop.ess_mask)
    jT, jit = _run_jax(jop, theta, 1)
    tT, tit = _run_port(top, theta, 1)
    assert tit == jit
    assert np.abs(tT - jT).max() <= 1e-10 * np.abs(jT).max()


def _separable_deviation(K_qd, W):
    """max |q/W − mean_q(q/W)| / max |mean_q(q/W)| of packed diffusion qdata
    (6, ne, nq): what the affine detector holds to rtol 1e-5."""
    r = np.asarray(K_qd) / np.asarray(W)[None, None, :]
    d = r.mean(axis=2, keepdims=True)
    return float(np.abs(r - d).max() / np.abs(d).max())


def _theta_max_per_step(n, steps, dtype):
    """``bench.py``'s default lattice (n³, order 2, quad_extra 0, θ form,
    fused setup, collapse on, SDIRK33 dt 0.25, rel_tol 1e-5) on the CPU:
    the apply branch and the separable deviation of each package, then θ_max
    and CG iterations per stage after each step, JAX and the port."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jconfigure(quad_extra=0)
    tconfigure(quad_extra=0)
    jfes, tfes = _lattice(n)
    jop = jbio.BioheatOperator(fes=jfes, q_met=_src(jnp.exp), dtype=dtype,
                               **PARAMS)
    top = tbio.BioheatOperator(tfes, q_met=_src(torch.exp), dtype=dtype,
                               device="cpu", **PARAMS)
    print(f"lattice n={n} {dtype}: {jfes.mesh.ne} hexes, {jfes.ndof} dofs")
    for name, op, W in (("JAX", jop, jop.db.W), ("port", top, top.db.W)):
        collapsed, affine = _branch(op)
        dev = ("-" if collapsed else
               f"{_separable_deviation(np.asarray(op.K_qd), np.asarray(W)):.4e}")
        print(f"{name}: collapsed {collapsed}, affine {affine}, diffusion "
              f"qdata separable deviation {dev}")
    f, solver = _CountingJax(jop), jode.select("sdirk33")
    tstep = tbio.make_stepper(top, tode.select("sdirk33"))
    jT, jt = jnp.zeros(jfes.ndof, jnp.dtype(dtype)), 0.0
    tT, tt = torch.zeros(tfes.ndof, dtype=getattr(torch, dtype)), 0.0
    for s in range(steps):
        jT, jt = solver.step(f, jT, jt, 0.25)
        tT, tt = tstep(tT, tt, 0.25)
        print(f"step {s + 1}: theta_max JAX {float(jT.max()):.10f}, port "
              f"{float(tT.max()):.10f}; CG iterations JAX {f.iters[-3:]}, "
              f"port {top.cg_iterations[-3:]}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=_theta_max_per_step.__doc__)
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtype", default="float64")
    a = ap.parse_args()
    _theta_max_per_step(a.n, a.steps, a.dtype)
