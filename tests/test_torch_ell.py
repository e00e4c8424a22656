"""The port's assembled-ELL path against the JAX package, float64 on the
CPU, with the benchmark's settings (order 2, quad_extra 0, theta form, fused
setup, SDIRK33, dt 0.25, Jacobi-PCG rel_tol 1e-5) on the cardiac tet mesh:

* FULL assembly: the same CSR pattern as JAX ``BilinearForm.assemble_matrix``
  and data at rtol 1e-12 (element sums run in another order);
* the sliced-ELL pair (plain version, which CPU tensors take) against JAX
  ``MultiELLPair.mult_combined`` in Pallas interpret mode at rtol 1e-12, and
  against scipy on random pairs of varying row width;
* the operator: setup arrays at rtol 1e-12, θ after three steps at rtol
  1e-10 with equal CG iterations in every stage solve, and one step through
  ``from_jax_arrays`` with the JAX operator's cached CSR pair.

The JAX operator's ELL applies run in Pallas interpret mode, each from its
jit cache, inside a Python copy of the JAX CG loop."""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.linalg import ode as jode
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_tet_mesh as jmake
from cardiac_ablation_ecm2_tpu.models import bioheat as jbio
from cardiac_ablation_ecm2_tpu.ops.bilinearform import BilinearForm as JBilinearForm
from cardiac_ablation_ecm2_tpu.utils.config import config as jcfg
from cardiac_ablation_ecm2_tpu.utils.config import configure as jconfigure
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import ode as tode
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_tet_mesh
from cardiac_ablation_ecm2_tpu_torch.models import bioheat as tbio
from cardiac_ablation_ecm2_tpu_torch.ops import ell as tell
from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
from cardiac_ablation_ecm2_tpu_torch.utils.config import config as tcfg
from cardiac_ablation_ecm2_tpu_torch.utils.config import configure as tconfigure

L = 0.04
CTR = (L / 2, L / 2, L / 2)
KW = dict(lengths=(L, L, L / 2), electrode_radius=0.004)
N = 4
DT = 0.25
PARAMS = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0, ess_bdr=[1, 2, 3, 4, 5, 6],
              rel_tol=1e-5, max_iter=300, dtype="float64", fused_setup=True,
              theta_form=True, assembled_apply="ell")


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


def close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


def _jax_cg(A, b, M, rel_tol, max_iter, dot):
    """``linalg.solvers.cg`` of the JAX package with its ``lax.while_loop``
    unrolled into Python: the same updates in the same order, on JAX
    arrays, so each interpret-mode ELL apply is dispatched from its jit
    cache instead of compiling a loop body of dozens of Pallas calls."""
    x = jnp.zeros_like(b)
    r = b - A(x)
    d = M(r)
    nom = dot(d, r)
    target = jnp.maximum(rel_tol * rel_tol * nom, 0.0)
    k, done = 0, bool(nom <= target)
    while k < max_iter and not done:
        Ad = A(d)
        alpha = nom / dot(d, Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        z = M(r)
        betanom = dot(r, z)
        done = bool(betanom <= target)
        d = z + (betanom / nom) * d
        nom = betanom
        k += 1
    return x, k


class _JaxSolver:
    """JAX ``BioheatOperator.implicit_solve`` written out, recording each
    stage solve's CG iteration count."""

    def __init__(self, op):
        self.op, self.iters = op, []

    def implicit_solve(self, gamma, t, T):
        op = self.op
        rhs = op._zero_ess(op.residual(T))
        mask = op.ess_mask

        def lhs(v):
            z = v * mask
            return op._implicit_lhs_apply(gamma, z) * mask + (v - z)

        inv = 1.0 / ((op.Mrc_diag + gamma * op.A_diag) * mask + (1.0 - mask))
        k, its = _jax_cg(lhs, rhs, lambda r: inv * r, op.rel_tol, op.max_iter,
                         op._dot())
        self.iters.append(its)
        return op._zero_ess(k)

    def run(self, T, steps):
        self.iters = []
        solver, t, T = jode.select("sdirk33"), 0.0, jnp.asarray(T)
        for _ in range(steps):
            T, t = solver.step(self, T, t, DT)
        return np.asarray(T), self.iters


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    """The JAX ELL operator (built once: its setup compiles), its solver,
    and the CSR pair its ELL cache wrote."""
    old_q = jcfg.quad_extra
    jconfigure(quad_extra=0)
    cache = str(tmp_path_factory.mktemp("ell") / "pair.npz")
    old = os.environ.get("CAX_ELL_CACHE")
    os.environ["CAX_ELL_CACHE"] = cache
    try:
        jfes = JFESpace(jmake(N, **KW), 2)
        jop = jbio.BioheatOperator(fes=jfes, q_met=_src(jnp.exp), **PARAMS)
    finally:
        if old is None:
            del os.environ["CAX_ELL_CACHE"]
        else:
            os.environ["CAX_ELL_CACHE"] = old
        jconfigure(quad_extra=old_q)
    with np.load(cache) as z:
        csr = {k: z[k] for k in z.files}
    return jop, _JaxSolver(jop), csr


def _port_op(**kw):
    fes = FESpace(make_cardiac_tet_mesh(N, **KW), 2)
    return tbio.BioheatOperator(fes, q_met=_src(torch.exp), device="cpu",
                                **dict(PARAMS, **kw))


@pytest.mark.parametrize("kind,coeff", [("mass", 3.6e6), ("diffusion", 0.54)])
def test_full_assembly_equals_jax(kind, coeff):
    jfes, tfes = (JFESpace(jmake(6, **KW), 2),
                  FESpace(make_cardiac_tet_mesh(6, **KW), 2))
    J = JBilinearForm(jfes).add_domain_integrator(kind, coeff).assemble_matrix(
        "float64")
    T = BilinearForm(tfes, "cpu").add_domain_integrator(
        kind, coeff).assemble_matrix("float64")
    assert np.array_equal(T.indptr, J.indptr)
    assert np.array_equal(T.indices, J.indices)
    close(T.data, J.data, 1e-12)


def _random_varwidth(n, seed):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(n):
        k = int(rng.integers(1, 20)) if rng.random() > 0.1 else int(rng.integers(40, 140))
        c = rng.choice(n, size=min(k, n), replace=False)
        rows += [r] * len(c)
        cols += list(c)
    return sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                         shape=(n, n))


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12), ("float32", 1e-5)])
def test_pair_plain_matches_scipy(dtype, rtol):
    A, B = _random_varwidth(900, 3), _random_varwidth(900, 4)
    pair = tell.MultiELLPair.from_csr_pair(A, B, dtype, "cpu")
    # every row in exactly one slice of 32, each slice as wide as its widest
    # row, rows sorted by width (descending) within a window of SIGMA rows
    order = pair.row_ids.numpy()
    assert np.array_equal(np.sort(order), np.arange(900))
    nnz = np.diff((abs(A) + abs(B)).tocsr().indptr)[order]
    widths = np.diff(pair.slice_ptr.numpy()) // tell.SLICE
    assert np.array_equal(widths, [nnz[s:s + tell.SLICE].max()
                                   for s in range(0, 900, tell.SLICE)])
    assert 900 <= tell.SIGMA and np.all(np.diff(nnz) <= 0)
    assert pair.nnz == (abs(A) + abs(B)).nnz
    x = np.random.default_rng(5).standard_normal(900)
    tx = torch.as_tensor(x, dtype=pair.w0.dtype)
    for c0, c1 in ((1.0, 0.0), (0.0, 1.0), (1.0, 0.37), (-2.0, 5.0)):
        y = pair.mult_combined(tx, c0, c1).double().numpy()
        close(y, c0 * (A @ x) + c1 * (B @ x), rtol)
    close(pair.diag0, A.diagonal(), rtol)
    close(pair.diag1, B.diagonal(), rtol)


def test_mult_combined_matches_jax_interpret(jax_case):
    jop, _, _ = jax_case
    top = _port_op()
    x = np.random.default_rng(6).standard_normal(jop.fes.ndof)
    gamma = DT * float(tode.SDIRK33.a[0, 0])
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    close(top._ell.mult_combined(tx, 1.0, gamma),
          jop._ell.mult_combined(jx, 1.0, gamma), 1e-12)
    close(top._ell.mult0(tx), jop._ell.mult0(jx), 1e-12)
    close(top._ell.mult1(tx), jop._ell.mult1(jx), 1e-12)
    close(top._ell.diag0, jop._ell.diag0, 1e-12)
    close(top._ell.diag1, jop._ell.diag1, 1e-12)


def _old_bucket_slots(nnz):
    """Slots of the width buckets of 8 the SELL slices replaced."""
    top = int(nnz.max())
    edges = np.asarray([e for e in range(8, 129, 8) if e < top] + [top])
    b = np.searchsorted(edges, nnz, side="left")
    return sum(int(nnz[b == k].max()) * int((b == k).sum())
               for k in range(len(edges)) if (b == k).any())


def test_sell_slices_hold_every_entry_once():
    """The tet n=6 pair: every (row, column, weight) of both matrices sits in
    exactly one live slot (the others hold the sentinel column and zero
    weights), and the slices pad less than the old width buckets did."""
    fes = FESpace(make_cardiac_tet_mesh(6, **KW), 2)
    M, A = (BilinearForm(fes, "cpu").add_domain_integrator(k, c).assemble_matrix()
            for k, c in (("mass", 3.6e6), ("diffusion", 0.54)))
    pair = tell.MultiELLPair.from_csr_pair(M, A, "float64", "cpu")
    n, S = pair.n, tell.SLICE
    cols, w0, w1 = (t.numpy() for t in (pair.cols, pair.w0, pair.w1))
    ptr, rows = pair.slice_ptr.numpy(), pair.row_ids.numpy()
    slot = np.arange(cols.size)
    s = np.searchsorted(ptr, slot, side="right") - 1
    r = s * S + (slot - ptr[s]) % S            # sorted row of each slot
    live = cols < n
    assert np.all(r[live] < n) and not w0[~live].any() and not w1[~live].any()
    P = (abs(M) + abs(A)).tocsr()
    got = sp.csr_matrix((np.ones(live.sum()), (rows[r[live]], cols[live])),
                        shape=(n, n))
    assert got.nnz == P.nnz == live.sum() == pair.nnz
    assert (got != (P != 0)).nnz == 0 and got.max() == 1
    for W, X in ((w0, M), (w1, A)):
        Y = sp.csr_matrix((W[live], (rows[r[live]], cols[live])), shape=(n, n))
        assert abs(Y - X).max() == 0
    old = _old_bucket_slots(np.diff(P.indptr))
    print(f"tet n=6: padding {pair.padding:.4f}, old buckets {old / P.nnz - 1:.4f}")
    assert cols.size < old


def _pair_formula(pair, x, c0, c1):
    """(c0·M0 + c1·M1) x with the weights combined per entry,
    fl(fl(c0·w0) + fl(c1·w1)), as the JAX kernel does in registers, then
    the row sums in level order (level 0 initialising)."""
    c0, c1 = (torch.tensor(c, dtype=x.dtype) for c in (c0, c1))
    xp = torch.cat([x, x.new_zeros(1)])
    r = torch.arange(pair.n)
    base = pair.slice_ptr[r // tell.SLICE] + r % tell.SLICE
    width = (pair.slice_ptr[r // tell.SLICE + 1]
             - pair.slice_ptr[r // tell.SLICE]) // tell.SLICE
    acc = torch.zeros_like(x)
    for j in range(pair.max_width):
        q = torch.clamp(base + tell.SLICE * j, max=pair.cols.numel() - 1)
        p = (c0 * pair.w0[q] + c1 * pair.w1[q]) * xp[pair.cols[q].long()]
        acc = torch.where(width > j, p if j == 0 else acc + p, acc)
    y = torch.empty_like(x)
    y[pair.row_ids.long()] = acc
    return y


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_combined_plane_bitwise_equals_pair(dtype):
    """One weight plane c0·w0 + c1·w1 streamed alone gives the per-entry
    pair product bit for bit (plain version), −0.0 entries of x included,
    and ``mult_combined`` is that product."""
    A, B = _random_varwidth(700, 8), _random_varwidth(700, 9)
    pair = tell.MultiELLPair.from_csr_pair(A, B, dtype, "cpu")
    x = torch.as_tensor(np.random.default_rng(10).standard_normal(700),
                        dtype=pair.w0.dtype)
    x[::13] = -0.0
    bits = torch.int64 if dtype == "float64" else torch.int32
    for c0, c1 in ((1.0, 0.10896662), (0.0, 1.0), (1.0, 0.0), (-2.0, 5.0)):
        plane = pair.combined(c0, c1)
        y = tell.ell_spmv(plane, x)
        assert torch.equal(y.view(bits), _pair_formula(pair, x, c0, c1).view(bits))
        assert torch.equal(plane.mult(x).view(bits), y.view(bits))
        assert torch.equal(pair.mult_combined(x, c0, c1).view(bits), y.view(bits))
    with pytest.raises(ValueError):
        tell.ell_spmv(pair, x)


def test_combined_plane_matches_jax_interpret(jax_case):
    """The stage and residual planes the operator forms against JAX
    ``MultiELLPair.mult_combined`` (interpret mode) at rtol 1e-12."""
    jop, _, _ = jax_case
    top = _port_op()
    x = np.random.default_rng(11).standard_normal(jop.fes.ndof)
    gamma = DT * float(tode.SDIRK33.a[0, 0])
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    close(top._stage_apply(gamma)(tx), jop._ell.mult_combined(jx, 1.0, gamma),
          1e-12)
    close(top._A_apply(tx), jop._ell.mult1(jx), 1e-12)
    clone = top.override(_ell=top._ell)
    assert clone._ell_A is not top._ell_A
    assert torch.equal(clone._A_apply(tx), top._A_apply(tx))


def test_three_ell_steps_match_jax(jax_case):
    jop, jsolve, _ = jax_case
    top = _port_op()
    assert top._ell is not None and top._lane is None
    for name in ("b_const", "Mrc_diag", "A_diag", "ess_mask"):
        close(getattr(top, name), getattr(jop, name), 1e-12)
    T0 = np.zeros(jop.fes.ndof)
    jT, jit = jsolve.run(T0, 3)
    step, t, T = tbio.make_stepper(top, tode.select("sdirk33")), 0.0, torch.as_tensor(T0)
    for _ in range(3):
        T, t = step(T, t, DT)
    assert top.cg_iterations == jit
    assert len(jit) == 9
    close(T.numpy(), jT, 1e-10)
    assert np.abs(jT).max() > 0.1


def test_from_jax_arrays_ell_step_matches_jax(jax_case):
    jop, jsolve, csr = jax_case
    arrays = {k: np.asarray(v) for k, v in jbio.big_arrays(jop).items()
              if k not in ("restr", "_ell")}
    arrays.update(csr, gather_map=np.asarray(jop.fes.gather_map))
    params = {k: PARAMS[k] for k in ("rel_tol", "max_iter", "dtype", "theta_form")}
    top = tbio.from_jax_arrays(FESpace(make_cardiac_tet_mesh(N, **KW), 2),
                               arrays, device="cpu", **params)
    assert top._ell is not None
    theta = np.random.default_rng(2).uniform(0.0, 0.5, jop.fes.ndof)
    theta *= np.asarray(jop.ess_mask)
    jT, jit = jsolve.run(theta, 1)
    step = tbio.make_stepper(top, tode.select("sdirk33"))
    T, _ = step(torch.as_tensor(theta), 0.0, DT)
    assert top.cg_iterations == jit
    close(T.numpy(), jT, 1e-10)


def _theta_max_per_step(n, steps):
    """θ_max after each of ``steps`` SDIRK33 steps on tet mesh ``n`` with
    the benchmark's settings in float64 on the CPU: the JAX package on its
    partial-assembly apply, and the port on its assembled ELL (plain)."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jconfigure(dtype="float64", quad_extra=0)
    tconfigure(quad_extra=0)
    jfes = JFESpace(jmake(n, **KW), 2)
    params = dict(PARAMS, assembled_apply="off")
    jop = jbio.BioheatOperator(fes=jfes, q_met=_src(jnp.exp), **params)
    fes = FESpace(make_cardiac_tet_mesh(n, **KW), 2)
    top = tbio.BioheatOperator(fes, q_met=_src(torch.exp), device="cpu", **PARAMS)
    print(f"cardiac tet n={n}: {jfes.mesh.ne} tets, {jfes.ndof} dofs")
    jstep = jbio.make_stepper(jop, jode.select("sdirk33"))
    tstep = tbio.make_stepper(top, tode.select("sdirk33"))
    jT, jt = jnp.zeros(jfes.ndof), jnp.asarray(0.0)
    tT, tt = torch.zeros(fes.ndof, dtype=torch.float64), 0.0
    for s in range(steps):
        jT, jt = jstep(jT, jt, jnp.asarray(DT))
        tT, tt = tstep(tT, tt, DT)
        print(f"step {s + 1}: theta_max JAX {float(jT.max()):.8f}, port "
              f"{float(tT.max()):.8f}, port CG iterations {top.cg_iterations[-3:]}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=_theta_max_per_step.__doc__)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args()
    _theta_max_per_step(a.n, a.steps)
