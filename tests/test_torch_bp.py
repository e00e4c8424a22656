"""The port's CEED BP harness (``cardiac_ablation_ecm2_tpu_torch/benchmarks/
bp.py``) against the root ``benchmarks/bp.py``'s solve on the CPU, float64,
at ``--n 4``, in every mode (generic hex, ``--structured``, ``--simplex``,
``--ell`` on hexes and on tets), orders 1–4, BP1 and BP3: the same space,
operator, constraint, Jacobi preconditioner and fixed-work CG
(``check_convergence=False``) from b = 1.  The JAX side is the root
script's loop written out with its jitted CG; in the ``--ell`` modes its
ELL apply (a Pallas kernel, interpret mode on the CPU) is replaced by the
same FULL-assembled matrix as a dense product, since ``test_torch_operators``
holds the port's ELL operators to JAX's on their own.

The iterates are held after 8 iterations, finite and within 1e-10 of
max|x|.  The harness's default 100 iterations are not comparable on these
tiny spaces (125 to 729 dofs): CG converges exactly long before, and then
the fixed-work loop divides 0 by 0 at an iteration that depends on the last
bit of the residual, so one package's iterate may be NaN where the other's
is not.  ``test_torch_operators`` holds ``cg(check_convergence=False)`` to
exactly ``max_iter`` iterations."""

import functools
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.fem.cartesian import CartesianFESpace as JCartesian
from cardiac_ablation_ecm2_tpu.linalg.smoothers import jacobi as jjacobi
from cardiac_ablation_ecm2_tpu.linalg.solvers import cg as jcg
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_3d as jhex
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_3d_tet as jtet
from cardiac_ablation_ecm2_tpu.ops import BilinearForm as JForm
from cardiac_ablation_ecm2_tpu.ops import ConstrainedOperator as JConstrained
from cardiac_ablation_ecm2_tpu.ops.operators import LinearOperator as JOperator
from cardiac_ablation_ecm2_tpu.utils.config import config as jcfg
from cardiac_ablation_ecm2_tpu.utils.config import configure as jconfigure
from cardiac_ablation_ecm2_tpu_torch.benchmarks import bp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 4
MODES = {"generic": {}, "structured": dict(structured=True),
         "simplex": dict(simplex=True), "ell": dict(ell=True),
         "ell-simplex": dict(ell=True, simplex=True)}
ITERS = 8


@pytest.fixture(scope="module", autouse=True)
def _jax_float64():
    old = jcfg.dtype
    jconfigure(dtype="float64")
    yield
    jconfigure(dtype=old)


@functools.lru_cache(maxsize=None)
def _jax_space(order, structured=False, simplex=False):
    """The root script's space of one order (shared by the PA and the ELL
    modes, as are its cached geometric factors)."""
    n = max(2, N // order)
    if simplex:
        return JFESpace(jtet(n, n, n), order)
    mesh = jhex(n, n, n)
    return JCartesian(mesh, order, (n, n, n)) if structured else JFESpace(mesh, order)


def _jax_solve(fes, kind, ell):
    """The root script's solve of one BP."""
    a = JForm(fes).add_domain_integrator(kind)
    if ell:
        A = jnp.asarray(a.assemble_matrix().toarray())
        op = JOperator(A.shape, lambda x: A @ x, lambda: jnp.diagonal(A))
    else:
        op = a.assemble().operator()
    ess = fes.essential_dofs() if kind == "diffusion" else []
    Ac = JConstrained.wrap(op, ess)
    M = jjacobi(jax.jit(Ac.diagonal)())
    b = jnp.ones(fes.ndof, dtype=jnp.float64)
    x, info = jax.jit(lambda b: jcg(Ac.mult, b, M=M, rel_tol=0.0,
                                    max_iter=ITERS,
                                    check_convergence=False))(b)
    return np.asarray(x), int(info.iterations)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bp_run_equals_root_script(mode, capsys):
    kw = MODES[mode]
    runs = bp.run((1, 2, 3, 4), N, "float64", ITERS, device="cpu", **kw)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["bench"] for ln in lines] == ["BP1", "BP3"] * 4
    k = 0
    for order in (1, 2, 3, 4):
        fes = _jax_space(order, kw.get("structured", False),
                         kw.get("simplex", False))
        for bench, kind in (("BP1", "mass"), ("BP3", "diffusion")):
            xj, itj = _jax_solve(fes, kind, kw.get("ell", False))
            r = runs[k]
            assert (r["bench"], r["order"], r["ndof"]) == (bench, order, fes.ndof)
            assert r["cg_iters"] == lines[k]["cg_iters"] == itj == ITERS
            x = r["x"].numpy()
            assert np.isfinite(x).all()
            assert np.abs(x - xj).max() <= 1e-10 * np.abs(xj).max()
            k += 1
