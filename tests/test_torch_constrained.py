"""The port's constrained and bound-constrained solvers against the JAX
package, float64 on the CPU:

* ``linalg/constrained.py``: the three strategies on JAX's dense KKT
  system (the penalty at 1e4, not JAX's 1e10): x and λ within 1e-10
  relative, equal CG / MINRES counts (ex28's sliding trapezoid is in
  ``test_torch_ex28.py``);
* ``linalg/opt.py``: ``slbqp`` (equal bisection counts, x to 1e-10) and
  ``nnls`` (the host copy) against JAX's.

The obstacle solver is in ``test_torch_obstacle.py``, topology
optimisation in ``test_torch_topopt.py``; they share this module's
helpers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.linalg import constrained as jc
from cardiac_ablation_ecm2_tpu.linalg import opt as jopt
from cardiac_ablation_ecm2_tpu_torch.linalg import constrained as tc
from cardiac_ablation_ecm2_tpu_torch.linalg import opt as topt

RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


def same_info(ti, ji):
    assert (ti.iterations, ti.converged) == (int(ji.iterations), bool(ji.converged)), (ti, ji)


def test_dense_kkt():
    rng = np.random.default_rng(3)
    n, m = 40, 5
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    rows = [[(int(c), float(rng.standard_normal())) for c in rng.choice(n, 3, replace=False)]
            for _ in range(m)]
    f, r = rng.standard_normal(n), rng.standard_normal(m)
    Bj = jc.from_rows(rows, n, dtype=jnp.float64)
    Bt = tc.from_rows(rows, n, dtype="float64", device="cpu")
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    fj, rj, ft, rt = jnp.asarray(f), jnp.asarray(r), torch.as_tensor(f), torch.as_tensor(r)
    close(Bt.mult(ft), Bj.mult(fj), 1e-14)
    close(Bt.mult_t(rt), Bj.mult_t(rj), 1e-14)
    close(Bt.gram_cholesky(), Bj.gram_cholesky(), 1e-14)
    pairs = [
        (jc.eliminate_constrained_solve(lambda v: Aj @ v, Bj, fj, r=rj, rel_tol=1e-13),
         tc.eliminate_constrained_solve(lambda v: At @ v, Bt, ft, r=rt, rel_tol=1e-13)),
        (jc.schur_constrained_solve(lambda v: Aj @ v, Bj, fj, r=rj,
                                    Adiag=jnp.asarray(np.diag(A)), rel_tol=1e-13),
         tc.schur_constrained_solve(lambda v: At @ v, Bt, ft, r=rt,
                                    Adiag=torch.as_tensor(np.diag(A)), rel_tol=1e-13)),
        # JAX's test takes penalty 1e10, where CG on a system of condition
        # ~1e10 counts its iterations within round-off (47 against 50 here)
        (jc.penalty_constrained_solve(lambda v: Aj @ v, Bj, fj, r=rj, penalty=1e4,
                                      rel_tol=1e-13),
         tc.penalty_constrained_solve(lambda v: At @ v, Bt, ft, r=rt, penalty=1e4,
                                      rel_tol=1e-13)),
    ]
    for (xj, lj, ij), (xt, lt, it) in pairs:
        same_info(it, ij)
        close(xt, xj)
        close(lt, lj)


def test_slbqp_and_nnls():
    rng = np.random.default_rng(1)
    w = rng.uniform(-0.4, 1.4, 80)
    vol = rng.uniform(0.5, 2.0, 80)
    mass = float(np.sum(vol * np.clip(w, 0, 1))) + 0.3
    for kw in (dict(), dict(weights=vol)):
        a = mass if kw else 10.0
        xj, kj = jopt.slbqp(jnp.asarray(w), 0.0, 1.0, a,
                            **{k: jnp.asarray(v) for k, v in kw.items()})
        xt, kt = topt.slbqp(torch.as_tensor(w), 0.0, 1.0, a,
                            **{k: torch.as_tensor(v) for k, v in kw.items()})
        assert kt == kj
        close(xt, xj)
    A = rng.standard_normal((30, 12))
    b = rng.standard_normal(30)
    assert np.array_equal(topt.nnls(A, b), jopt.nnls(A, b))


