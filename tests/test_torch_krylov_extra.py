"""The port's MINRES, BiCGStab, FGMRES and ``ortho_wrap``
(``linalg/krylov_extra.py``) against the JAX package on the JAX tests'
systems, float64 on the CPU: equal iteration counts and convergence flags,
x within 1e-10 relative; MINRES also on the indefinite Helmholtz system of
a PA operator (JAX's ``test_indefinite_helmholtz_gmres_minres``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.linalg import krylov_extra as jk
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.ops import BilinearForm as JBilinearForm
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import krylov_extra as tk
from cardiac_ablation_ecm2_tpu_torch.linalg import solvers as tsolvers
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d
from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-10


def close(a, b, rtol=RTOL):
    a, b = a.numpy(), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= rtol, err


def same_info(ti, ji):
    assert (ti.iterations, ti.converged) == (int(ji.iterations), bool(ji.converged)), (ti, ji)


def dense_pair(A):
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    return (lambda v: Aj @ v), (lambda v: At @ v)


def _rand_spd(n, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.random((n, n)))
    return Q @ np.diag(np.linspace(1.0, 50.0, n)) @ Q.T


def test_minres_indefinite():
    A = _rand_spd(30, 2)
    A[:10] *= -1.0
    A = 0.5 * (A + A.T)
    b = np.random.default_rng(3).random(30)
    Aj, At = dense_pair(A)
    d = np.abs(np.diag(A)) + 1.0
    for M in (None, "jacobi"):
        Mj = None if M is None else (lambda r: r / jnp.asarray(d))
        Mt = None if M is None else (lambda r: r / torch.as_tensor(d))
        xj, ij = jk.minres(Aj, jnp.asarray(b), M=Mj, rel_tol=1e-11, max_iter=300)
        xt, it = tk.minres(At, torch.as_tensor(b), M=Mt, rel_tol=1e-11, max_iter=300)
        same_info(it, ij)
        close(xt, xj)


def test_bicgstab():
    rng = np.random.default_rng(4)
    A = np.eye(40) * 4 + 0.5 * rng.random((40, 40))
    b = rng.random(40)
    Aj, At = dense_pair(A)
    d = np.diag(A)
    for M in (None, "jacobi"):
        Mj = None if M is None else (lambda r: r / jnp.asarray(d))
        Mt = None if M is None else (lambda r: r / torch.as_tensor(d))
        xj, ij = jk.bicgstab(Aj, jnp.asarray(b), M=Mj, rel_tol=1e-12, max_iter=300)
        xt, it = tk.bicgstab(At, torch.as_tensor(b), M=Mt, rel_tol=1e-12, max_iter=300)
        same_info(it, ij)
        close(xt, xj)


def _system(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return np.eye(n) * 4 + rng.standard_normal((n, n)) * 0.3, rng.standard_normal(n)


@pytest.mark.parametrize("restart,max_iter", [(20, 200), (5, 200), (5, 10)])
def test_fgmres_plain(restart, max_iter):
    A, b = _system()
    Aj, At = dense_pair(A)
    xj, ij = jk.fgmres(Aj, jnp.asarray(b), rel_tol=1e-12, restart=restart,
                       max_iter=max_iter)
    xt, it = tk.fgmres(At, torch.as_tensor(b), rel_tol=1e-12, restart=restart,
                       max_iter=max_iter)
    same_info(it, ij)
    close(xt, xj)


def test_fgmres_variable_preconditioner():
    """JAX's alternating-sweep preconditioner: each package counts its own
    applications, which FGMRES makes in the same order."""
    A, b = _system(seed=3)
    Aj, At = dense_pair(A)

    def make(mv, d):
        state = {"k": 0}

        def M(v):
            state["k"] += 1
            z = v / d
            for _ in range(1 + state["k"] % 3):
                z = z + (v - mv(z)) / d
            return z
        return M

    xj, ij = jk.fgmres(Aj, jnp.asarray(b), M=make(Aj, jnp.asarray(np.diag(A))),
                       rel_tol=1e-12, restart=20, max_iter=200)
    xt, it = tk.fgmres(At, torch.as_tensor(b), M=make(At, torch.as_tensor(np.diag(A))),
                       rel_tol=1e-12, restart=20, max_iter=200)
    same_info(it, ij)
    close(xt, xj)


def test_ortho_singular_neumann():
    n = 30
    A = 2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    A[0, 0] = A[-1, -1] = 1.0
    b = np.random.default_rng(1).standard_normal(n)
    b = b - b.mean()
    Aj, At = dense_pair(A)
    xj, ij = jsolvers.cg(jk.ortho_wrap(Aj), jnp.asarray(b) - jnp.mean(jnp.asarray(b)),
                         rel_tol=1e-12, max_iter=500)
    bt = torch.as_tensor(b)
    xt, it = tsolvers.cg(tk.ortho_wrap(At), bt - torch.mean(bt), rel_tol=1e-12,
                         max_iter=500)
    same_info(it, ij)
    close(xt, xj)


def test_minres_helmholtz_pa():
    """(−Δ − 3π²) on 6×6 order 1 with u = 0 on ∂Ω: indefinite, PA
    operators of each package."""
    k2 = 3.0 * np.pi ** 2
    out = []
    for fes, form, arr in ((JFESpace(jquad(6, 6), 1), JBilinearForm, jnp.asarray),
                           (FESpace(make_cartesian_2d(6, 6), 1),
                            lambda f: BilinearForm(f, "cpu"), torch.as_tensor)):
        A = form(fes).add_domain_integrator("diffusion") \
            .add_domain_integrator("mass", coeff=-k2).assemble()
        m = np.ones(fes.ndof_scalar)
        m[fes.essential_dofs()] = 0.0
        m = arr(m)
        b = arr(np.random.default_rng(0).standard_normal(fes.ndof_scalar)) * m
        Am = lambda v: A.mult(v * m) * m + v * (1 - m)
        mod = jk if arr is jnp.asarray else tk
        out.append(mod.minres(Am, b, rel_tol=1e-11, max_iter=500))
    (xj, ij), (xt, it) = out
    same_info(it, ij)
    close(xt, xj)
