"""The port's LOBPCG and block ILU(0) against the JAX package, float64 on
the CPU:

* ``linalg/lobpcg.py`` on ex11's Dirichlet Laplace pencil (JAX's
  ``test_lobpcg_laplace_eigenvalues`` at 8×8, order 2, k = 5, 40
  iterations, Jacobi, the constraint projector) from JAX's own start block
  (``jax.random.normal(PRNGKey(0))``, passed as ``X0``): eigenvalues within
  1e-10 relative and the residual norms to 1e-10 of the eigenvalues; and
  on a dense SPD pencil without M;
* ``linalg/blockilu.py`` on JAX's block-tridiagonal, 2D-grid and star
  matrices: the level schedule (rows, columns and blocks), the apply to
  1e-12, and BlockILU-PCG with JAX's CG count."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.linalg.blockilu import block_ilu0 as jilu
from cardiac_ablation_ecm2_tpu.linalg.lobpcg import lobpcg as jlobpcg
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.ops import BilinearForm as JBilinearForm
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import solvers as tsolvers
from cardiac_ablation_ecm2_tpu_torch.linalg.blockilu import block_ilu0
from cardiac_ablation_ecm2_tpu_torch.linalg.lobpcg import lobpcg
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d
from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol):
    a, b = a.numpy(), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= rtol, err


def _laplace(fes, form, arr):
    A = form(fes).add_domain_integrator("diffusion").assemble()
    M = form(fes).add_domain_integrator("mass").assemble()
    m = np.ones(fes.ndof_scalar)
    m[fes.essential_dofs()] = 0.0
    m = arr(m)
    proj = lambda v: v * m
    Aop = lambda v: A.mult(v * m) * m + v * (1 - m)
    Mop = lambda v: proj(M.mult(proj(v)))
    diag = A.diagonal() * m + (1 - m)
    return Aop, Mop, (lambda r: r / diag), proj


def test_lobpcg_laplace():
    jf, tf = JFESpace(jquad(8, 8), 2), FESpace(make_cartesian_2d(8, 8), 2)
    n, k = jf.ndof, 5
    X0 = jax.random.normal(jax.random.PRNGKey(0), (n, k), dtype=jnp.float64)
    jA, jM, jP, jproj = _laplace(jf, JBilinearForm, jnp.asarray)
    tA, tM, tP, tproj = _laplace(tf, lambda f: BilinearForm(f, "cpu"), torch.as_tensor)
    rj = jlobpcg(jA, jM, n, k, precond=jP, iters=40, constraint=jproj)
    rt = lobpcg(tA, tM, n, k, precond=tP, iters=40, constraint=tproj,
                X0=torch.as_tensor(np.asarray(X0)))
    close(rt.eigenvalues, rj.eigenvalues, 1e-10)
    lam = np.sort(rt.eigenvalues.numpy())[:4] / np.pi ** 2
    assert np.allclose(lam, [2, 5, 5, 8], rtol=2e-2), lam
    assert np.abs(rt.residuals.numpy() - np.asarray(rj.residuals)).max() \
        <= 1e-10 * float(rt.eigenvalues.max())
    # M-orthonormal eigenvectors
    G = rt.eigenvectors.T @ torch.stack([tM(rt.eigenvectors[:, j]) for j in range(k)], 1)
    assert torch.allclose(G, torch.eye(k, dtype=G.dtype), atol=1e-10)


def test_lobpcg_dense_identity_mass():
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.random((30, 30)))
    A = Q @ np.diag(np.linspace(1.0, 30.0, 30)) @ Q.T
    X0 = rng.standard_normal((30, 3))
    rj = jlobpcg(lambda v: jnp.asarray(A) @ v, None, 30, 3, iters=30, X0=jnp.asarray(X0))
    rt = lobpcg(lambda v: torch.as_tensor(A) @ v, None, 30, 3, iters=30,
                X0=torch.as_tensor(X0))
    close(rt.eigenvalues, rj.eigenvalues, 1e-10)
    assert np.allclose(rt.eigenvalues.numpy(), [1.0, 2.0, 3.0], rtol=1e-8)


def _block_coo(dense, nblk, b):
    rows, cols, blocks = [], [], []
    for i in range(nblk):
        for j in range(nblk):
            blk = dense[i * b:(i + 1) * b, j * b:(j + 1) * b]
            if np.any(blk != 0):
                rows.append(i)
                cols.append(j)
                blocks.append(blk)
    return np.stack(blocks), np.array(rows), np.array(cols)


def _tridiag(nblk, b, seed=0):
    rng = np.random.default_rng(seed)
    A = np.zeros((nblk * b, nblk * b))
    for i in range(nblk):
        d = rng.standard_normal((b, b))
        A[i * b:(i + 1) * b, i * b:(i + 1) * b] = d @ d.T + (4 + b) * np.eye(b)
        if i + 1 < nblk:
            o = 0.5 * rng.standard_normal((b, b))
            A[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = o
            A[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = o.T
    return A


def _grid(nx=5, ny=5, b=3, seed=2):
    rng = np.random.default_rng(seed)
    nblk = nx * ny
    A = np.zeros((nblk * b, nblk * b))
    for i in range(nx):
        for j in range(ny):
            k = i * ny + j
            d = rng.standard_normal((b, b))
            A[k * b:(k + 1) * b, k * b:(k + 1) * b] = d @ d.T + 8 * np.eye(b)
            for (i2, j2) in ((i + 1, j), (i, j + 1)):
                if i2 < nx and j2 < ny:
                    k2 = i2 * ny + j2
                    o = 0.6 * rng.standard_normal((b, b))
                    A[k * b:(k + 1) * b, k2 * b:(k2 + 1) * b] = o
                    A[k2 * b:(k2 + 1) * b, k * b:(k + 1) * b] = o.T
    return A, nblk, b


def _star(nblk=6, b=2, seed=3):
    rng = np.random.default_rng(seed)
    S = np.zeros((nblk * b, nblk * b))
    hub = nblk - 1
    for i in range(nblk):
        d = rng.standard_normal((b, b))
        S[i * b:(i + 1) * b, i * b:(i + 1) * b] = d @ d.T + 6 * np.eye(b)
    for i in range(hub):
        o = 0.3 * rng.standard_normal((b, b))
        S[hub * b:(hub + 1) * b, i * b:(i + 1) * b] = o
        S[i * b:(i + 1) * b, hub * b:(hub + 1) * b] = o.T
    return S, nblk, b


MATRICES = {"tridiagonal": lambda: (_tridiag(12, 4), 12, 4), "grid": _grid,
            "star": _star}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_block_ilu(name):
    A, nblk, b = MATRICES[name]()
    coo = _block_coo(A, nblk, b)
    Mj, Mt = jilu(*coo, nblk), block_ilu0(*coo, nblk, device="cpu")
    assert len(Mt.low) == len(Mj.low) and len(Mt.up) == len(Mj.up)
    for tl, (rows, cols, blks) in zip(Mt.low + Mt.up, Mj.low + Mj.up):
        assert np.array_equal(tl.rows.numpy(), np.asarray(rows))
        assert np.array_equal(tl.cols.numpy(), np.asarray(cols))
        assert np.array_equal(tl.blocks.numpy(), np.asarray(blks))
    r = np.random.default_rng(1).standard_normal(nblk * b)
    close(Mt.apply(torch.as_tensor(r)), Mj.apply(jnp.asarray(r)), 1e-12)
    rhs = np.random.default_rng(4).standard_normal(nblk * b)
    xj, ij = jsolvers.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(rhs), M=Mj.apply,
                         rel_tol=1e-10, max_iter=500)
    xt, it = tsolvers.cg(lambda v: torch.as_tensor(A) @ v, torch.as_tensor(rhs),
                         M=Mt.apply, rel_tol=1e-10, max_iter=500)
    assert it.iterations == int(ij.iterations) and it.converged
    close(xt, xj, 1e-10)
