"""The port's fractional Laplacian, white noise and Matérn sampler against
the JAX package, float64 on the CPU:

* ``linalg/fractional.py``: ``sinc_weights`` array for array;
  ``fractional_apply`` on JAX's pencil eigenvector (5×5, order 1) and
  ``fractional_solve`` on its first-mode problem (8×8, order 2): u within
  1e-10 relative and every shifted solve with JAX's CG count (JAX's shift
  solve jitted once with the shift traced, since its ``lax.scan`` drops
  the counts);
* ``ops/linearform.white_noise_lf`` with JAX's own draws passed in (the
  ``jax.random`` stream has no torch counterpart), order 1 and 2: to
  1e-10;
* ``models/spde.sample_matern_field`` with JAX's draws, the integer (ν = 1)
  and fractional (ν = 0.5) exponents: to 1e-10."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.linalg import fractional as jfrac
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.models import spde as jspde
from cardiac_ablation_ecm2_tpu.ops import BilinearForm as JBilinearForm
from cardiac_ablation_ecm2_tpu.ops.linearform import domain_lf as jdomain_lf
from cardiac_ablation_ecm2_tpu.ops.linearform import white_noise_lf as jwhite
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import fractional as tfrac
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d
from cardiac_ablation_ecm2_tpu_torch.models import spde as tspde
from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf, white_noise_lf

RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL):
    a, b = a.numpy(), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= rtol, err


def _pencils(n, p):
    """JAX's masked (A, M) pencil of −Δ on the n×n square, both packages."""
    out = []
    for fes, form, arr in ((JFESpace(jquad(n, n), p), JBilinearForm, jnp.asarray),
                           (FESpace(make_cartesian_2d(n, n), p),
                            lambda f: BilinearForm(f, "cpu"), torch.as_tensor)):
        A = form(fes).add_domain_integrator("diffusion").assemble()
        M = form(fes).add_domain_integrator("mass").assemble()
        m = np.ones(fes.ndof_scalar)
        m[fes.essential_dofs()] = 0.0
        m = arr(m)
        out.append((fes, lambda v, A=A, m=m: A.mult(v * m) * m + v * (1 - m),
                    lambda v, M=M, m=m: M.mult(v * m) * m + v * (1 - m),
                    A.diagonal() * m + (1 - m), M.diagonal() * m + (1 - m), m))
    return out


def jax_shift_counts(Am, Mm, dA, dM, v, s, lam_min, lam_max, k, rel_tol=1e-11,
                     max_iter=3000):
    @jax.jit
    def count(t, Mv):
        d = t * dM + dA
        _, info = jsolvers.cg(lambda z: t * Mm(z) + Am(z), Mv, M=lambda r: r / d,
                              rel_tol=rel_tol, max_iter=max_iter)
        return info.iterations

    ts, _ = jfrac.sinc_weights(s, lam_min, lam_max, k)
    Mv = Mm(v)
    return [int(count(t, Mv)) for t in ts]


def test_sinc_weights():
    for args in ((0.5, 1.0, 1e6), (0.25, 2.0, 1e3, 0.45)):
        for a, b in zip(tfrac.sinc_weights(*args), jfrac.sinc_weights(*args)):
            assert np.array_equal(a, b)


def test_fractional_apply_eigenvector():
    (jfes, jA, jM, jdA, jdM, _), (tfes, tA, tM, tdA, tdM, _) = _pencils(5, 1)
    n = tfes.ndof_scalar
    I = np.eye(n)
    Ad = np.stack([tA(torch.as_tensor(I[:, j])).numpy() for j in range(n)], axis=1)
    Md = np.stack([tM(torch.as_tensor(I[:, j])).numpy() for j in range(n)], axis=1)
    from scipy.linalg import eigh
    lam, V = eigh(Ad, Md)
    x = V[:, np.argsort(np.abs(lam - 1.0))[-1]]
    kw = dict(lam_min=lam.min(), lam_max=lam.max(), k=0.22)
    yj = jfrac.fractional_apply(jA, jM, jdA, jdM, 0.5, jnp.asarray(x), **kw)
    yt = tfrac.fractional_apply(tA, tM, tdA, tdM, 0.5, torch.as_tensor(x), **kw)
    close(yt, yj)
    assert tfrac.fractional_apply.cg_iterations == jax_shift_counts(
        jA, jM, jdA, jdM, jnp.asarray(x), 0.5, **kw)


def test_fractional_solve_first_mode():
    (jfes, jA, jM, jdA, jdM, jm), (tfes, tA, tM, tdA, tdM, tm) = _pencils(8, 2)
    f = lambda x: np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])
    bj = jdomain_lf(jfes, lambda x: f(np.asarray(x))) * jm
    bt = domain_lf(tfes, lambda x: torch.as_tensor(f(x.numpy())), device="cpu") * tm
    kw = dict(lam_min=2 * np.pi ** 2 / 4, lam_max=1e5, k=0.45)
    uj = jfrac.fractional_solve(jA, jM, jdA, jdM, 0.5, bj, **kw)
    ut = tfrac.fractional_solve(tA, tM, tdA, tdM, 0.5, bt, **kw)
    close(ut, uj)
    vj, _ = jsolvers.cg(jM, bj, M=lambda r: r / jdM, rel_tol=1e-11, max_iter=3000)
    assert tfrac.fractional_apply.cg_iterations == jax_shift_counts(
        jA, jM, jdA, jdM, vj, 0.5, **kw)


def _draws(fes, seed, num):
    return jax.random.normal(jax.random.PRNGKey(seed),
                             (fes.mesh.ne, fes.gather_map.shape[1], num or 1),
                             dtype=jnp.float64)


@pytest.mark.parametrize("order,num", [(1, None), (2, 3)])
def test_white_noise(order, num):
    jf, tf = JFESpace(jquad(6, 6), order), FESpace(make_cartesian_2d(6, 6), order)
    w = _draws(jf, 5, num)
    close(white_noise_lf(tf, torch.as_tensor(np.asarray(w)), num=num, device="cpu"),
          jwhite(jf, 5, num=num))


@pytest.mark.parametrize("nu,num", [(1.0, 2), (0.5, None)])
def test_matern(nu, num):
    jf, tf = JFESpace(jquad(8, 8), 1), FESpace(make_cartesian_2d(8, 8), 1)
    w = torch.as_tensor(np.asarray(_draws(jf, 3, num)))
    uj = jspde.sample_matern_field(jf, 3, nu=nu, ell=0.15, num=num)
    ut = tspde.sample_matern_field(tf, w, nu=nu, ell=0.15, num=num, device="cpu")
    close(ut, uj)
