"""The port's differentiable restriction, Newton, L-BFGS and the ODE2 family
against the JAX package, float64 on the CPU:

* the restriction's autograd Functions (``fem/restriction.py``: L→E
  element-major and transposed, E→L from either layout, the vector forms)
  pass ``gradcheck`` (reverse and forward mode) and ``gradgradcheck``
  (double backward and forward-over-reverse), and the jvp of a gradient
  through them equals the same computation through plain index ops;
* ``newton`` on an algebraic system and on nonlinear diffusion through the
  PA pipeline (JAX's ``test_newton_nonlinear_diffusion``): equal Newton
  iterations and equal CG counts in every step (JAX's loop written out
  below, held to ``linalg.newton.newton`` itself), u to 1e-10;
* ``lbfgs`` on JAX's quadratic and Rosenbrock problems: equal iterations,
  u to 1e-10;
* ``NewmarkSolver``, ``GeneralizedAlpha2Solver`` (ρ∞, HHT, WBZ) and
  ``SIASolver`` orders 1, 2, 4 on the oscillator of JAX's tests, to
  1e-13."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.fem.build import basis_for as jbasis_for
from cardiac_ablation_ecm2_tpu.fem.build import geom_factors_for as jgf_for
from cardiac_ablation_ecm2_tpu.fem.build import restriction_for as jrestr_for
from cardiac_ablation_ecm2_tpu.fem.quadinterp import eval_values as jeval_values
from cardiac_ablation_ecm2_tpu.linalg.newton import lbfgs as jlbfgs
from cardiac_ablation_ecm2_tpu.linalg.newton import newton as jnewton_fn
from cardiac_ablation_ecm2_tpu.linalg import ode2 as jode2
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.ops import diffusion as jdmod
from cardiac_ablation_ecm2_tpu.ops.linearform import domain_lf as jdomain_lf
from cardiac_ablation_ecm2_tpu_torch.fem.build import basis_for, geom_factors_for, restriction_for
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.fem.quadinterp import eval_values
from cardiac_ablation_ecm2_tpu_torch.fem.restriction import ElementRestriction
from cardiac_ablation_ecm2_tpu_torch.linalg import newton as tnewton
from cardiac_ablation_ecm2_tpu_torch.linalg import ode2 as tode2
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d
from cardiac_ablation_ecm2_tpu_torch.ops import diffusion as tdmod
from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf

RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL):
    a = a.detach().double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


_JAX_STEPS = {}


def _jax_step(residual, linear_rel_tol, linear_max_iter, precond, line_search,
              linear_solver):
    """One jitted Newton step of ``jax_newton``, built once per residual and
    settings, so that a continuation (the residual's extra arguments
    traced) compiles it once."""
    key = (residual, linear_rel_tol, linear_max_iter, precond, line_search,
           linear_solver)
    if key in _JAX_STEPS:
        return _JAX_STEPS[key]
    dot = jsolvers.default_dot
    norm = lambda v: jnp.sqrt(dot(v, v))

    @jax.jit
    def step(u, F, nF, args):
        res = lambda w: residual(w, *args)
        _, jvp = jax.linearize(res, u)
        M = precond(u) if precond is not None else None
        solve = jsolvers.cg if linear_solver == "cg" else jsolvers.gmres
        du, info = solve(jvp, -F, M=M, rel_tol=linear_rel_tol,
                         max_iter=linear_max_iter)
        if line_search > 0:
            def ls_body(i, carry):
                alpha, best_u, best_n = carry
                u_try = u + alpha * du
                n_try = norm(res(u_try))
                better = n_try < best_n
                return (alpha * 0.5, jnp.where(better, u_try, best_u),
                        jnp.where(better, n_try, best_n))

            _, u_new, n_new = jax.lax.fori_loop(
                0, line_search + 1, ls_body, (jnp.ones_like(nF), u, nF))
        else:
            u_new = u + du
            n_new = norm(res(u_new))
        return u_new, res(u_new), n_new, info.iterations

    _JAX_STEPS[key] = step
    return step


def jax_newton(residual, u0, rel_tol=1e-10, max_iter=20, linear_rel_tol=1e-8,
               linear_max_iter=500, precond=None, line_search=0,
               linear_solver="cg", args=()):
    """``linalg.newton.newton`` of the JAX package as a Python loop, so that
    the CG count of every step is visible (its ``lax.while_loop`` drops
    them); the tangent is ``jax.linearize`` as there.  The residual is
    ``residual(u, *args)``."""
    dot = jsolvers.default_dot
    step = _jax_step(residual, linear_rel_tol, linear_max_iter, precond,
                     line_search, linear_solver)
    F = residual(u0, *args)
    nF = jnp.sqrt(dot(F, F))
    target = rel_tol * nF
    u, k, its = u0, 0, []
    while k < max_iter and not bool(nF <= target):
        u, F, nF, it = step(u, F, nF, args)
        its.append(int(it))
        k += 1
    return u, k, its


# ---------------------------------------------------------------------------
# the restriction's derivatives
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def restr():
    rng = np.random.default_rng(0)
    ndof, ne, nd = 40, 9, 8
    gm = rng.integers(0, ndof, (ne, nd))
    gm[0] = np.arange(nd)
    gm[1, :3] = 39                      # a dof of multiplicity > 1 in one element
    return ElementRestriction(gm, ndof, "cpu"), gm


@pytest.mark.parametrize("op", ["mult", "mult_t", "mult_transpose",
                                "mult_transpose_t", "mult_vec",
                                "mult_transpose_vec"])
def test_restriction_gradcheck(restr, op):
    r, _ = restr
    gen = torch.Generator().manual_seed(1)
    shape = {"mult": (r.ndof,), "mult_t": (r.ndof,), "mult_transpose": (r.ne, r.nd),
             "mult_transpose_t": (r.nd, r.ne), "mult_vec": (3 * r.ndof,),
             "mult_transpose_vec": (r.ne, r.nd, 3)}[op]
    x = torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
    f = (lambda v: r.mult_vec(v, 3)) if op == "mult_vec" else getattr(r, op)
    assert torch.autograd.gradcheck(f, (x,), check_forward_ad=True)
    assert torch.autograd.gradgradcheck(f, (x,), check_fwd_over_rev=True)


def test_restriction_jvp_of_grad_equals_index_ops(restr):
    """Forward-over-reverse (Newton's tangent apply) through the Functions
    against the same energy through ``index_select`` / ``index_add``."""
    r, gm = restr
    g = torch.as_tensor(gm)

    def energy(mult, mult_transpose):
        def E(v):
            e = mult(v)
            return (e ** 3).sum() + (mult_transpose(e * e) ** 2).sum()
        return E

    E_fn = energy(r.mult, r.mult_transpose)
    E_plain = energy(lambda v: v[g],
                     lambda e: torch.zeros(r.ndof, dtype=e.dtype).index_add(
                         0, g.reshape(-1), e.reshape(-1)))
    E_t = energy(lambda v: r.mult_t(v).T, lambda e: r.mult_transpose_t(e.T.contiguous()))
    gen = torch.Generator().manual_seed(2)
    x, t = (torch.randn(r.ndof, generator=gen, dtype=torch.float64) for _ in range(2))
    ref = torch.func.jvp(torch.func.grad(E_plain), (x,), (t,))
    for E in (E_fn, E_t):
        got = torch.func.jvp(torch.func.grad(E), (x,), (t,))
        for a, b in zip(got, ref):
            close(a, b, 1e-13)


# ---------------------------------------------------------------------------
# Newton
# ---------------------------------------------------------------------------

def test_newton_algebraic():
    A = np.diag([1.0, 2.0, 3.0])
    rhs = np.array([1.0, 2.0, 3.0])
    uj, ij = jnewton_fn(lambda x: jnp.asarray(A) @ x + 0.1 * x ** 3 - rhs,
                            jnp.zeros(3), rel_tol=1e-12)
    At, rt = torch.as_tensor(A), torch.as_tensor(rhs)
    ut, it = tnewton.newton(lambda x: At @ x + 0.1 * x ** 3 - rt,
                            torch.zeros(3, dtype=torch.float64), rel_tol=1e-12)
    assert it.converged and it.iterations == int(ij.iterations)
    close(ut, uj)


def _nonlinear_diffusion(n=8):
    """JAX's −∇·((1+u²)∇u) = f on the unit square, u* = sin πx sin πy."""
    def f_rhs(x):
        s, c, pi = np.sin, np.cos, np.pi
        u = s(pi * x[..., 0]) * s(pi * x[..., 1])
        gx = pi * c(pi * x[..., 0]) * s(pi * x[..., 1])
        gy = pi * s(pi * x[..., 0]) * c(pi * x[..., 1])
        return -((1 + u ** 2) * (-2 * pi ** 2 * u) + 2 * u * (gx ** 2 + gy ** 2))

    jf = JFESpace(jquad(n, n), 2)
    jr, jdb, jgf = jrestr_for(jf), jbasis_for(jf), jgf_for(jf)
    jess = jnp.asarray(jf.essential_dofs())
    jb = jdomain_lf(jf, lambda x: f_rhs(np.asarray(x)))

    def jres(u):
        uz = u.at[jess].set(0.0)
        qd = jdmod.setup(jgf, 1.0 + jeval_values(jdb, jr.mult(uz)) ** 2)
        r = jr.mult_transpose(jdmod.apply(jdb, qd, jr.mult(uz))) - jb
        return r.at[jess].set(u[jess])

    tf = FESpace(make_cartesian_2d(n, n), 2)
    tr, tdb, tgf = (restriction_for(tf, "cpu"), basis_for(tf, device="cpu"),
                    geom_factors_for(tf, device="cpu"))
    tess = torch.as_tensor(tf.essential_dofs())
    tb = domain_lf(tf, lambda x: torch.as_tensor(f_rhs(x.numpy())), device="cpu")

    def tres(u):
        uz = u.clone()
        uz[tess] = 0.0
        qd = tdmod.setup(tgf, 1.0 + eval_values(tdb, tr.mult(uz)) ** 2)
        r = tr.mult_transpose(tdmod.apply(tdb, qd, tr.mult(uz))) - tb
        r = r.clone()
        r[tess] = u[tess]
        return r

    return jres, tres, jf.ndof


def test_newton_nonlinear_diffusion():
    jres, tres, n = _nonlinear_diffusion()
    kw = dict(rel_tol=1e-11, linear_rel_tol=1e-10, linear_max_iter=800)
    uj, ij = jnewton_fn(jres, jnp.zeros(n), **kw)
    uw, kw_it, its = jax_newton(jres, jnp.zeros(n), **kw)
    assert kw_it == int(ij.iterations)
    close(np.asarray(uw), np.asarray(uj), 1e-12)
    ut, it = tnewton.newton(tres, torch.zeros(n, dtype=torch.float64), **kw)
    assert it.converged and it.iterations == kw_it, (it, kw_it)
    assert list(it.linear_iterations) == its
    close(ut, uj)


# ---------------------------------------------------------------------------
# L-BFGS
# ---------------------------------------------------------------------------

def test_lbfgs_quadratic():
    rng = np.random.default_rng(0)
    A = rng.random((12, 12))
    A = A @ A.T + 12 * np.eye(12)
    b = rng.random(12)
    uj, ij = jlbfgs(lambda u: jnp.asarray(A) @ u - b, jnp.zeros(12),
                           rel_tol=1e-10, max_iter=100)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    ut, it = tnewton.lbfgs(lambda u: At @ u - bt, torch.zeros(12, dtype=torch.float64),
                           rel_tol=1e-10, max_iter=100)
    assert it.converged and it.iterations == int(ij.iterations)
    close(ut, uj)


def test_lbfgs_rosenbrock():
    def make(xp, stack):
        def f(u):
            x, y = u[0], u[1]
            return (1 - x) ** 2 + 100 * (y - x * x) ** 2

        def g(u):
            x, y = u[0], u[1]
            return stack([-2 * (1 - x) - 400 * x * (y - x * x), 200 * (y - x * x)])
        return f, g

    fj, gj = make(jnp, jnp.stack)
    ft, gt = make(torch, torch.stack)
    uj, ij = jlbfgs(gj, jnp.asarray([-1.2, 1.0]), rel_tol=1e-9,
                           max_iter=400, energy=fj)
    ut, it = tnewton.lbfgs(gt, torch.tensor([-1.2, 1.0], dtype=torch.float64),
                           rel_tol=1e-9, max_iter=400, energy=ft)
    assert it.iterations == int(ij.iterations) and it.converged == bool(ij.converged)
    close(ut, uj)
    assert np.abs(ut.numpy() - 1.0).max() < 1e-4


# ---------------------------------------------------------------------------
# ODE2
# ---------------------------------------------------------------------------

class _Oscillator:
    def __init__(self, omega):
        self.w2 = omega * omega

    def mult(self, t, u, v):
        return -self.w2 * u

    def implicit_solve(self, c0, c1, t, u, v):
        return -self.w2 * u / (1.0 + self.w2 * c0)

    def velocity(self, t, p):
        return p

    def force(self, t, q):
        return -q


@pytest.mark.parametrize("name,kw", [("newmark", {}), ("central_difference", {}),
                                     ("linear_acceleration", {}),
                                     ("generalized_alpha", dict(rho_inf=0.8)),
                                     ("hht", dict(alpha=0.3)), ("wbz", dict(alpha_m=0.1))])
def test_ode2_select2(name, kw):
    f = _Oscillator(3.0)
    out = []
    for mod, arr in ((jode2, jnp.asarray), (tode2, lambda x: torch.tensor(x, dtype=torch.float64))):
        s = mod.select2(name, **kw)
        u, v, t = arr(1.0), arr(0.0), 0.0
        if isinstance(s, mod.GeneralizedAlpha2Solver):
            a = s.init(f, u, v, t)
            for _ in range(25):
                u, v, a, t = s.step(f, u, v, a, t, 0.03)
        else:
            for _ in range(25):
                u, v, t = s.step(f, u, v, t, 0.03)
        out.append((float(u), float(v)))
    assert np.allclose(out[0], out[1], rtol=1e-13, atol=1e-15), out


@pytest.mark.parametrize("order", [1, 2, 4])
def test_sia(order):
    f = _Oscillator(1.0)
    out = []
    for mod, arr in ((jode2, jnp.asarray), (tode2, lambda x: torch.tensor(x, dtype=torch.float64))):
        q, p, t = arr(1.0), arr(0.0), 0.0
        for _ in range(200):
            q, p, t = mod.SIASolver(order).step(f, q, p, t, 0.05)
        out.append((float(q), float(p)))
    assert np.allclose(out[0], out[1], rtol=1e-13, atol=1e-15), out
