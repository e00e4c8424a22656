"""The port's Poisson slice (``linalg/solvers.power_method``,
``linalg/smoothers.chebyshev``, ``ops/linearform``, ``models/poisson``)
and its ``entry()`` against the JAX package, float64 on the CPU,
quad_extra 0 in both packages.

Tolerances: ``power_method`` from a shared start to 1e-12 relative;
``chebyshev`` from a shared start to 1e-12·max|y|, and PCG with a
shared ``eig_max`` below the spectrum's top to equal CG counts and
1e-12·max|u|; ``domain_lf`` and
``domain_lf_from_qvec`` to 1e-13·max|b|; ``poisson.solve`` with
``"jacobi"`` and ``None`` (no random start) to 1e-10·max|u| with equal CG
counts; with ``"chebyshev"`` and ``"lor"`` at rel_tol 1e-10 to
1e-8·max|u| with counts within ±2, since their eigenvalue estimates start
from random vectors that the two packages draw differently.  ``entry()``
against ``__graft_entry__.entry()``: θ = T − 37 to 1e-10·max|θ| in float64;
in float32, where T ≈ 37 carries an ulp of 3.8e-6 and the two packages'
contractions round differently, T to 1e-6·max|T| (ten ulps)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jentry
from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.linalg import smoothers as jsmoothers
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.mesh.mesh import make_cartesian_3d as jcart
from cardiac_ablation_ecm2_tpu.models import poisson as jpoisson
from cardiac_ablation_ecm2_tpu.ops import bilinearform as jbf
from cardiac_ablation_ecm2_tpu.ops import linearform as jlf
from cardiac_ablation_ecm2_tpu.ops.operators import form_linear_system as jform
from cardiac_ablation_ecm2_tpu.utils.config import config as jcfg
from cardiac_ablation_ecm2_tpu.utils.config import configure as jconfigure
from cardiac_ablation_ecm2_tpu_torch.entry import entry
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import smoothers, solvers
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
from cardiac_ablation_ecm2_tpu_torch.models import poisson
from cardiac_ablation_ecm2_tpu_torch.ops import bilinearform as tbf
from cardiac_ablation_ecm2_tpu_torch.ops import linearform as tlf
from cardiac_ablation_ecm2_tpu_torch.ops.operators import form_linear_system
from cardiac_ablation_ecm2_tpu_torch.utils.config import config as tcfg
from cardiac_ablation_ecm2_tpu_torch.utils.config import configure as tconfigure
from torch_threads import beside


def kappa(x):
    """A variable conductivity, written for jnp and torch alike."""
    return 1.0 + x[..., 0] + 0.5 * x[..., 1]


def rhs(x):
    return 1.0 + x[..., 0] * x[..., 1] - x[..., 2]


def bc(x):
    return x[..., 0] + 2.0 * x[..., 2]


@pytest.fixture(autouse=True)
def _config():
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


def close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


def _systems(n=3, order=2, ess_bdr=(1, 2, 5)):
    """The constrained diffusion system (κ variable) of both packages on
    the n³ unit cube: (A_c, diag) for JAX and for the port, and ndof."""
    jf, tf = JFESpace(jcart(n, n, n), order), FESpace(make_cartesian_3d(n, n, n), order)
    jA = jbf.BilinearForm(jf).add_domain_integrator("diffusion", kappa).assemble()
    tA = tbf.BilinearForm(tf, "cpu").add_domain_integrator(
        "diffusion", kappa).assemble("float64")
    ess = jf.essential_dofs(list(ess_bdr))
    jAc, _ = jform(jA.operator(), ess, jnp.zeros(jf.ndof), jnp.zeros(jf.ndof))
    tAc, _ = form_linear_system(tA.operator(), ess, torch.zeros(tf.ndof, dtype=torch.float64),
                                torch.zeros(tf.ndof, dtype=torch.float64))
    return (jAc, jAc.diagonal()), (tAc, tAc.diagonal()), tf.ndof


def test_power_method_shared_start():
    """D⁻¹A of the constrained operator from JAX's own start vector
    (``jax.random.uniform(PRNGKey(7))``); without ``v0`` the port starts
    from the seeded CPU generator's uniform draw."""
    (jAc, jd), (tAc, td), n = _systems()
    v0 = np.array(jax.random.uniform(jax.random.PRNGKey(7), (n,), jnp.float64))
    jl = jsolvers.power_method(lambda v: jAc.mult(v) / jd, iters=20, v0=jnp.asarray(v0))
    tl = solvers.power_method(lambda v: tAc.mult(v) / td, iters=20,
                              v0=torch.as_tensor(v0))
    close(float(tl), float(jl), 1e-12)
    seeded = solvers.power_method(lambda v: tAc.mult(v) / td, n, iters=20,
                                  dtype=torch.float64, device="cpu")
    start = torch.rand(n, generator=torch.Generator().manual_seed(7),
                       dtype=torch.float64)
    assert float(seeded) == float(solvers.power_method(
        lambda v: tAc.mult(v) / td, iters=20, v0=start))


@pytest.mark.parametrize("order", [3, 4])
def test_chebyshev_shared_start(order):
    (jAc, jd), (tAc, td), n = _systems()
    rng = np.random.default_rng(3)
    v0, r = rng.random(n), rng.standard_normal(n)
    jy = jsmoothers.chebyshev(jAc.mult, jd, order=order, v0=jnp.asarray(v0))(jnp.asarray(r))
    ty = smoothers.chebyshev(tAc.mult, td, order=order,
                             v0=torch.as_tensor(v0))(torch.as_tensor(r))
    close(ty, jy, 1e-12)


def test_chebyshev_low_bound_stops_alike():
    """A shared ``eig_max`` below λ_max(D⁻¹A)/(1.1 + 1/30), as a short power
    run can give: the order-4 polynomial is negative at the top of the
    spectrum, so the preconditioner is indefinite, and both packages' PCG
    stop at the same iteration on an (r, z) ≤ target that is negative,
    report converged and leave the same u, far from the solution."""
    (jAc, jd), (tAc, td), n = _systems()
    lam = float(solvers.power_method(lambda v: tAc.mult(v) / td, n, iters=500,
                                     dtype=torch.float64, device="cpu"))
    eig_max = 0.85 * lam
    b = np.random.default_rng(5).standard_normal(n)
    jx, jinfo = jsolvers.cg(jAc.mult, jnp.asarray(b), rel_tol=1e-10, max_iter=500,
                            M=jsmoothers.chebyshev(jAc.mult, jd, eig_max=eig_max))
    noms = []

    def dot(x, y):
        v = solvers.default_dot(x, y)
        noms.append(float(v))
        return v

    tb = torch.as_tensor(b)
    tx, tinfo = solvers.cg(tAc.mult, tb, rel_tol=1e-10, max_iter=500, dot=dot,
                           M=smoothers.chebyshev(tAc.mult, td, eig_max=eig_max))
    assert tinfo.iterations == int(jinfo.iterations)
    assert tinfo.converged and bool(jinfo.converged)
    assert noms[-1] < 0                          # the (r, z) CG stopped on
    close(tx, jx, 1e-12)
    assert float((tb - tAc.mult(tx)).norm()) > 0.1 * np.linalg.norm(b)


def test_domain_lf():
    jf, tf = JFESpace(jcart(3, 3, 2), 3), FESpace(make_cartesian_3d(3, 3, 2), 3)
    for coeff in (None, 2.5, rhs):
        close(tlf.domain_lf(tf, coeff, dtype="float64", device="cpu"),
              jlf.domain_lf(jf, coeff), 1e-13)
    nq = jf.dof_to_quad().weights.shape[0]
    fq = np.random.default_rng(4).standard_normal((jf.mesh.ne, nq))
    close(tlf.domain_lf_from_qvec(tf, torch.as_tensor(fq), dtype="float64",
                                  device="cpu"),
          jlf.domain_lf_from_qvec(jf, jnp.asarray(fq)), 1e-13)


CASE = dict(order=2, rhs=rhs, kappa=kappa, ess_bdr=[1, 2, 5], bc=bc)


@pytest.mark.parametrize("pre", ["jacobi", None])
def test_solve_matches_jax(pre):
    jr = jpoisson.solve(jcart(4, 4, 4), rel_tol=1e-11, preconditioner=pre, **CASE)
    tr = poisson.solve(make_cartesian_3d(4, 4, 4), rel_tol=1e-11, preconditioner=pre,
                       dtype="float64", device="cpu", **CASE)
    assert tr.converged and jr.converged
    assert tr.iterations == jr.iterations
    close(tr.u, jr.u, 1e-10)


@pytest.mark.parametrize("pre", ["chebyshev", "lor"])
def test_solve_random_start_matches_jax(pre):
    jr = jpoisson.solve(jcart(3, 3, 3), rel_tol=1e-10, preconditioner=pre, **CASE)
    tr = poisson.solve(make_cartesian_3d(3, 3, 3), rel_tol=1e-10, preconditioner=pre,
                       dtype="float64", device="cpu", **CASE)
    assert tr.converged and jr.converged
    assert abs(tr.iterations - jr.iterations) <= 2, (tr.iterations, jr.iterations)
    close(tr.u, jr.u, 1e-8)
    assert (tr.multigrid is not None) == (pre == "lor")
    if pre == "lor":
        assert tr.multigrid.cycles == tr.iterations + 1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_entry_matches_graft_entry(dtype):
    old = jcfg.dtype, tcfg.dtype
    jconfigure(dtype=dtype)
    tconfigure(dtype=dtype)
    try:
        jfn, jargs = jentry.entry()
        tfn, targs = entry(device="cpu")
        assert targs[0].dtype == torch.float32 and targs[0].shape == jargs[0].shape
        assert [float(a) for a in targs[1:]] == [float(a) for a in jargs[1:]]
        jax_run = beside(lambda: jfn(*jargs))
        tT, tt = tfn(*targs)
        jT, jt = jax_run.result()
    finally:
        jconfigure(dtype=old[0])
        tconfigure(dtype=old[1])
    assert tT.dtype == getattr(torch, dtype) and float(tt) == float(jt)
    if dtype == "float64":
        close(tT - 37.0, np.asarray(jT) - 37.0, 1e-10)
    else:
        close(tT, jT, 1e-6)
    assert float(tT.max()) > 37.0
