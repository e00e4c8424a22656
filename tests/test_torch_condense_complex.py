"""The port's static condensation (``ops/condense``) and complex forms
(``ops/complex_fem``, ex22 problem 0 on H1) against the JAX package,
float64 on the CPU.

Tolerances: element matrices, the condensed apply, diagonal, reduced RHS
and recovery within 1e-12 of JAX's largest entry (1e-15 apart, measured);
the condensed Poisson solve within 1e-8·max|u| of the uncondensed one and
within 1e-10 of JAX's condensed solve with its CG count; the ex22 solves
within 1e-10 with JAX's GMRES counts.
"""

import functools

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg, gmres
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.ops import complex_fem as tcf
from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
from cardiac_ablation_ecm2_tpu_torch.ops.condense import StaticCondensation, element_matrices
from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf
from cardiac_ablation_ecm2_tpu_torch.ops.operators import LinearOperator


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = dict(device="cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


@functools.lru_cache(maxsize=None)
def _h1(kind, p):
    from cardiac_ablation_ecm2_tpu import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace

    make = {"quad4": lambda m: m.make_cartesian_2d(4, 4),
            "hex3": lambda m: m.make_cartesian_3d(3, 3, 3)}[kind]
    return JFESpace(make(jmesh), p), FESpace(make(tmesh), p)


# ----------------------------------------------------------------------------
# static condensation
# ----------------------------------------------------------------------------


def test_condensed_operator_parts():
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.ops import condense as jc

    js, ts = _h1("quad4", 4)
    ja = jc.element_matrices(js, diffusion_coeff=2.0, mass_coeff=0.7)
    ta = element_matrices(ts, diffusion_coeff=2.0, mass_coeff=0.7, **CPU)
    assert _rel(ja, ta) <= 1e-12
    jsc, tsc = jc.StaticCondensation(js, ja), StaticCondensation(ts, ta)
    assert tsc.n_iface == jsc.n_iface and np.array_equal(tsc.iface_dofs, jsc.iface_dofs)
    assert np.array_equal(tsc.essential_dofs(None), jsc.essential_dofs(None))
    rng = np.random.default_rng(0)
    x, b = rng.random(jsc.n_iface), rng.random(js.ndof)
    X, Bt = torch.as_tensor(x), torch.as_tensor(b)
    assert _rel(jsc.mult(jnp.asarray(x)), tsc.mult(X)) <= 1e-12
    assert _rel(jsc.diagonal(), tsc.diagonal()) <= 1e-12
    assert _rel(jsc.reduce_rhs(jnp.asarray(b)), tsc.reduce_rhs(Bt)) <= 1e-12
    assert _rel(jsc.recover(jnp.asarray(x), jnp.asarray(b)), tsc.recover(X, Bt)) <= 1e-12


def _masked(op, n, ess):
    mask = torch.zeros(n, dtype=torch.float64)
    mask[torch.as_tensor(ess, dtype=torch.int64)] = 1.0
    return (lambda v: op(v * (1 - mask)) * (1 - mask) + v * mask), mask


def test_condensed_poisson_matches_full_and_jax():
    """Order-3 Poisson on 3³ hexes: the condensed solve recovers the
    uncondensed PA solve, and equals JAX's condensed solve with its CG
    count (the JAX test's problem)."""
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.linalg.solvers import cg as jcg
    from cardiac_ablation_ecm2_tpu.ops import condense as jc
    from cardiac_ablation_ecm2_tpu.ops.linearform import domain_lf as jlf

    js, ts = _h1("hex3", 3)
    b = domain_lf(ts, lambda x: torch.sin(x[..., 0]) + x[..., 1] * x[..., 2], **CPU)
    ess = ts.essential_dofs(None)
    A = BilinearForm(ts, **CPU).add_domain_integrator("diffusion").assemble()
    Aop, mask = _masked(A.mult, ts.ndof, ess)
    x_full, _ = cg(Aop, b * (1 - mask), rel_tol=1e-12, max_iter=3000)

    sc = StaticCondensation(ts, element_matrices(ts, diffusion_coeff=1.0, **CPU))
    assert sc.n_iface == ts.ndof - (ts.order - 1) ** 3 * ts.mesh.ne
    Sop, smask = _masked(sc.mult, sc.n_iface, sc.essential_dofs(None))
    dg = torch.where(smask > 0, 1.0, sc.diagonal())
    br = sc.reduce_rhs(b)
    xf, info = cg(Sop, br * (1 - smask), M=lambda r: r / dg, rel_tol=1e-12,
                  max_iter=3000)
    x_cond = sc.recover(xf, b)
    assert _rel(x_full, x_cond) <= 1e-8

    jsc = jc.StaticCondensation(js, jc.element_matrices(js, diffusion_coeff=1.0))
    jb = jlf(js, lambda x: np.sin(x[..., 0]) + x[..., 1] * x[..., 2])
    assert _rel(jb, b) <= 1e-12
    jm = jnp.asarray(smask.numpy())
    jdg = jnp.where(jm > 0, 1.0, jsc.diagonal())
    jxf, jinfo = jax.jit(lambda r: jcg(
        lambda v: jsc.mult(v * (1 - jm)) * (1 - jm) + v * jm, r * (1 - jm),
        M=lambda r: r / jdg, rel_tol=1e-12, max_iter=3000))(jsc.reduce_rhs(jb))
    assert info.iterations == int(jinfo.iterations)
    assert _rel(jsc.recover(jxf, jb), x_cond) <= 1e-10


# ----------------------------------------------------------------------------
# complex forms
# ----------------------------------------------------------------------------


def test_conventions_match_dense_complex():
    """Block mult reproduces (A_r + iA_i)x; BLOCK_SYMMETRIC the conjugate;
    a None part is zero."""
    rng = np.random.default_rng(3)
    n = 23
    Ar, Ai = rng.standard_normal((2, n, n))
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = (Ar + 1j * Ai) @ x
    mk = lambda M: LinearOperator((n, n), lambda v: torch.as_tensor(M) @ v,
                                  lambda: torch.as_tensor(np.diag(M).copy()))
    z = tcf.cstack(torch.as_tensor(x.real), torch.as_tensor(x.imag))
    for conv, ref in ((tcf.HERMITIAN, want), (tcf.BLOCK_SYMMETRIC, np.conj(want))):
        y = tcf.ComplexOperator(mk(Ar), mk(Ai), n, convention=conv).mult(z).numpy()
        assert np.allclose(y[:n] + 1j * y[n:], ref, atol=1e-12)
    y0 = tcf.ComplexOperator(None, mk(Ai), n).mult(z).numpy()
    assert np.allclose(y0[:n] + 1j * y0[n:], (1j * Ai) @ x, atol=1e-12)
    with pytest.raises(ValueError):
        tcf.ComplexOperator(None, None, n, convention="other")


OMEGA, SIGMA, AMP = 2.0, 1.0, 1.0 + 0.5j


def _ex22(fes, cf, lf, solver, conv, mod, kw):
    """ex22 problem 0: (∇u,∇v) − ω²(u,v) + iωσ(u,v) = (f,v), u = 0 on ∂Ω,
    u = (1 + 0.5i)·sin(πx)sin(πy), Jacobi-GMRES."""
    lam = 2 * np.pi ** 2 - OMEGA ** 2 + 1j * OMEGA * SIGMA
    s = lambda x: mod.sin(np.pi * x[..., 0]) * mod.sin(np.pi * x[..., 1])
    sq = cf.SesquilinearForm(fes, convention=conv, **kw)
    sq.add_domain_integrator("diffusion", 1.0, None)
    sq.add_domain_integrator("mass", -OMEGA ** 2, OMEGA * SIGMA)
    A = sq.assemble()
    n = fes.ndof
    b = cf.cstack(lf(fes, lambda x: (lam * AMP).real * s(x), **kw),
                  lf(fes, lambda x: (lam * AMP).imag * s(x), **kw))
    if conv == cf.BLOCK_SYMMETRIC:
        b = cf.cstack(b[:n], -b[n:])
    ess = fes.essential_dofs([1, 2, 3, 4])
    z0 = 0 * b
    Ac, B = cf.form_complex_linear_system(A, ess, z0, b)
    mask = np.zeros(n)
    mask[ess] = 1.0
    M = cf.complex_jacobi(A, ess_mask=torch.as_tensor(mask) if kw else mask)
    z, info = solver(Ac.mult, B, M=M, rel_tol=1e-12, max_iter=2000, restart=200)
    u = cf.ComplexGridFunction.from_vec(fes, z)
    err = u.l2_error(lambda x: AMP.real * s(x), lambda x: AMP.imag * s(x))
    return err, int(info.iterations), np.asarray(z)


def test_ex22_h1_damped():
    """The Hermitian convention at 4² quads, order 2, against JAX: equal
    GMRES counts, the same solution and error; the block-symmetric one
    gives the same error; the port's L2 rate from 4² to 8² > 2.6 (JAX's
    test's bound)."""
    from cardiac_ablation_ecm2_tpu import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.linalg.solvers import gmres as jgmres
    from cardiac_ablation_ecm2_tpu.ops import complex_fem as jcf
    from cardiac_ablation_ecm2_tpu.ops.linearform import domain_lf as jlf

    errs = {}
    for n, conv in ((4, tcf.HERMITIAN), (4, tcf.BLOCK_SYMMETRIC), (8, tcf.HERMITIAN)):
        et, it, zt = _ex22(FESpace(tmesh.make_cartesian_2d(n, n), 2), tcf, domain_lf,
                           gmres, conv, torch, CPU)
        errs[(n, conv)] = et
        if n == 4 and conv == tcf.HERMITIAN:
            ej, ij, zj = _ex22(JFESpace(jmesh.make_cartesian_2d(n, n), 2), jcf, jlf,
                               jgmres, conv, np, {})
            assert it == ij and _rel(zj, zt) <= 1e-10 and abs(ej - et) <= 1e-10 * ej
    assert np.log2(errs[(4, tcf.HERMITIAN)] / errs[(8, tcf.HERMITIAN)]) > 2.6
    h, s = errs[(4, tcf.HERMITIAN)], errs[(4, tcf.BLOCK_SYMMETRIC)]
    assert abs(h - s) < 1e-9 * h
    # the complex grid function's own helpers
    fes = FESpace(tmesh.make_cartesian_2d(4, 4), 2)
    g = tcf.ComplexGridFunction.project(fes, lambda x: x[..., 0], lambda x: x[..., 1],
                                        device="cpu")
    assert torch.equal(tcf.ComplexGridFunction.from_vec(fes, g.vec()).im, g.im)
    assert g.l2_error(lambda x: x[..., 0], lambda x: x[..., 1]) < 1e-12
    assert float(tcf.ComplexGridFunction.zero(fes, device="cpu").vec().abs().max()) == 0.0
