"""The port's mesh, geometry, linear forms, block operators, solvers and the
ex2 elasticity model against the JAX package, float64 on the CPU:

* ``make_cartesian_3d_tet`` array for array (its face-membership test is
  vectorised in the port);
* ``determinant`` / ``adjugate`` on square 2×2 and 3×3 and embedded 3×2
  and 2×1 Jacobians, to 1e-13 relative;
* every ported linear form (``domain_lf_vector``, ``vector_quadrature_lf``,
  ``boundary_lf``, ``boundary_lf_vector``, ``domain_lf_grad``,
  ``boundary_normal_lf``, ``vector_boundary_flux_lf`` on hexes and tets at
  order 2, ``boundary_tangential_lf`` on a 2D quad mesh) to 1e-10;
* ``BlockOperator`` and ``block_diag_precond``;
* ``gmres`` on a nonsymmetric convection–diffusion–Robin system (the PA
  operator of each package, Jacobi, restart 10, so the solve restarts):
  equal iterations and convergence, x to 1e-10 and the final residual norm
  to 1e-10 of the initial one; and on dense random systems, one of which
  runs out of its restart budget;
* ``cg`` with ``check_convergence=False``: exactly ``max_iter`` iterations,
  x to 1e-10;
* ``elasticity.solve`` on a small cantilever, x to 1e-10 with equal CG
  counts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.fem import geom_factors as jgfm
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_3d as jhex
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_3d_tet as jtet
from cardiac_ablation_ecm2_tpu.models import elasticity as jelasticity
from cardiac_ablation_ecm2_tpu.ops import block as jblock
from cardiac_ablation_ecm2_tpu.ops import bilinearform as jbf
from cardiac_ablation_ecm2_tpu.ops import linearform as jlf
from cardiac_ablation_ecm2_tpu_torch.fem import geom_factors as tgfm
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.fem.geometry import Geometry
from cardiac_ablation_ecm2_tpu_torch.linalg import solvers as tsolvers
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import Mesh
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d as thex
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d_tet as ttet
from cardiac_ablation_ecm2_tpu_torch.models import elasticity as telasticity
from cardiac_ablation_ecm2_tpu_torch.ops import block as tblock
from cardiac_ablation_ecm2_tpu_torch.ops import bilinearform as tbf
from cardiac_ablation_ecm2_tpu_torch.ops import linearform as tlf

RTOL = 1e-10
_MESH_FIELDS = ("vertices", "elements", "attributes", "boundary",
                "bdr_attributes")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 3, 4), (5, 4, 3, 2.0, 1.0, 0.5)])
def test_cartesian_tet_mesh_equals_jax(shape):
    jm, tm = jtet(*shape), ttet(*shape)
    for f in _MESH_FIELDS:
        a, b = getattr(jm, f), getattr(tm, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("s,d", [(2, 2), (3, 3), (3, 2), (2, 1)])
def test_determinant_adjugate_equal_jax(s, d):
    J = np.random.default_rng(s * 10 + d).standard_normal((4, 5, s, d))
    close(tgfm.determinant(torch.as_tensor(J)), jgfm.determinant(jnp.asarray(J)),
          1e-13)
    close(tgfm.adjugate(torch.as_tensor(J)), jgfm.adjugate(jnp.asarray(J)), 1e-13)
    if s == d:
        adj = tgfm.adjugate(torch.as_tensor(J)).numpy()
        det = tgfm.determinant(torch.as_tensor(J)).numpy()
        close(J @ adj, det[..., None, None] * np.eye(d), 1e-12)


def _vec(x):
    return 0.0 * x + x[..., [1, 2, 0]] + 0.25


def _jax_and_port(geom, vdim):
    jmake, tmake = (jhex, thex) if geom == "hex" else (jtet, ttet)
    return JFESpace(jmake(2, 2, 2), 2, vdim), FESpace(tmake(2, 2, 2), 2, vdim)


@pytest.mark.parametrize("geom", ["hex", "tet"])
def test_linear_forms_equal_jax(geom):
    jfes, tfes = _jax_and_port(geom, 1)
    jv, tv = _jax_and_port(geom, 3)
    kw = dict(dtype="float64")
    tk = dict(dtype="float64", device="cpu")
    marker = [2, 3]
    close(tlf.boundary_lf(tfes, lambda x: 1.0 + x[..., 0], marker, **tk),
          jlf.boundary_lf(jfes, lambda x: 1.0 + x[..., 0], marker, **kw))
    close(tlf.boundary_lf(tfes, None, **tk), jlf.boundary_lf(jfes, None, **kw))
    close(tlf.domain_lf_grad(tfes, _vec, **tk), jlf.domain_lf_grad(jfes, _vec, **kw))
    close(tlf.domain_lf_grad(tfes, [1.0, -2.0, 0.5], **tk),
          jlf.domain_lf_grad(jfes, [1.0, -2.0, 0.5], **kw))
    close(tlf.boundary_normal_lf(tfes, _vec, marker, **tk),
          jlf.boundary_normal_lf(jfes, _vec, marker, **kw))
    close(tlf.boundary_normal_lf(tfes, [0.0, 0.0, 1.0], **tk),
          jlf.boundary_normal_lf(jfes, [0.0, 0.0, 1.0], **kw))
    close(tlf.domain_lf_vector(tv, _vec, **tk), jlf.domain_lf_vector(jv, _vec, **kw))
    close(tlf.domain_lf_vector(tv, [0.0, 1.0, -1.0], **tk),
          jlf.domain_lf_vector(jv, [0.0, 1.0, -1.0], **kw))
    close(tlf.boundary_lf_vector(tv, [0.0, 0.0, -0.01], [3], **tk),
          jlf.boundary_lf_vector(jv, [0.0, 0.0, -0.01], [3], **kw))
    close(tlf.boundary_lf_vector(tv, _vec, **tk),
          jlf.boundary_lf_vector(jv, _vec, **kw))
    close(tlf.vector_boundary_flux_lf(tv, 2.5, marker, **tk),
          jlf.vector_boundary_flux_lf(jv, 2.5, marker, **kw))
    close(tlf.vector_boundary_flux_lf(tv, lambda x: x[..., 2], **tk),
          jlf.vector_boundary_flux_lf(jv, lambda x: x[..., 2], **kw))
    ne, nq = tfes.mesh.ne, tfes.d2q.weights.shape[0]
    fq = np.random.default_rng(5).standard_normal((ne, nq, 3))
    close(tlf.vector_quadrature_lf(tv, fq, **tk),
          jlf.vector_quadrature_lf(jv, jnp.asarray(fq), **kw))
    with pytest.raises(ValueError, match="only in 2D"):
        tlf.boundary_tangential_lf(tfes, [1.0, 0.0, 0.0], **tk)


@pytest.mark.parametrize("p", [1, 3])
def test_boundary_tangential_lf_equals_jax(p):
    jm = jquad(3, 2)
    tm = Mesh(Geometry.SQUARE, jm.vertices, jm.elements, jm.attributes,
              jm.boundary, jm.bdr_attributes)
    jfes, tfes = JFESpace(jm, p), FESpace(tm, p)
    assert np.array_equal(jfes.bdr_gather_map, tfes.bdr_gather_map)
    for vec, marker in (([1.0, 0.5], None), (lambda x: x[..., [1, 0]] * 2.0, [1, 2])):
        close(tlf.boundary_tangential_lf(tfes, vec, marker, dtype="float64",
                                         device="cpu"),
              jlf.boundary_tangential_lf(jfes, vec, marker, dtype="float64"))


def test_block_operator_equals_jax():
    rng = np.random.default_rng(7)
    A, B, C = (rng.standard_normal(s) for s in ((5, 5), (5, 3), (3, 3)))
    x = rng.standard_normal(8)
    for a11 in (None, C):
        ops = []
        for xp, mod in ((jnp.asarray, jblock), (torch.as_tensor, tblock)):
            mats = [xp(m) for m in (A, B, B.T)]
            A11 = None if a11 is None else (lambda m: (lambda v: m @ v))(xp(a11))
            ops.append(mod.BlockOperator(5, 3, lambda v, m=mats[0]: m @ v,
                                         lambda v, m=mats[1]: m @ v,
                                         lambda v, m=mats[2]: m @ v, A11))
        close(ops[1].mult(torch.as_tensor(x)), ops[0].mult(jnp.asarray(x)))
    jp = jblock.block_diag_precond(lambda r: 2.0 * r, lambda r: -r, 5)
    tp = tblock.block_diag_precond(lambda r: 2.0 * r, lambda r: -r, 5)
    close(tp(torch.as_tensor(x)), jp(jnp.asarray(x)))


def _convection_diffusion(form):
    return (form.add_domain_integrator("diffusion", 0.05)
            .add_domain_integrator("convection", None, vector_coeff=(1.0, 0.5, 0.25))
            .add_boundary_integrator("mass", 1.0))


def _same_norm(tinfo, jinfo, beta0):
    """The final residual norms agree to 1e-10 of the initial one (they
    sit near the round-off floor, where their own relative difference is
    not meaningful)."""
    assert abs(tinfo.final_norm - float(jinfo.final_norm)) <= RTOL * beta0


def test_gmres_convection_diffusion_equals_jax():
    """Restart 10 on a 343-dof order-2 space: several cycles."""
    jfes, tfes = JFESpace(jhex(3, 3, 3), 2), FESpace(thex(3, 3, 3), 2)
    jA = _convection_diffusion(jbf.BilinearForm(jfes)).assemble("float64")
    tA = _convection_diffusion(tbf.BilinearForm(tfes, "cpu")).assemble("float64")
    b = np.random.default_rng(1).standard_normal(tfes.ndof)
    jd, td = jax.jit(jA.diagonal)(), tA.diagonal()
    kw = dict(rel_tol=1e-9, restart=10, max_iter=300)
    jx, jinfo = jax.jit(lambda b: jsolvers.gmres(jA.mult, b, M=lambda r: r / jd,
                                                 **kw))(jnp.asarray(b))
    tx, tinfo = tsolvers.gmres(tA.mult, torch.as_tensor(b), M=lambda r: r / td, **kw)
    assert tinfo.iterations == int(jinfo.iterations) > 10
    assert tinfo.converged and bool(jinfo.converged)
    _same_norm(tinfo, jinfo, np.linalg.norm(b / td.numpy()))
    close(tx, jx)
    r = b - tA.mult(tx).numpy()
    assert np.linalg.norm(r) <= 1e-6 * np.linalg.norm(b)


@pytest.mark.parametrize("restart,max_iter", [(7, 200), (5, 10)])
def test_gmres_dense_equals_jax(restart, max_iter):
    rng = np.random.default_rng(restart)
    n = 40
    A = 4.0 * np.eye(n) + 0.4 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    d = np.diag(A).copy()
    jA, tA = jnp.asarray(A), torch.as_tensor(A)
    kw = dict(rel_tol=1e-11, restart=restart, max_iter=max_iter)
    jx, jinfo = jax.jit(lambda b: jsolvers.gmres(
        lambda v: jA @ v, b, M=lambda r: r / jnp.asarray(d), **kw))(jnp.asarray(b))
    tx, tinfo = tsolvers.gmres(lambda v: tA @ v, torch.as_tensor(b),
                               M=lambda r: r / torch.as_tensor(d), **kw)
    assert tinfo.iterations == int(jinfo.iterations)
    assert tinfo.converged == bool(jinfo.converged)
    _same_norm(tinfo, jinfo, np.linalg.norm(b / d))
    close(tx, jx)


def test_cg_fixed_work_equals_jax():
    rng = np.random.default_rng(3)
    Q = rng.standard_normal((30, 30))
    A = Q @ Q.T + 30.0 * np.eye(30)
    b = rng.standard_normal(30)
    jA, tA = jnp.asarray(A), torch.as_tensor(A)
    for check, max_iter in ((False, 7), (False, 12), (True, 200)):
        kw = dict(rel_tol=1e-12, max_iter=max_iter, check_convergence=check)
        jx, jinfo = jax.jit(lambda b: jsolvers.cg(lambda v: jA @ v, b, **kw))(
            jnp.asarray(b))
        tx, tinfo = tsolvers.cg(lambda v: tA @ v, torch.as_tensor(b), **kw)
        assert tinfo.iterations == int(jinfo.iterations)
        if not check:
            assert tinfo.iterations == max_iter
        assert tinfo.converged == bool(jinfo.converged)
        close(tx, jx)


def test_elasticity_cantilever_equals_jax():
    """ex2's beam cut to 6×2×2, order 2: fixed x = 0 (5), load on x = 3 (3)."""
    kw = dict(order=2, lam=1.0, mu=1.0, fixed_bdr=(5,), force_bdr=(3,),
              rel_tol=1e-10, dtype="float64")
    jr = jelasticity.solve(jhex(6, 2, 2, sx=3.0), **kw)
    tr = telasticity.solve(thex(6, 2, 2, sx=3.0), device="cpu", **kw)
    assert tr.iterations == jr.iterations and tr.converged and jr.converged
    close(tr.u, jr.u)
    close(tr.displacement(), jr.displacement())
    assert tr.displacement()[:, 2].min() < 0.0


def test_register_integrator_joins_the_element_major_terms():
    """A registered integrator (here mass scaled by 3 through its own
    module) applies and assembles its diagonal beside the built-in terms,
    equal to the built-in mass with coefficient 3."""
    import types

    from cardiac_ablation_ecm2_tpu_torch.ops import mass

    scaled = types.SimpleNamespace(
        setup=lambda gf, cq=None: 3.0 * mass.setup(gf, cq),
        apply=mass.apply, diagonal=mass.diagonal)
    tbf.register_integrator("mass3", scaled)
    try:
        fes = FESpace(thex(2, 2, 2), 2)
        A = tbf.BilinearForm(fes, "cpu").add_domain_integrator("mass3") \
            .add_domain_integrator("diffusion").assemble("float64")
        B = tbf.BilinearForm(fes, "cpu").add_domain_integrator("mass", 3.0) \
            .add_domain_integrator("diffusion").assemble("float64")
    finally:
        del tbf._INTEGRATORS["mass3"]
    assert [t.kind for t in A.std_terms] == ["mass3"]
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(fes.ndof))
    close(A.mult(x), B.mult(x), 1e-12)
    close(A.diagonal(), B.diagonal(), 1e-12)
    with pytest.raises(ValueError, match="unknown integrator"):
        tbf.BilinearForm(fes, "cpu").add_domain_integrator("mass3")
