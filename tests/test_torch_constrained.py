"""The port's constrained and bound-constrained solvers against the JAX
package, float64 on the CPU:

* ``linalg/constrained.py``: the three strategies on JAX's dense KKT
  system (the penalty at 1e4, not JAX's 1e10) and on ex28's sliding trapezoid (order 1 and the order-2 normal
  constraints), ``boundary_face_normals`` and ``build_normal_constraints``
  array for array; x and λ within 1e-10 relative, equal CG / MINRES
  counts;
* ``linalg/obstacle.py``: JAX's membrane on a flat obstacle: equal outer
  and inner CG counts, u and λ within 1e-10;
* ``linalg/opt.py``: ``slbqp`` (equal bisection counts, x to 1e-10) and
  ``nnls`` (the host copy) against JAX's;
* ``models/topopt.py``: three SIMP/OC iterations on JAX's cantilever with
  the density filter: equal CG counts, ρ and the compliances to 1e-10."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.linalg import constrained as jc
from cardiac_ablation_ecm2_tpu.linalg import opt as jopt
from cardiac_ablation_ecm2_tpu.linalg.obstacle import obstacle_solve as jobstacle
from cardiac_ablation_ecm2_tpu.mesh import Mesh as JMesh
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.models.topopt import TopOpt as JTopOpt
from cardiac_ablation_ecm2_tpu.ops import BilinearForm as JBilinearForm
from cardiac_ablation_ecm2_tpu.ops.linearform import boundary_lf_vector as jblf
from cardiac_ablation_ecm2_tpu.ops.linearform import domain_lf as jdomain_lf
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import constrained as tc
from cardiac_ablation_ecm2_tpu_torch.linalg import opt as topt
from cardiac_ablation_ecm2_tpu_torch.linalg.obstacle import obstacle_solve
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import Mesh, make_cartesian_2d
from cardiac_ablation_ecm2_tpu_torch.models.topopt import TopOpt
from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
from cardiac_ablation_ecm2_tpu_torch.ops.linearform import boundary_lf_vector, domain_lf

RTOL = 1e-10
_MESH = ("geom", "vertices", "elements", "attributes", "boundary", "bdr_attributes")


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


def _trapezoid(make, mesh_cls, nx, ny, offset=0.3):
    m0 = make(nx, ny)
    V = m0.vertices.copy()
    V[:, 0] = V[:, 0] + (1.0 - V[:, 0]) * offset * V[:, 1]
    return mesh_cls(geom=m0.geom, vertices=V, elements=m0.elements,
                    attributes=m0.attributes, boundary=m0.boundary,
                    bdr_attributes=m0.bdr_attributes)


@pytest.mark.parametrize("n,order", [(8, 1), (4, 2)])
def test_ex28_sliding(n, order):
    jf = JFESpace(_trapezoid(jquad, JMesh, n, n), order, vdim=2)
    tf = FESpace(_trapezoid(make_cartesian_2d, Mesh, n, n), order, vdim=2)
    assert np.array_equal(tc.boundary_face_normals(tf.mesh),
                          jc.boundary_face_normals(jf.mesh))
    Bj = jc.build_normal_constraints(jf, [1, 4], dtype=jnp.float64)
    Bt = tc.build_normal_constraints(tf, [1, 4], dtype="float64", device="cpu")
    assert np.array_equal(Bt.idx.numpy(), np.asarray(Bj.idx))
    assert np.array_equal(Bt.val.numpy(), np.asarray(Bj.val))
    assert np.array_equal(Bt.rowstarts, Bj.rowstarts)
    Aj = JBilinearForm(jf).add_domain_integrator("elasticity", coeff=(1.0, 1.0)).assemble()
    At = BilinearForm(tf, "cpu").add_domain_integrator("elasticity",
                                                       coeff=(1.0, 1.0)).assemble()
    bj = jblf(jf, np.array([-5e-2, 0.0]), bdr_marker=[2])
    bt = boundary_lf_vector(tf, np.array([-5e-2, 0.0]), bdr_marker=[2], device="cpu")
    dj, dt = Aj.diagonal(), At.diagonal()
    xj, lj, ij = jc.eliminate_constrained_solve(Aj.mult, Bj, bj, M=lambda v: v / dj,
                                                rel_tol=1e-12, max_iter=6000)
    xt, lt, it = tc.eliminate_constrained_solve(At.mult, Bt, bt, M=lambda v: v / dt,
                                                rel_tol=1e-12, max_iter=6000)
    same_info(it, ij)
    close(xt, xj)
    close(lt, lj)
    if order == 1:
        xj, lj, ij = jc.schur_constrained_solve(Aj.mult, Bj, bj, Adiag=dj,
                                                rel_tol=1e-12, max_iter=8000)
        xt, lt, it = tc.schur_constrained_solve(At.mult, Bt, bt, Adiag=dt,
                                                rel_tol=1e-12, max_iter=8000)
        same_info(it, ij)
        close(xt, xj, 1e-9)


def _obstacle(n, deep):
    out = []
    for fes, form, lf, arr in (
            (JFESpace(jquad(n, n), 1), JBilinearForm, jdomain_lf, jnp.asarray),
            (FESpace(make_cartesian_2d(n, n), 1), lambda f: BilinearForm(f, "cpu"),
             lambda f, c: domain_lf(f, c, device="cpu"), torch.as_tensor)):
        A = form(fes).add_domain_integrator("diffusion").assemble()
        b = lf(fes, -8.0)
        fm = np.zeros(fes.ndof_scalar)
        fm[fes.essential_dofs()] = 1.0
        psi = arr(np.full(fes.ndof_scalar, -10.0 if deep else -0.08))
        out.append((A, b, psi, arr(fm)))
    return out


@pytest.mark.parametrize("n,deep", [(12, False), (8, True)])
def test_obstacle(n, deep):
    (Aj, bj, pj, fj), (At, bt, pt, ft) = _obstacle(n, deep)
    uj, lj, oj = jobstacle(Aj.mult, bj, pj, diag=Aj.diagonal(), fixed_mask=fj)
    ut, lt, ot = obstacle_solve(At.mult, bt, pt, diag=At.diagonal(), fixed_mask=ft)
    assert ot == oj
    close(ut, uj)
    if deep:
        assert float(lt.abs().max()) == 0.0 and float(jnp.abs(lj).max()) == 0.0
    else:
        close(lt, lj, 1e-9)
        assert (lt.numpy() > 1e-10).any()


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


def _beam(make, mesh_cls, nx, ny):
    m0 = make(nx, ny)
    V = m0.vertices.copy()
    V[:, 0] *= 2.0
    return mesh_cls(geom=m0.geom, vertices=V, elements=m0.elements,
                    attributes=m0.attributes, boundary=m0.boundary,
                    bdr_attributes=m0.bdr_attributes)


def test_topopt():
    jo = JTopOpt(_beam(jquad, JMesh, 12, 6), volfrac=0.4, filter_radius=0.3)
    to = TopOpt(_beam(make_cartesian_2d, Mesh, 12, 6), volfrac=0.4,
                filter_radius=0.3, device="cpu")
    rj, rt = jnp.full(jo.mesh.ne, 0.4), torch.full((to.mesh.ne,), 0.4,
                                                    dtype=torch.float64)
    uj = ut = None
    for _ in range(3):
        _, info = jo._solve(rj, uj)          # JAX's solve of this step, for its count
        rj, uj, cj = jo.step(rj, uj)
        rt, ut, ct = to.step(rt, ut)
        assert to.info.iterations == int(info.iterations)
        assert abs(ct - cj) <= RTOL * abs(cj)
        close(ut, uj)
        close(rt, rj)
