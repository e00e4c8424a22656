"""The port's AMR host layer against the JAX package: triangle and tet
bisection (``mesh/amr``) bitwise; point location and evaluation
(``mesh/point_eval``) within 1e-13; ``interp_after_refine``;
``attribute_sets``; the ``AMRForest`` (``mesh/forest``) through refine →
derefine round trips, the balance refusal and ``test_derefine.py``'s ex15
moving-front loop, the forests held bitwise after every operation (the
JAX forest is driven by the port loop's marks and estimates)."""

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem.estimators import zz_estimator
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.fem.gridfunction import l2_error, project
from cardiac_ablation_ecm2_tpu_torch.fem.ncfespace import NCFESpace
from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
from cardiac_ablation_ecm2_tpu_torch.mesh import amr, forest, point_eval
from cardiac_ablation_ecm2_tpu_torch.mesh.attribute_sets import (
    AttributeSets,
    resolve_marker,
)
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import (
    make_cartesian_2d,
    make_cartesian_2d_tri,
    make_cartesian_3d,
    make_cartesian_3d_tet,
)
from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf
from test_torch_ncmesh import assert_same_mesh

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jmesh():
    from cardiac_ablation_ecm2_tpu.mesh import mesh

    return mesh


# ----------------------------------------------------------------------------
# bisection
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("rounds", [1, 3])
def test_triangle_bisection_bitwise(rounds):
    from cardiac_ablation_ecm2_tpu.mesh import amr as jamr

    jm, tm = jmesh().make_cartesian_2d_tri(4, 4), make_cartesian_2d_tri(4, 4)
    for r in range(rounds):
        cent = tm.vertices[tm.elements].mean(axis=1)
        eta = np.exp(-20 * ((cent[:, 0] - 0.3) ** 2 + (cent[:, 1] - 0.6) ** 2))
        jm, jp, jany = jamr.threshold_refine(jm, eta, frac=0.5)
        tm, tp, tany = amr.threshold_refine(tm, eta, frac=0.5)
        assert jany == tany is True
        assert_same_mesh(jm, tm)
        assert np.array_equal(jp, tp)
    # conforming: every interior edge is shared by exactly two triangles
    e = np.sort(tm.elements[:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2), axis=1)
    _, cnt = np.unique(e, axis=0, return_counts=True)
    assert cnt.max() == 2 and (cnt == 1).sum() == tm.nbe


def test_tet_bisection_bitwise():
    from cardiac_ablation_ecm2_tpu.mesh import amr as jamr

    jm, tm = jmesh().make_cartesian_3d_tet(2, 2, 2), make_cartesian_3d_tet(2, 2, 2)
    for r in range(2):
        cent = tm.vertices[tm.elements].mean(axis=1)
        marks = np.linalg.norm(cent, axis=1) < 0.6 / (r + 1)
        jm, jp = jamr.bisect_marked_tets(jm, marks)
        tm, tp = amr.bisect_marked_tets(tm, marks)
        assert_same_mesh(jm, tm)
        assert np.array_equal(jp, tp)


# ----------------------------------------------------------------------------
# point evaluation and transfer
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["tri", "quad", "hex", "tet"])
def test_evaluate_at_points(kind):
    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.mesh import point_eval as jpe

    makers = {"tri": ("make_cartesian_2d_tri", (4, 4)),
              "quad": ("make_cartesian_2d", (3, 4)),
              "hex": ("make_cartesian_3d", (2, 3, 2)),
              "tet": ("make_cartesian_3d_tet", (2, 2, 2))}
    name, args = makers[kind]
    tm = globals()[name](*args)
    if kind in ("quad", "hex"):        # a non-affine map: Newton inverts it
        tm.vertices = tm.vertices + 0.03 * np.sin(7 * tm.vertices[:, ::-1])
    jm = getattr(jmesh(), name)(*args)
    jm.vertices = tm.vertices.copy()
    jf, tf = JFESpace(jm, 2), FESpace(tm, 2)
    rng = np.random.default_rng(3)
    u = rng.standard_normal(tf.ndof_scalar)
    pts = rng.uniform(-0.05, 1.0, size=(40, tm.sdim))
    je, jr = jpe.locate_points(jm, pts)
    te, tr = point_eval.locate_points(tm, pts)
    assert np.array_equal(te, je) and (te >= 0).sum() > 20 and (te < 0).any()
    assert np.abs(tr - jr).max() <= 1e-13
    got = point_eval.evaluate_at_points(tf, u, pts)
    ref = jpe.evaluate_at_points(jf, u, pts)
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()


def test_interp_after_refine():
    """test_amr's transfer: a quadratic through a full bisection round is
    reproduced, and the values equal JAX's."""
    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.mesh import amr as jamr

    def f(x):
        return x[..., 0] * x[..., 1] + x[..., 1] ** 2

    tm, jm = make_cartesian_2d_tri(3, 3), jmesh().make_cartesian_2d_tri(3, 3)
    tf = FESpace(tm, 2)
    u = project(tf, f, **F64)
    tm2, _ = amr.bisect_marked(tm, np.ones(tm.ne, dtype=bool))
    jm2, _ = jamr.bisect_marked(jm, np.ones(jm.ne, dtype=bool))
    tf2 = FESpace(tm2, 2)
    u2 = amr.interp_after_refine(tf, tf2, u, device="cpu", dtype=torch.float64)
    assert u2.dtype == torch.float64 and u2.device.type == "cpu"
    assert torch.allclose(u2, project(tf2, f, **F64), rtol=0, atol=1e-10)
    ref = jamr.interp_after_refine(JFESpace(jm, 2), JFESpace(jm2, 2), u.numpy())
    assert np.abs(u2.numpy() - np.asarray(ref)).max() <= 1e-13


def test_attribute_sets():
    """test_amr's attribute-set case, and the same lists as JAX's class."""
    from cardiac_ablation_ecm2_tpu.mesh import attribute_sets as jas

    seen = []
    for cls, resolve in ((jas.AttributeSets, jas.resolve_marker),
                         (AttributeSets, resolve_marker)):
        s = cls()
        s.set("walls", [1, 3])
        s.add_to("walls", [4])
        s.set("inlet", [2])
        seen.append((s.get("walls"), s.union("walls", "inlet"), s.names(),
                     "inlet" in s, resolve("inlet", s)))
    assert seen[0] == seen[1]
    assert seen[1][0] == [1, 3, 4] and seen[1][1] == [1, 2, 3, 4]
    fes = FESpace(make_cartesian_2d(3, 3), 2)
    ess = fes.essential_dofs(resolve_marker("inlet", s))
    assert np.allclose(fes.dof_coords[ess][:, 0], 1.0)     # the x = 1 side
    assert resolve_marker(None, AttributeSets()) is None
    assert resolve_marker((5, 6), AttributeSets()) == [5, 6]


# ----------------------------------------------------------------------------
# the forest
# ----------------------------------------------------------------------------


def assert_same_forest(jf, tf):
    assert jf.active == tf.active and len(jf.nodes) == len(tf.nodes)
    assert_same_mesh(jf.mesh(), tf.mesh())


@pytest.mark.parametrize("kind", ["quad", "hex"])
def test_forest_roundtrip(kind):
    """test_derefine's round trips: refine, then derefine everything back to
    the root mesh and its boundary."""
    from cardiac_ablation_ecm2_tpu.mesh import forest as jforest

    args = (4, 4) if kind == "quad" else (2, 2, 2)
    name = "make_cartesian_2d" if kind == "quad" else "make_cartesian_3d"
    jf = jforest.AMRForest(getattr(jmesh(), name)(*args))
    tf = forest.AMRForest(globals()[name](*args))
    ne0 = len(tf.active)
    marks = np.zeros(ne0, bool)
    marks[[5, 6] if kind == "quad" else [0]] = True
    jf.refine(marks)
    tf.refine(marks)
    assert_same_forest(jf, tf)
    assert len(tf.active) == ne0 + (6 if kind == "quad" else 7)
    ones = np.ones(len(tf.active), bool)
    assert tf.derefine(ones) == jf.derefine(ones)
    assert_same_forest(jf, tf)
    assert len(tf.active) == ne0
    assert tf.mesh().nbe == (16 if kind == "quad" else 24)


def test_forest_derefine_respects_balance():
    from cardiac_ablation_ecm2_tpu.mesh import forest as jforest

    jf = jforest.AMRForest(jmesh().make_cartesian_2d(2, 2))
    tf = forest.AMRForest(make_cartesian_2d(2, 2))
    for f in (jf, tf):
        f.refine(np.array([True, False, False, False]))
        marks = np.zeros(len(f.active), bool)
        marks[0] = True
        f.refine(marks)
    assert_same_forest(jf, tf)
    ones = np.ones(len(tf.active), bool)
    assert tf.derefine(ones) == jf.derefine(ones)
    assert_same_forest(jf, tf)
    from cardiac_ablation_ecm2_tpu_torch.mesh.ncmesh import make_nc

    assert not forest._bad_master_edges(make_nc(tf.mesh()).constraints)


def _solve_nc(nc, u_exact, f_rhs, p=2):
    """test_derefine's ``_solve_nc``: Dirichlet data from ``u_exact``."""
    sp = NCFESpace(nc, p, device="cpu")
    A = BilinearForm(sp.fes, "cpu").add_domain_integrator("diffusion").assemble(
        dtype=torch.float64)
    ess = torch.as_tensor(sp.essential_dofs(), dtype=torch.long)
    xb = torch.as_tensor(u_exact(sp.dof_coords))
    bL = domain_lf(sp.fes, f_rhs, **F64)
    AC = sp.constrained_operator(A.mult)

    def op(x):
        z = x.index_fill(0, ess, 0.0)
        return AC(z).index_copy(0, ess, x[ess])

    w = torch.zeros(sp.ndof_conf, **F64).index_copy(0, ess, xb[ess])
    b = (sp.restrict_t(bL) - AC(w)).index_copy(0, ess, xb[ess])
    x, info = cg(op, b, rel_tol=1e-10, max_iter=4000)
    assert info.converged
    return sp, sp.prolongate(x)


def test_ex15_moving_front_loop():
    """test_derefine's moving-bump loop on the port (refine sweeps by the ZZ
    estimate, then a derefine sweep, at t = 0, 0.25, 0.5): the error stays
    under 2e-3 and the element count bounded, and a JAX forest given the
    same marks and estimates stays bitwise equal throughout."""
    from cardiac_ablation_ecm2_tpu.mesh import forest as jforest

    def make_u(t):
        cx = 0.25 + t

        def u(x):
            return np.exp(-80.0 * ((x[..., 0] - cx) ** 2 + (x[..., 1] - 0.5) ** 2))

        def f(x):
            a = 80.0
            r2 = (x[..., 0] - cx) ** 2 + (x[..., 1] - 0.5) ** 2
            return (4 * a - 4 * a * a * r2) * torch.exp(-a * r2)

        return u, f

    jf = jforest.AMRForest(jmesh().make_cartesian_2d(8, 8))
    tf = forest.AMRForest(make_cartesian_2d(8, 8))
    errs, counts = [], []
    for t in (0.0, 0.25, 0.5):
        u_ex, f = make_u(t)
        for _ in range(2):
            sp, uL = _solve_nc(tf.nc(), u_ex, f)
            eta = zz_estimator(sp.fes, uL)
            changed = forest.threshold_refine_nc(tf, eta, frac=0.5, max_elements=700)
            assert jforest.threshold_refine_nc(jf, eta, frac=0.5,
                                               max_elements=700) == changed
            assert_same_forest(jf, tf)
            if not changed:
                break
        sp, uL = _solve_nc(tf.nc(), u_ex, f)
        eta = zz_estimator(sp.fes, uL)
        merged = forest.threshold_derefine_nc(tf, eta, threshold=0.3 * eta.max())
        assert jforest.threshold_derefine_nc(jf, eta, threshold=0.3 * eta.max()) == merged
        assert_same_forest(jf, tf)
        sp, uL = _solve_nc(tf.nc(), u_ex, f)
        errs.append(float(l2_error(sp.fes, uL, lambda x: torch.exp(
            -80.0 * ((x[..., 0] - 0.25 - t) ** 2 + (x[..., 1] - 0.5) ** 2)))))
        counts.append(len(tf.active))
    assert all(e < 2e-3 for e in errs), errs
    assert counts[-1] < 700 and counts[-1] < counts[0] * 3, counts
