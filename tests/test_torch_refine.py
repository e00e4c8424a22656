"""The port's mesh core and h-hierarchy against the JAX package, float64
on the CPU, quad_extra 0 in both packages:

* the makers (``make_cartesian_2d``, ``make_periodic_cartesian_2d``,
  ``make_cartesian_2d_tri``), ``unique_edges`` / ``unique_faces``,
  ``curve_mesh`` and ``Mesh.uniform_refinement`` (quads, triangles, hexes,
  the cardiac hex mesh at n = 8, curved quads, triangles and hexes,
  periodic quads), bitwise; child o of parent e is fine element o·ne + e;
  tets raise;
* ``element_node_coords`` and the geometric factors of curved meshes
  (``fem/build.geom_factors_for``, what every form reads), which follow
  the curved nodes (1e-13);
* ``HTransfer`` prolongate and restrict_t on quads, triangles and hexes
  (1e-12 of JAX's, exact on a field of the coarse space, adjoint);
* ``make_h_multigrid`` PCG on ``make_cartesian_2d(4, 4)`` refined twice at
  order 2 (``tests/test_multigrid.py``'s h case): equal CG counts, u to
  1e-10.  Both packages' Chebyshev smoothers take the port's power-method
  bounds (JAX's ``chebyshev`` is wrapped to receive them, as
  ``test_torch_multigrid`` shares ``eig_max``): the two draw different
  random starts;
* the 2D ``CartesianFESpace`` (its lattice restriction with component
  axes) against the generic space and JAX's; ``rf_source_q``."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.fem import fespace as jfespace
from cardiac_ablation_ecm2_tpu.fem import geom_factors as jgeom
from cardiac_ablation_ecm2_tpu.fem.cartesian import CartesianFESpace as JCart
from cardiac_ablation_ecm2_tpu.fem.transfer import HTransfer as JHTransfer
from cardiac_ablation_ecm2_tpu.linalg import multigrid as jmg
from cardiac_ablation_ecm2_tpu.linalg import smoothers as jsmoothers
from cardiac_ablation_ecm2_tpu.linalg.solvers import cg as jcg
from cardiac_ablation_ecm2_tpu.mesh import cardiac as jcardiac
from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh
from cardiac_ablation_ecm2_tpu.ops import bilinearform as jbf
from cardiac_ablation_ecm2_tpu.ops.linearform import domain_lf as jdomain_lf
from cardiac_ablation_ecm2_tpu.ops.operators import ConstrainedOperator as JConstrained
from cardiac_ablation_ecm2_tpu.utils.config import config as jcfg
from cardiac_ablation_ecm2_tpu.utils.config import configure as jconfigure
from cardiac_ablation_ecm2_tpu_torch.fem import fespace as tfespace
from cardiac_ablation_ecm2_tpu_torch.fem import gridfunction as tgf
from cardiac_ablation_ecm2_tpu_torch.fem.build import geom_factors_for, restriction_for
from cardiac_ablation_ecm2_tpu_torch.fem.cartesian import CartesianFESpace
from cardiac_ablation_ecm2_tpu_torch.fem.transfer import HTransfer
from cardiac_ablation_ecm2_tpu_torch.linalg import multigrid as tmg
from cardiac_ablation_ecm2_tpu_torch.linalg import smoothers
from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
from cardiac_ablation_ecm2_tpu_torch.mesh import cardiac as tcardiac
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.ops import bilinearform as tbf
from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf
from cardiac_ablation_ecm2_tpu_torch.ops.operators import ConstrainedOperator
from cardiac_ablation_ecm2_tpu_torch.utils.config import config as tcfg
from cardiac_ablation_ecm2_tpu_torch.utils.config import configure as tconfigure

F64 = dict(dtype="float64", device="cpu")
CARDIAC = dict(lengths=(0.04, 0.04, 0.02), electrode_radius=0.004)


@pytest.fixture(scope="module", autouse=True)
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
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


def _warp(x):
    """A smooth map of (..., 2|3) numpy arrays (both packages curve with it)."""
    y = [x[..., 0] + 0.1 * np.sin(np.pi * x[..., 1]),
         x[..., 1] + 0.05 * np.sin(np.pi * x[..., 0])]
    return np.stack(y + ([x[..., 2]] if x.shape[-1] == 3 else []), axis=-1)


MESHES = {
    "quad": lambda m: m.make_cartesian_2d(5, 3, 2.0, 1.5),
    "tri": lambda m: m.make_cartesian_2d_tri(4, 3),
    "periodic": lambda m: m.make_periodic_cartesian_2d(4, 3),
    "periodic-x": lambda m: m.make_periodic_cartesian_2d(4, 3, periodic=(True, False)),
    "hex": lambda m: m.make_cartesian_3d(3, 2, 2),
    "curved-quad": lambda m: m.curve_mesh(m.make_cartesian_2d(3, 3), _warp, 2),
    "curved-tri": lambda m: m.curve_mesh(m.make_cartesian_2d_tri(3, 3), _warp, 2),
    "curved-hex": lambda m: m.curve_mesh(m.make_cartesian_3d(2, 2, 2), _warp, 3),
}


def _pair(name):
    if name == "cardiac":
        return (jcardiac.make_cardiac_hex_mesh(8, **CARDIAC),
                tcardiac.make_cardiac_hex_mesh(8, **CARDIAC))
    return MESHES[name](jmesh), MESHES[name](tmesh)


def same_mesh(j, t):
    for f in ("vertices", "elements", "attributes", "boundary",
              "bdr_attributes", "nodes"):
        a, b = getattr(j, f), getattr(t, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a.view(np.int64), b.view(np.int64)), f
    assert j.geom == t.geom and j.nodes_order == t.nodes_order


@pytest.mark.parametrize("name", list(MESHES) + ["cardiac"])
def test_makers_tables_and_refinement_bitwise(name):
    j, t = _pair(name)
    same_mesh(j, t)
    for a, b in zip(jmesh.unique_edges(j), tmesh.unique_edges(t)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if t.dim == 3:
        for a, b in zip(jmesh.unique_faces(j), tmesh.unique_faces(t)):
            assert np.array_equal(a, b)
    for r in (1, 2):
        jr, tr = j.uniform_refinement(r), t.uniform_refinement(r)
        same_mesh(jr, tr)
    # child o of parent e is fine element o·ne + e: its centroid lies in e
    fine = t.uniform_refinement()
    nchild = fine.ne // t.ne
    cen = fine.vertices[fine.elements].mean(axis=1).reshape(nchild, t.ne, -1)
    lo = t.vertices[t.elements].min(axis=1)
    hi = t.vertices[t.elements].max(axis=1)
    if t.nodes is None:
        assert np.all((cen >= lo - 1e-12) & (cen <= hi + 1e-12))
    assert np.array_equal(fine.attributes.reshape(nchild, -1)[0], t.attributes)


def test_tets_do_not_refine():
    with pytest.raises(NotImplementedError):
        tmesh.make_cartesian_3d_tet(1, 1, 1).uniform_refinement()


@pytest.mark.parametrize("name,p", [("curved-quad", 3), ("curved-tri", 3),
                                    ("curved-hex", 2), ("periodic", 2)])
def test_curved_geometry_follows_nodes(name, p):
    """Element node coordinates at another order than the nodes', and the
    geometric factors of the curved space, equal JAX's."""
    j, t = _pair(name)
    jx, tx = jfespace.element_node_coords(j, p), tfespace.element_node_coords(t, p)
    close(tx, jx, 1e-13)
    straight = tfespace.element_node_coords(tmesh.Mesh(
        geom=t.geom, vertices=t.vertices, elements=t.elements,
        attributes=t.attributes, boundary=t.boundary,
        bdr_attributes=t.bdr_attributes), p)
    if name != "periodic":
        assert np.abs(tx - straight).max() > 1e-3
    jf, tf = JFESpace(j, p), FESpace_(t, p)
    jg = jgeom.compute_geometric_factors(jfespace.element_node_coords(j, p), jf.d2q)
    tg = geom_factors_for(tf, None, **F64)     # what every form reads
    close(tg.det, jg.det, 1e-13)
    close(tg.jac, jg.jac, 1e-13)
    close(tf.dof_coords, jf.dof_coords, 1e-13)


def FESpace_(mesh, p, vdim=1):
    return tfespace.FESpace(mesh, p, vdim)


@pytest.mark.parametrize("name,p", [("quad", 3), ("tri", 2), ("hex", 2)])
def test_htransfer_equals_jax(name, p):
    j, t = _pair(name)
    jc, jf = JFESpace(j, p), JFESpace(j.uniform_refinement(), p)
    tc, tf = FESpace_(t, p), FESpace_(t.uniform_refinement(), p)
    jtr, ttr = JHTransfer(jc, jf), HTransfer(tc, tf, **F64)
    close(ttr.I, jtr.I, 1e-14)
    rng = np.random.default_rng(p)
    a, b = rng.random(tc.ndof), rng.random(tf.ndof)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    close(ttr.prolongate(ta), jax.jit(jtr.prolongate)(jnp.asarray(a)), 1e-12)
    close(ttr.restrict_t(tb), jax.jit(jtr.restrict_t)(jnp.asarray(b)), 1e-12)
    lhs = float(torch.dot(ttr.prolongate(ta), tb))
    assert abs(lhs - float(torch.dot(ta, ttr.restrict_t(tb)))) <= 1e-12 * abs(lhs)
    if t.nodes is None:
        # a field of the coarse space is reproduced exactly
        def field(x):
            return 1.0 + x[..., 0] - 0.5 * x[..., 1] ** 2 + 0.25 * x[..., 0] * x[..., 1]

        close(ttr.prolongate(tgf.project(tc, field, **F64)),
              tgf.project(tf, field, **F64), 1e-12)
    with pytest.raises(ValueError):
        HTransfer(tc, tc, **F64)


def _operators(pkg, fes):
    """The constrained diffusion operator of one package; JAX's mult and
    diagonal jitted (one compile each instead of one per operation)."""
    if pkg == "jax":
        A = jbf.BilinearForm(fes).add_domain_integrator("diffusion").assemble()
        c = JConstrained.wrap(A.operator(), fes.essential_dofs())
        return types.SimpleNamespace(mult=jax.jit(c.mult),
                                     diagonal=jax.jit(c.diagonal))
    A = tbf.BilinearForm(fes, "cpu").add_domain_integrator("diffusion").assemble(
        "float64")
    return ConstrainedOperator.wrap(A.operator(), fes.essential_dofs(), **F64)


def test_h_multigrid_pcg_equals_jax(monkeypatch):
    """make_h_multigrid over make_cartesian_2d(4, 4) refined twice, order 2,
    u = 0 on the boundary, b = (1, v), rel_tol 1e-10; ``affine_collapse``
    "off" in both packages (the lane-major apply; JAX's numerical
    separability check compiles for ~2 s)."""
    monkeypatch.setattr(jcfg, "affine_collapse", "off")
    monkeypatch.setattr(tcfg, "affine_collapse", "off")
    bounds = []
    power = smoothers.power_method

    def recorded(*args, **kw):
        lam = power(*args, **kw)
        bounds.append(float(lam))
        return lam

    monkeypatch.setattr(smoothers, "power_method", recorded)
    tm = [tmesh.make_cartesian_2d(4, 4)]
    jm = [jmesh.make_cartesian_2d(4, 4)]
    for _ in range(2):
        tm.append(tm[-1].uniform_refinement())
        jm.append(jm[-1].uniform_refinement())
    tsp = {id(m): FESpace_(m, 2) for m in tm}
    jsp = {id(m): JFESpace(m, 2) for m in jm}
    ops = {}            # each level's operator, the fine one the CG's too

    def operators(pkg):
        return lambda f: ops.setdefault(id(f), _operators(pkg, f))

    mg = tmg.make_h_multigrid(tm, lambda m: tsp[id(m)], operators("torch"),
                              ess_factory=lambda f: f.essential_dofs(), **F64)
    assert len(bounds) == 3 and len(mg.levels) == 3
    shared = list(bounds)
    monkeypatch.setattr(jmg, "chebyshev", lambda A, diag, order: (
        jsmoothers.chebyshev(A, diag, order=order, eig_max=shared.pop(0))))
    jmgrid = jmg.make_h_multigrid(jm, lambda m: jsp[id(m)], operators("jax"),
                                  ess_factory=lambda f: f.essential_dofs())
    assert not shared
    tf, jf = tsp[id(tm[-1])], jsp[id(jm[-1])]
    tA, jA = ops[id(tf)], ops[id(jf)]
    b = domain_lf(tf, None, **F64) * tA.mask
    jb = jnp.asarray(np.asarray(jdomain_lf(jf, None))).at[
        jnp.asarray(jf.essential_dofs())].set(0.0)
    close(b, jb, 1e-13)
    x, info = cg(tA.mult, b, M=mg.preconditioner(), rel_tol=1e-10, max_iter=200)
    jx, jinfo = jcg(jA.mult, jb, M=jmgrid.preconditioner(), rel_tol=1e-10,
                    max_iter=200)
    assert info.converged and info.iterations == int(jinfo.iterations)
    assert mg.cycles == info.iterations + 1
    close(x, jx, 1e-10)
    xj, ij = cg(tA.mult, b, M=smoothers.jacobi(tA.diagonal()), rel_tol=1e-10,
                max_iter=2000)
    assert info.iterations < ij.iterations / 3
    close(x, xj, 1e-8)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_cartesian_2d_equals_generic_and_jax(p):
    shape, lengths = (4, 3), (1.0, 2.0)
    jm, tm = jmesh.make_cartesian_2d(*shape, *lengths), tmesh.make_cartesian_2d(
        *shape, *lengths)
    jc, tc = JCart(jm, p, shape, lengths), CartesianFESpace(tm, p, shape, lengths)
    assert (tc.ndof, tc.nd_elem) == (jc.ndof, jc.nd_elem)
    assert np.array_equal(tc.gather_map, jc.gather_map)
    assert np.array_equal(tc.dof_coords, jc.dof_coords)
    for marker in (None, [1], [2, 4]):
        assert np.array_equal(tc.essential_dofs(marker), jc.essential_dofs(marker))
    r = restriction_for(tc, "cpu")
    rng = np.random.default_rng(p)
    if p == 2:      # JAX's restriction with a component axis, jitted
        jr = jc.restriction
        u = rng.standard_normal((tc.ndof, 2))
        ue = rng.standard_normal((r.ne, r.nd, 2))
        close(r.mult(torch.as_tensor(u)), jax.jit(jr.mult)(jnp.asarray(u)), 0.0)
        close(r.mult_transpose(torch.as_tensor(ue)),
              jax.jit(jr.mult_transpose)(jnp.asarray(ue)), 1e-15)
    # integer values: every sum exact, so the generic restriction agrees
    er = restriction_for(FESpace_(tm, p), "cpu")
    iu = torch.as_tensor(rng.integers(-99, 99, tc.ndof).astype(np.float64))
    iue = torch.as_tensor(rng.integers(-99, 99, (r.ne, r.nd)).astype(np.float64))
    gen = FESpace_(tm, p)
    perm = torch.as_tensor(_lattice_of(gen, tc))
    assert torch.equal(r.mult(iu), er.mult(iu[perm]))
    assert torch.equal(r.mult_transpose(iue)[perm], er.mult_transpose(iue))
    assert torch.equal(r.mult_t(iu), r.mult(iu).T)
    assert torch.equal(r.mult_transpose_t(iue.T.contiguous()), r.mult_transpose(iue))
    v = torch.as_tensor(rng.standard_normal(2 * tc.ndof))
    assert torch.equal(r.mult_vec(v, 2)[..., 1], r.mult(v[tc.ndof:]))
    assert torch.equal(r.mult_transpose_vec(r.mult_vec(v, 2))[:tc.ndof],
                       r.mult_transpose(r.mult(v[:tc.ndof])))
    # a diffusion + mass form on either space: the same operator
    x = torch.as_tensor(rng.standard_normal(tc.ndof))
    forms = [tbf.BilinearForm(s, "cpu").add_domain_integrator("diffusion", 0.7)
             .add_domain_integrator("mass", 2.0).assemble("float64")
             for s in (tc, gen)]
    close(forms[0].mult(x)[perm], forms[1].mult(x[perm]), 1e-13)
    close(forms[0].diagonal()[perm], forms[1].diagonal(), 1e-13)


def _lattice_of(gen, cart):
    """For each dof of the generic space, its lattice dof (by coordinates)."""
    L = {tuple(np.round(c, 12)): i for i, c in enumerate(cart.dof_coords)}
    return np.array([L[tuple(np.round(c, 12))] for c in gen.dof_coords])


def test_rf_source_q_equals_jax():
    q_j = jcardiac.rf_source_q(np.array([0.02, 0.02, 0.02]), sigma=0.003, power=2e7)
    q_t = tcardiac.rf_source_q(np.array([0.02, 0.02, 0.02]), sigma=0.003, power=2e7)
    x = np.random.default_rng(0).random((5, 7, 3)) * 0.04
    assert np.array_equal(q_t(x), q_j(x))
    close(q_t(torch.as_tensor(x)), q_j(x), 1e-15)
    assert q_t(torch.as_tensor(x, dtype=torch.float32)).dtype == torch.float32
