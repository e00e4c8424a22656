"""The port's prism (wedge) and pyramid H1 elements and mixed-geometry
spaces against the JAX package, float64 on the CPU: the geometry rows, the
makers and ``unique_faces`` (bitwise), the rules and bases (within 1e-13),
the spaces' gather maps (bitwise), ``fem/pyramid2`` (``PyramidP2Space``
bitwise, its operator within 1e-13), ``fem/pyramid3`` and
``fem/pyramid_p`` at p = 2–5 (nodes and bases within 1e-13), ``fem/mixed``
(the strip and the cube: tables bitwise, operators and linear forms within
1e-13), and a Poisson solve on each of a prism mesh, a pyramid mesh and
the mixed cube.  The solves hold the port's partial-assembly operator and
``cg`` to JAX's FULL assembly (the mixed cube: JAX's jitted
``MixedPAOperator``) and JAX's ``cg`` recurrence in numpy: u within
1e-10·max|u| at rel_tol 1e-12, the CG counts within ``COUNT_TOL`` (1).
JAX's mixed spaces are built once each (``jax_mixed``) and its mixed
operators set up under ``jax.jit``: their eager set-ups compile for ~2 s
a space."""

import functools

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem import basis, geometry, mixed, pyramid2, pyramid3
from cardiac_ablation_ecm2_tpu_torch.fem import pyramid_p
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf

G = geometry.Geometry
TOL = 1e-13
#: CG counts of the Poisson solves, port against JAX: the last iteration
#: crosses rel_tol 1e-12 within round-off of the two applies (the mixed
#: cube measured 44 against 43; prism and pyramid equal)
COUNT_TOL = 1
MAKERS = {G.PRISM: "make_cartesian_3d_prism", G.PYRAMID: "make_cartesian_3d_pyramid"}
ORDERS = {G.PRISM: (1, 2, 3), G.PYRAMID: (1, 2, 3, 4, 5)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.abs(a - b).max(initial=0.0) <= tol * max(
        1.0, np.abs(b).max(initial=0.0))


def jax_mesh():
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh

    return jmesh


def test_geometry_rows_equal_jax():
    from cardiac_ablation_ecm2_tpu.fem import geometry as jg

    for g in (G.PRISM, G.PYRAMID):
        for name in ("NUM_VERTS", "DIMENSION", "IS_TENSOR", "EDGES", "FACES", "FACE_GEOM"):
            assert getattr(geometry, name)[g] == getattr(jg, name)[g], name
        assert np.array_equal(geometry.REF_VERTS[g], jg.REF_VERTS[g])


@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 2, 1)])
@pytest.mark.parametrize("geom", [G.PRISM, G.PYRAMID])
def test_makers_and_faces_bitwise(geom, shape):
    a = getattr(tmesh, MAKERS[geom])(*shape, 1.0, 2.0, 0.5)
    b = getattr(jax_mesh(), MAKERS[geom])(*shape, 1.0, 2.0, 0.5)
    for f in ("vertices", "elements", "attributes", "boundary", "bdr_attributes"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for x, y in zip(tmesh.unique_faces(a), jax_mesh().unique_faces(b)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("nq1d", [2, 3, 5])
def test_rules_and_bases(nq1d):
    from cardiac_ablation_ecm2_tpu.fem import basis as jb

    for rule in ("prism_rule", "pyramid_rule"):
        for x, y in zip(getattr(basis, rule)(nq1d), getattr(jb, rule)(nq1d)):
            assert close(x, y)
    pts, _ = basis.pyramid_rule(nq1d)
    for x, y in zip(basis.pyramid_basis_matrices(1, pts), jb.pyramid_basis_matrices(1, pts)):
        assert close(x, y)
    pts, _ = basis.prism_rule(nq1d)
    for p in (1, 2, 3):
        for nodes in ("h1", "l2"):
            n1 = basis.h1_nodes_1d(p) if nodes == "h1" else basis.l2_nodes_1d(p)
            for x, y in zip(basis.prism_basis_matrices(p, pts, n1),
                            jb.prism_basis_matrices(p, pts, n1)):
                assert close(x, y)
    for g, orders in ORDERS.items():
        for p in orders:
            a, b = basis.make_dof_to_quad(g, p, nq1d), jb.make_dof_to_quad(g, p, nq1d)
            for f in ("points", "weights", "B", "G"):
                assert close(getattr(a, f), getattr(b, f)), (g, p, f)
            assert close(basis.h1_nodes(g, p), jb.h1_nodes(g, p))
            if g == G.PRISM or p == 1:
                assert np.array_equal(basis.lattice_multi_index(g, p),
                                      jb.lattice_multi_index(g, p))


@pytest.mark.parametrize("geom,p", [(g, p) for g, ps in ORDERS.items() for p in ps])
def test_gather_maps_bitwise(geom, p):
    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace

    a = FESpace(getattr(tmesh, MAKERS[geom])(2, 2, 2), p)
    b = JFESpace(getattr(jax_mesh(), MAKERS[geom])(2, 2, 2), p)
    assert a.ndof_scalar == b.ndof_scalar
    assert np.array_equal(a.gather_map, b.gather_map)
    assert np.array_equal(a.bdr_gather_map, b.bdr_gather_map)
    assert np.array_equal(a.dof_coords, b.dof_coords)
    assert np.array_equal(a.essential_dofs([1, 3]), b.essential_dofs([1, 3]))


def test_pyramid2_space_and_operator():
    import jax

    from cardiac_ablation_ecm2_tpu.fem import pyramid2 as jp2

    for x, y in zip(pyramid2.pyramid_p2_basis_matrices(basis.pyramid_rule(4)[0]),
                    jp2.pyramid_p2_basis_matrices(basis.pyramid_rule(4)[0])):
        assert close(x, y)
    a = pyramid2.PyramidP2Space(tmesh.make_cartesian_3d_pyramid(2, 2, 1))
    b = jp2.PyramidP2Space(jax_mesh().make_cartesian_3d_pyramid(2, 2, 1))
    assert a.ndof == b.ndof and np.array_equal(a.gather_map, b.gather_map)
    assert np.array_equal(a.essential_dofs(), b.essential_dofs())
    assert np.array_equal(a.dof_coords(), b.dof_coords())
    x = np.random.default_rng(2).standard_normal(a.ndof)
    kw = dict(diffusion_coeff=0.5, mass_coeff=3.0)
    mult, diag = pyramid2.pyramid_p2_operator(a, nq1d=5, dtype="float64",
                                              device="cpu", **kw)
    jmult, jdiag = jp2.pyramid_p2_operator(b, nq1d=5, **kw)
    assert close(mult(torch.as_tensor(x)).numpy(), jax.jit(jmult)(x))
    assert close(diag().numpy(), jax.jit(jdiag)())


@pytest.mark.parametrize("p", [2, 3, 4, 5])
def test_pyramid_p(p):
    from cardiac_ablation_ecm2_tpu.fem import pyramid3 as jp3
    from cardiac_ablation_ecm2_tpu.fem import pyramid_p as jpp

    assert pyramid_p.pyramid_num_dofs(p) == jpp.pyramid_num_dofs(p)
    assert close(pyramid_p.pyramid_nodes(p), jpp.pyramid_nodes(p))
    pts = basis.pyramid_rule(p + 1)[0]
    for x, y in zip(pyramid_p.pyramid_p_basis_matrices(p, pts),
                    jpp.pyramid_p_basis_matrices(p, pts)):
        assert close(x, y)
    B, _ = pyramid_p.pyramid_p_basis_matrices(p, pts)
    assert np.abs(B.sum(axis=1) - 1).max() <= 1e-11          # partition of unity
    if p == 3:
        assert close(pyramid3.PYRAMID_P3_NODES, jp3.PYRAMID_P3_NODES)
        for x, y in zip(pyramid3.pyramid_p3_basis_matrices(pts),
                        jp3.pyramid_p3_basis_matrices(pts)):
            assert close(x, y)


#: (mixed mesh, order) cases: the strip's triangles and quads at order 3
#: (GLL-warped triangle edges), the cube's hexes, pyramids and tets at orders 2 (the 14-node
#: pyramid) and 3 (the 30-node one)
MIXED = (("strip", 3), ("cube", 2), ("cube", 3))


@functools.lru_cache(maxsize=None)
def jax_mixed(kind, p):
    """JAX's mixed mesh and space (n = 2); its eager set-up compiles for
    ~2 s, so each is built once."""
    from cardiac_ablation_ecm2_tpu.fem import mixed as jm

    mm = getattr(jm, f"make_mixed_{kind}")(2)
    return mm, jm.MixedFESpace(mm, p)


def jax_mixed_apply(kind, p, x, **coeffs):
    """(mult x, diagonal) of JAX's ``MixedPAOperator``, its set-up traced
    with each under ``jax.jit`` (its eager set-up compiles for ~2 s)."""
    import jax

    from cardiac_ablation_ecm2_tpu.fem import mixed as jm

    fes = jax_mixed(kind, p)[1]
    mult = jax.jit(lambda v: jm.MixedPAOperator(fes, **coeffs).mult(v))
    diag = jax.jit(lambda: jm.MixedPAOperator(fes, **coeffs).diagonal())
    return np.asarray(mult(x)), np.asarray(diag())


@pytest.mark.parametrize("kind,p", MIXED)
def test_mixed_spaces_and_operators(kind, p):
    import jax

    from cardiac_ablation_ecm2_tpu.fem import mixed as jm

    a = getattr(mixed, f"make_mixed_{kind}")(2)
    b, fb = jax_mixed(kind, p)
    assert np.array_equal(a.vertices, b.vertices)
    for blk_a, blk_b in zip(a.blocks + a.boundary_blocks, b.blocks + b.boundary_blocks):
        assert blk_a[0] == blk_b[0]
        for x, y in zip(blk_a[1:], blk_b[1:]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    fa = mixed.MixedFESpace(a, p, "cpu", "float64")
    assert fa.ndof == fb.ndof
    # a port MixedMesh made of the JAX one's arrays numbers alike
    fj = mixed.MixedFESpace(mixed.MixedMesh(
        vertices=b.vertices, blocks=b.blocks, boundary=b.boundary,
        bdr_attributes=b.bdr_attributes, boundary_blocks=b.boundary_blocks), p, "cpu")
    for x, y, z in zip(fa.gather_maps, fb.gather_maps, fj.gather_maps):
        assert np.array_equal(x, y) and np.array_equal(z, y)
    for marker in (None, [1, 2]):
        x, y = fa.essential_dofs(marker), fb.essential_dofs(marker)
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(fa.dof_coords, fb.dof_coords)
    x = np.random.default_rng(p).standard_normal(fa.ndof)
    coeffs = dict(diffusion_coeff=0.7, mass_coeff=2.0)
    A = mixed.MixedPAOperator(fa, **coeffs)
    jy, jd = jax_mixed_apply(kind, p, x, **coeffs)
    assert close(A.mult(torch.as_tensor(x)).numpy(), jy)
    assert close(A.diagonal().numpy(), jd)
    lf = mixed.mixed_domain_lf(fa, lambda q: torch.sin(q[..., 0]) + q[..., 1])
    jlf = jax.jit(lambda: jm.mixed_domain_lf(fb, lambda q: jax.numpy.sin(q[..., 0])
                                             + q[..., 1]))()
    assert close(lf.numpy(), jlf)
    # R_bᵀ of each block's apply, summed in block order, is the operator
    y = sum(R.mult_transpose(A.block_apply(i, torch.as_tensor(x)))
            for i, R in enumerate(fa.restrictions))
    assert torch.equal(y, A.mult(torch.as_tensor(x)))


def np_cg(A, b, rel_tol, max_iter):
    from test_torch_ncfespace import np_cg as cg_np

    return cg_np(A, b, rel_tol, max_iter)


@functools.lru_cache(maxsize=None)
def jax_poisson(kind):
    """JAX's side of the Poisson solve (−Δu = 1, u = 0 on the listed
    boundary): FULL assembly (the cube: the jitted mixed operator), its
    right-hand side, and JAX's cg recurrence in numpy (M the identity,
    rel_tol 1e-12): (u, count)."""
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.fem import mixed as jm
    from cardiac_ablation_ecm2_tpu.ops import BilinearForm as JBilinearForm
    from cardiac_ablation_ecm2_tpu.ops.linearform import domain_lf as jdomain_lf

    if kind == "cube":
        fes = jax_mixed("cube", 2)[1]
        mult = jax.jit(lambda v: jm.MixedPAOperator(fes, diffusion_coeff=1.0).mult(v))
        A = lambda v: np.asarray(mult(jnp.asarray(v)))  # noqa: E731
        b = np.asarray(jax.jit(lambda: jm.mixed_domain_lf(
            fes, lambda q: 1.0 + 0 * q[..., 0]))())
    else:
        make = MAKERS[G.PRISM if kind == "prism" else G.PYRAMID]
        fes = JFESpace(getattr(jax_mesh(), make)(3, 3, 2), 2)
        K = JBilinearForm(fes).add_domain_integrator("diffusion").assemble_matrix()
        A = lambda v: K @ v  # noqa: E731
        b = np.asarray(jax.jit(lambda: jdomain_lf(fes, lambda q: 1.0 + 0 * q[..., 0]))())
    m = np.ones(fes.ndof_scalar)
    m[fes.essential_dofs()] = 0.0
    return np_cg(lambda v: A(v * m) * m + v * (1 - m), b * m, 1e-12, 4000)


@pytest.mark.parametrize("kind", ["prism", "pyramid", "cube"])
def test_poisson_equals_jax_full_assembly(kind):
    if kind == "cube":
        fes = mixed.MixedFESpace(mixed.make_mixed_cube(2), 2, "cpu", "float64")
        A = mixed.MixedPAOperator(fes, diffusion_coeff=1.0).mult
        b = mixed.mixed_domain_lf(fes, lambda q: 1.0 + 0 * q[..., 0])
    else:
        make = MAKERS[G.PRISM if kind == "prism" else G.PYRAMID]
        fes = FESpace(getattr(tmesh, make)(3, 3, 2), 2)
        A = BilinearForm(fes, "cpu").add_domain_integrator("diffusion").assemble(
            "float64").mult
        b = domain_lf(fes, 1.0, dtype="float64", device="cpu")
    m = torch.ones(fes.ndof_scalar, dtype=torch.float64)
    m[torch.as_tensor(fes.essential_dofs(), dtype=torch.long)] = 0.0
    u, info = cg(lambda v: A(v * m) * m + v * (1 - m), b * m, rel_tol=1e-12,
                 max_iter=4000)
    ju, jits = jax_poisson(kind)
    assert info.converged and abs(info.iterations - jits) <= COUNT_TOL
    assert np.abs(u.numpy() - ju).max() <= 1e-10 * np.abs(ju).max()
    assert np.abs(ju).max() > 0.01
