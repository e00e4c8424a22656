"""The port's vector spaces (``fem/fe_vector``, ``fe_vector_ho``,
``fe_vector_simplex``) against the JAX package's on the CPU: gather maps,
signs, essential dofs and the simplex edge and face codes bitwise, on
hexes, quads, tets and triangles at orders 1–3; the reference tables
(basis, curl, divergence, the simplex orientation matrices) bitwise; the
simplex DofTransformation and the ND/RT projection within 1e-13 and
bitwise; the prism and pyramid bases raising ``NotImplementedError``.
"""

import functools

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector as tv
from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector_ho as tho
from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector_simplex as ts
from cardiac_ablation_ecm2_tpu_torch.fem.geometry import Geometry
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAKERS = {
    "hex": lambda m: m.make_cartesian_3d(3, 2, 2),
    "quad": lambda m: m.make_cartesian_2d(3, 4),
    "tet": lambda m: m.make_cartesian_3d_tet(2, 2, 2),
    "tri": lambda m: m.make_cartesian_2d_tri(3, 3),
}
MARKERS = (None, [1], [2, 3])


@functools.lru_cache(maxsize=None)
def meshes(kind):
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh

    return MAKERS[kind](jmesh), MAKERS[kind](tmesh)


def same(a, b, what=""):
    assert np.array_equal(np.asarray(a), np.asarray(b)), what


def same_tables(js, tsp, fields):
    assert js.ndof == tsp.ndof
    for f in fields:
        same(getattr(js, f), getattr(tsp, f), f)
    for marker in MARKERS:
        same(js.essential_dofs(marker), tsp.essential_dofs(marker), f"ess {marker}")


@pytest.mark.parametrize("kind", sorted(MAKERS))
@pytest.mark.parametrize("cls", ["NDSpace", "RTSpace"])
def test_lowest_order_tables(kind, cls):
    from cardiac_ablation_ecm2_tpu.fem import fe_vector as jv

    jm, tm = meshes(kind)
    same_tables(getattr(jv, cls)(jm), getattr(tv, cls)(tm), ("gather_map", "signs"))


@pytest.mark.parametrize("kind", ["hex", "quad"])
@pytest.mark.parametrize("cls", ["NDSpaceHO", "RTSpaceHO"])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_tensor_ho_tables(kind, cls, p):
    from cardiac_ablation_ecm2_tpu.fem import fe_vector_ho as jho

    jm, tm = meshes(kind)
    same_tables(getattr(jho, cls)(jm, p), getattr(tho, cls)(tm, p),
                ("gather_map", "signs"))


@pytest.mark.parametrize("kind", ["tet", "tri"])
@pytest.mark.parametrize("cls", ["NDSimplexSpace", "RTSimplexSpace"])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_simplex_tables_and_transforms(kind, cls, p):
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem import fe_vector_simplex as js

    jm, tm = meshes(kind)
    a, b = getattr(js, cls)(jm, p), getattr(ts, cls)(tm, p)
    same_tables(a, b, ("gather_map",))
    for code in ("edge_code", "face_code"):
        if getattr(a, code) is not None:
            same(getattr(a, code), getattr(b, code), code)
        else:
            assert getattr(b, code) is None
    for key in ("B", "D", "edge_Ti", "face_Ti"):
        same(a.element[key], b.element[key], key)
    e = np.random.default_rng(p).standard_normal(a.gather_map.shape)
    for f in ("transform", "transform_t"):
        want = np.asarray(getattr(a, f)(jnp.asarray(e)))
        got = getattr(b, f)(torch.as_tensor(e)).numpy()
        assert np.abs(want - got).max() <= 1e-13 * np.abs(want).max(), f
    same(a.dense_transform(), b.dense_transform(), "dense transform")
    field = lambda x: np.sin(x + np.arange(x.shape[-1]))       # noqa: E731
    same(js.project_vec_simplex(a, field), ts.project_vec_simplex(b, field))


@pytest.mark.parametrize("geom", [Geometry.TRIANGLE, Geometry.SQUARE,
                                  Geometry.TETRAHEDRON, Geometry.CUBE])
@pytest.mark.parametrize("nq1d", [2, 3])
def test_reference_tables(geom, nq1d):
    from cardiac_ablation_ecm2_tpu.fem import fe_vector as jv
    from cardiac_ablation_ecm2_tpu.fem import fe_vector_ho as jho
    from cardiac_ablation_ecm2_tpu.fem.geometry import Geometry as JG

    jg = JG(int(geom))
    for name in ("nd0_basis", "rt0_basis"):
        for x, y in zip(getattr(jv, name)(jg, nq1d), getattr(tv, name)(geom, nq1d)):
            same(x, y, name)
    if geom in (Geometry.SQUARE, Geometry.CUBE):
        for name, k in (("nd_basis_ho", 2), ("rt_basis_ho", 1)):
            for x, y in zip(getattr(jho, name)(jg, k, nq1d),
                            getattr(tho, name)(geom, k, nq1d)):
                same(x, y, name)


@pytest.mark.parametrize("geom", [Geometry.PRISM, Geometry.PYRAMID])
def test_prism_and_pyramid_raise(geom):
    for fn in (tv.nd0_basis, tv.rt0_basis):
        with pytest.raises(NotImplementedError, match="item 6"):
            fn(geom, 2)
    mesh = tmesh.make_cartesian_3d(1, 1, 1)
    mesh.geom = geom
    for cls in (tv.NDSpace, tv.RTSpace):
        with pytest.raises(NotImplementedError, match="item 6"):
            cls(mesh)
