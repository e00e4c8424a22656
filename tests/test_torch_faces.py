"""The port's DG face tables (``fem/faces.py``), ``L2FESpace`` and
``l2_nodes_1d`` against the JAX package, float64 on the CPU.

Every table of ``build_face_data`` is held to JAX's within 1e-13 of its
largest entry (the integer tables exactly) on quads, triangles, hexes,
tets, a periodic quad mesh and the warped cardiac hex mesh, with and
without the gradients; the port evaluates the same expressions over whole
arrays, so the tables agree to a few ulps (1.7e-15 at most, measured).
"""

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem import faces as tfaces
from cardiac_ablation_ecm2_tpu_torch.fem import fespace as tfespace
from cardiac_ablation_ecm2_tpu_torch.fem.basis import l2_nodes_1d, make_dof_to_quad
from cardiac_ablation_ecm2_tpu_torch.fem.geometry import Geometry
from cardiac_ablation_ecm2_tpu_torch.mesh import cardiac as tcardiac
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


MESHES = {
    "quad": (lambda m, c: m.make_cartesian_2d(4, 3), 2),
    "tri": (lambda m, c: m.make_cartesian_2d_tri(3, 3), 2),
    "hex": (lambda m, c: m.make_cartesian_3d(2, 3, 2), 2),
    "tet": (lambda m, c: m.make_cartesian_3d_tet(1, 2, 1), 2),
    "periodic": (lambda m, c: m.make_periodic_cartesian_2d(
        6, 3, 1.0, 0.25, periodic=(True, False)), 1),
    "cardiac": (lambda m, c: c.make_cardiac_hex_mesh(3), 2),
}


def _meshes(kind):
    from cardiac_ablation_ecm2_tpu import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.mesh import cardiac as jcardiac

    make, p = MESHES[kind]
    return make(jmesh, jcardiac), make(tmesh, tcardiac), p


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("kind", list(MESHES))
def test_face_tables(kind, grad):
    from cardiac_ablation_ecm2_tpu.fem import faces as jfaces

    jm, tm, p = _meshes(kind)
    a = jfaces.build_face_data(jm, p, with_gradients=grad)
    b = tfaces.build_face_data(tm, p, with_gradients=grad)
    assert len(b.elem0) > 0 and (kind == "periodic" or len(b.b_elem) > 0)
    for name in a.__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, name
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, name
        if x.dtype.kind == "i":
            assert np.array_equal(x, y), name
        elif x.size:
            assert np.abs(x - y).max() <= 1e-13 * np.abs(x).max(), name


def test_face_tables_chunked(monkeypatch):
    """Chunks of a few faces give the one-chunk tables bitwise."""
    tm = tmesh.make_cartesian_3d(2, 2, 2)
    whole = tfaces.build_face_data(tm, 2, with_gradients=True)
    monkeypatch.setattr(tfaces, "CHUNK", 5)
    parts = tfaces.build_face_data(tm, 2, with_gradients=True)
    for name in whole.__dataclass_fields__:
        assert np.array_equal(getattr(whole, name), getattr(parts, name)), name


def test_l2_space_and_nodes():
    from cardiac_ablation_ecm2_tpu.fem import basis as jbasis
    from cardiac_ablation_ecm2_tpu.fem.fespace import L2FESpace as JL2

    for p in (0, 1, 3):
        assert np.array_equal(l2_nodes_1d(p), jbasis.l2_nodes_1d(p))
    a = jbasis.make_dof_to_quad(Geometry.CUBE, 2, 4, nodes="l2")
    b = make_dof_to_quad(Geometry.CUBE, 2, 4, nodes="l2")
    assert np.array_equal(a.B1, b.B1) and np.array_equal(a.G1, b.G1)
    h1 = make_dof_to_quad(Geometry.CUBE, 2, 4)
    assert not np.array_equal(h1.B1, b.B1)
    for kind in ("quad", "tet"):
        jm, tm, p = _meshes(kind)
        js, ts = JL2(jm, p), tfespace.L2FESpace(tm, p)
        assert (ts.ndof, ts.ndof_scalar, ts.nd_elem) == (js.ndof, js.ndof_scalar,
                                                         js.nd_elem)
        assert np.array_equal(ts.gather_map, js.gather_map)
        assert ts.gather_map.dtype == js.gather_map.dtype
        assert ts.essential_dofs([1]).size == 0
        for nq in (None, p + 3):
            jd, td = js.dof_to_quad(nq), ts.dof_to_quad(nq)
            assert np.array_equal(jd.points, td.points)
            assert np.array_equal(jd.full_B(), td.full_B())


def test_one_copy_of_eval_volume_basis():
    """``fem/fespace`` and the curved refinement use ``fem/faces``'s."""
    import inspect

    from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as mesh_mod

    assert tfespace._eval_volume_basis is tfaces._eval_volume_basis
    assert "def _eval_volume_basis" not in inspect.getsource(tfespace)
    assert "fem.faces import _eval_volume_basis" in inspect.getsource(mesh_mod)
