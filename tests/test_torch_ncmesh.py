"""The port's nonconforming meshes (``mesh/ncmesh``, ``mesh/nctet``)
against the JAX package: every array bitwise equal on the JAX tests'
meshes — vertex coordinates (as bits), elements, boundary, attributes,
``parent_of`` and the constraint rows in the same order — after 1–3
refinement rounds, isotropic and typed; the balance checks' outputs; and
2:1 balance after the rounds."""

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.mesh import ncmesh, nctet
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import (
    make_cartesian_2d,
    make_cartesian_3d,
    make_cartesian_3d_tet,
)

MESH_FIELDS = ("vertices", "elements", "attributes", "boundary", "bdr_attributes")
NC_FIELDS = ("constraints", "face_constraints", "half_face_constraints",
             "tri_face_constraints")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


def assert_same_mesh(jm, tm):
    for f in MESH_FIELDS:
        x, y = getattr(jm, f), getattr(tm, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(bits(x), bits(y)), f


def assert_same_nc(j, t):
    assert_same_mesh(j.mesh, t.mesh)
    for f in NC_FIELDS:
        if hasattr(j, f):
            x, y = getattr(j, f), getattr(t, f)
            assert x.shape == y.shape and np.array_equal(x, y), f
    assert j.n_hanging == t.n_hanging


def run_rounds(mod, nc, refine, marks_of, rounds):
    """``rounds`` refinements of ``nc`` by ``mod.<refine>`` with the marks
    (or types) ``marks_of(nc, r)``: the NC meshes and parent maps."""
    out = [(nc, None)]
    for r in range(rounds):
        nc, parent = getattr(mod, refine)(nc, marks_of(nc, r))
        out.append((nc, parent))
    return out


def both(jmod, maker_args, refine, marks_of, rounds, maker, make_nc="make_nc"):
    """The same rounds in both packages, from each package's own maker;
    every stage held bitwise."""
    import importlib

    jmaker = importlib.import_module(
        f"cardiac_ablation_ecm2_tpu.mesh.{maker[0]}").__dict__[maker[1]]
    tmaker = {"make_cartesian_2d": make_cartesian_2d,
              "make_cartesian_3d": make_cartesian_3d,
              "make_cartesian_3d_tet": make_cartesian_3d_tet,
              "make_cardiac_hex_mesh": make_cardiac_hex_mesh}[maker[1]]
    tmod = ncmesh if jmod.__name__.endswith("ncmesh") else nctet
    js = run_rounds(jmod, getattr(jmod, make_nc)(jmaker(*maker_args)), refine,
                    marks_of, rounds)
    ts = run_rounds(tmod, getattr(tmod, make_nc)(tmaker(*maker_args)), refine,
                    marks_of, rounds)
    for (jn, jp), (tn, tp) in zip(js, ts):
        assert_same_nc(jn, tn)
        if jp is not None:
            assert jp.dtype == tp.dtype and np.array_equal(jp, tp)
    return js, ts


def corner2d(nc, r):
    cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
    return (cent[:, 0] < 0.5 ** (r + 1)) & (cent[:, 1] < 0.5 ** (r + 1))


def corner3d(nc, r):
    cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
    return (cent < 0.5 ** (r + 1)).all(axis=1)


def electrode(nc, r):
    """The cardiac rounds: centroids within 10 mm, then 7 mm, of (20, 20,
    20) mm."""
    cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
    return np.linalg.norm(cent - 20.0, axis=1) < (10.0, 7.0, 5.0)[r]


# ----------------------------------------------------------------------------
# quads
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_quad_iso_bitwise(rounds):
    from cardiac_ablation_ecm2_tpu.mesh import ncmesh as jnc

    js, ts = both(jnc, (4, 4), "refine_quads", corner2d, rounds,
                  ("mesh", "make_cartesian_2d"))
    assert ts[-1][0].n_hanging > 0
    assert not ncmesh._overrefined_edges(ts[-1][0].mesh)


def test_quad_aniso_bitwise():
    """test_nc_aniso's two typed rounds on 3×3 (X on the left column, Y on
    the top row, ISO in the corner; then Y near the corner), and its forced
    neighbour split."""
    from cardiac_ablation_ecm2_tpu.mesh import ncmesh as jnc

    X, Y, ISO = ncmesh.X, ncmesh.Y, ncmesh.ISO

    def types(nc, r):
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        if r == 0:
            t = np.where(cent[:, 0] < 1 / 3, X, 0)
            t = np.where(cent[:, 1] > 2 / 3, Y, t)
            t[0] = ISO
            return t
        return np.where((cent[:, 0] < 1 / 6) & (cent[:, 1] < 1 / 3), Y, 0)

    js, ts = both(jnc, (3, 3), "refine_quads_aniso", types, 2,
                  ("mesh", "make_cartesian_2d"))
    assert ts[-1][0].n_hanging > 0

    def forced(nc, r):
        t = np.zeros(nc.mesh.ne, dtype=np.int64)
        t[0] = ISO if r == 0 else Y
        return t

    js, ts = both(jnc, (2, 1), "refine_quads_aniso", forced, 2,
                  ("mesh", "make_cartesian_2d"))
    assert not ncmesh._overrefined_edges(ts[-1][0].mesh)


# ----------------------------------------------------------------------------
# hexes
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("n,rounds", [(2, 1), (2, 2), (3, 3)])
def test_hex_iso_bitwise(n, rounds):
    from cardiac_ablation_ecm2_tpu.mesh import ncmesh as jnc

    js, ts = both(jnc, (n, n, n), "refine_hexes", corner3d, rounds,
                  ("mesh", "make_cartesian_3d"))
    nc = ts[-1][0]
    assert len(nc.face_constraints) > 0 and len(nc.constraints) > 0
    _assert_balanced(nc)


def test_cardiac_hex_electrode_rounds_bitwise():
    """The chip check's refinement (two rounds around the electrode) on the
    warped cardiac hex mesh, n = 8: half-face constraints appear.  The JAX
    package's balance loop stops here with a few over-hung faces left (it
    stops when the forced split bits are already set), so the check is
    that the bad-face lists agree."""
    from cardiac_ablation_ecm2_tpu.mesh import ncmesh as jnc

    js, ts = both(jnc, (8,), "refine_hexes", electrode, 2,
                  ("cardiac", "make_cardiac_hex_mesh"))
    nc = ts[-1][0]
    assert len(nc.half_face_constraints) > 0
    assert (ncmesh._find_constraints_3d(nc.mesh)[3]
            == jnc._find_constraints_3d(js[-1][0].mesh)[3])


@pytest.mark.parametrize("ty", ["X3", "Y3", "Z3", "X3|Y3", "Z3+X3|Z3"])
def test_hex_aniso_bitwise(ty):
    """test_nchex_aniso's typed splits: one hex of 2×1×1 (X: conforming; Z:
    a half-face), one of 2×2×2 by each type, and Z and X|Z on two hexes."""
    from cardiac_ablation_ecm2_tpu.mesh import ncmesh as jnc

    X3, Y3, Z3 = ncmesh.X3, ncmesh.Y3, ncmesh.Z3
    code = {"X3": [X3], "Y3": [Y3], "Z3": [Z3], "X3|Y3": [X3 | Y3],
            "Z3+X3|Z3": [Z3, 0, 0, X3 | Z3]}[ty]

    def types(nc, r):
        t = np.zeros(nc.mesh.ne, dtype=np.int64)
        t[: len(code)] = code
        return t

    bars = [(2, 1, 1)] if len(code) <= 2 else []
    for dims in bars + [(2, 2, 2)]:
        _, ts = both(jnc, dims, "refine_hexes_aniso", types, 1,
                     ("mesh", "make_cartesian_3d"))
        if ty == "Z3" and dims == (2, 1, 1):
            nc = ts[-1][0]
            assert len(nc.half_face_constraints) == 1 and len(nc.constraints) == 2


def test_hex_unbalanced_bad_faces_equal():
    """Without balance, a depth-2 corner leaves over-hung faces: the bad-face
    list (key, owner, needed splits, cyclic corners) equals JAX's, and so
    does the balance pass that follows."""
    from cardiac_ablation_ecm2_tpu.mesh import ncmesh as jnc

    def marks(nc, r):
        # the corner hex, then its child that touches unrefined neighbours
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        inside = (cent < 1 / 3).all(axis=1)
        return inside if r == 0 else inside & (cent > 1 / 6).all(axis=1)

    jn, tn = jnc.make_nc(jnc_mesh()), ncmesh.make_nc(make_cartesian_3d(3, 3, 3))
    for r in range(2):
        jn, _ = jnc.refine_hexes(jn, marks(jn, r), balance=False)
        tn, _ = ncmesh.refine_hexes(tn, marks(tn, r), balance=False)
        assert_same_nc(jn, tn)
    jb = jnc._find_constraints_3d(jn.mesh)[3]
    tb = ncmesh._find_constraints_3d(tn.mesh)[3]
    assert tb == jb and len(tb) > 0
    ja = jnc.refine_hexes(jn, np.zeros(jn.mesh.ne, bool))
    ta = ncmesh.refine_hexes(tn, np.zeros(tn.mesh.ne, bool))
    assert_same_nc(ja[0], ta[0])
    assert np.array_equal(ja[1], ta[1])


def jnc_mesh():
    from cardiac_ablation_ecm2_tpu.mesh.mesh import make_cartesian_3d as jm

    return jm(3, 3, 3)


def _assert_balanced(nc):
    """2:1: no over-hung face and no master edge with a constrained half."""
    _, _, _, bad = ncmesh._find_constraints_3d(nc.mesh)
    assert not bad
    assert not len(ncmesh._bad_master_edge_codes(nc.constraints,
                                                 len(nc.mesh.vertices)))


# ----------------------------------------------------------------------------
# tets
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("rounds", [1, 2])
def test_tet_bitwise(rounds):
    from cardiac_ablation_ecm2_tpu.mesh import nctet as jnt

    def marks(nc, r):
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        return np.linalg.norm(cent, axis=1) < 0.6 / (r + 1)

    js, ts = both(jnt, (2, 2, 2), "refine_tets_nc", marks, rounds,
                  ("mesh", "make_cartesian_3d_tet"), make_nc="make_nc_tet")
    nc = ts[-1][0]
    assert nc.n_hanging > 0 and len(nc.tri_face_constraints) > 0
    assert not nctet._overrefined_edges(nc.mesh)
    p = nc.mesh.vertices[nc.mesh.elements]
    assert (np.linalg.det(p[:, 1:] - p[:, :1]) > 0).all()


def test_point_index_zero_signs_and_duplicates():
    """Position lookups read −0.0 as +0.0 (as tuple keys do) and pick the
    first or last of equal rows as the dicts they replace."""
    P = np.array([[0.0, 1.0], [-0.0, 1.0], [0.5, 0.5]])
    first = ncmesh._PointIndex(P, first=True)
    last = ncmesh._PointIndex(P, first=False)
    Q = np.array([[-0.0, 1.0], [0.5, 0.5], [0.25, 0.5]])
    assert first.lookup(Q).tolist() == [0, 2, -1]
    assert last.lookup(Q).tolist() == [1, 2, -1]
    d = {}
    for i, p in enumerate(P):
        d.setdefault(tuple(p), i)
    assert [d.get(tuple(q), -1) for q in Q] == first.lookup(Q).tolist()
