"""The port's multi-domain pieces against the JAX package, float64 on the
CPU: ``mesh/submesh`` (domain and boundary submeshes of quad, triangle,
hex and tet meshes, their tables bitwise, the transfer maps bitwise at
orders 1–3, ``to_sub`` / ``to_parent`` bitwise), ``mesh/trim`` (bitwise,
the custom map, 3D and the ``untagged`` rule), ``ops/linearform.delta_lf``
(within 1e-14), ``mesh/particles`` (within 1e-12) and the multidomain
driver: ``examples/multidomain_heat.main`` at ``-n 4 -s 3 --x64 --cpu``
against the root ``examples/multidomain_heat.py`` run with the same
arguments in a subprocess (started with the module, so it runs beside the
other cases; its every transferred field recorded), with the same printed
lines, equal CG counts and each step's fields and maxima within 1e-9 of
max|u| (``FIELD_TOL``: the driver's CG tolerance, 1e-10, bounds how
closely two round-off-different runs agree)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.examples import multidomain_heat
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.mesh import submesh
from cardiac_ablation_ecm2_tpu_torch.mesh.particles import ParticleSet
from cardiac_ablation_ecm2_tpu_torch.mesh.trim import trim
from cardiac_ablation_ecm2_tpu_torch.ops.linearform import delta_lf

ROOT = pathlib.Path(__file__).resolve().parents[1]
DRIVER_ARGS = ["-n", "4", "-s", "3", "--x64", "--cpu"]
#: the driver's CG stops at rel_tol 1e-10, so two runs whose applies differ
#: in round-off end up to ~1e-10 of max|u| apart (measured: 3.7e-11 to
#: 1.8e-10 on the six fields, the maxima 1.9e-11 to 1.3e-10); the fields
#: and their maxima are held to 1e-9 of max|u|, not the 1e-12 a solve to
#: round-off would allow
FIELD_TOL = 1e-9
MESH_FIELDS = ("vertices", "elements", "attributes", "boundary", "bdr_attributes")

#: the root driver, its transferred fields recorded (Tc, then Tt, each step)
_ROOT_RUN = """
import runpy, sys
import numpy as np
from cardiac_ablation_ecm2_tpu.mesh import submesh
fields = []
to_parent = submesh.TransferMap.to_parent
def recording(self, u_sub, u_parent):
    fields.append(np.asarray(u_sub))
    return to_parent(self, u_sub, u_parent)
submesh.TransferMap.to_parent = recording
out = sys.argv[1]
sys.argv = ["multidomain_heat.py"] + sys.argv[2:]
sys.path.insert(0, ".")
runpy.run_path("multidomain_heat.py", run_name="__main__")
np.savez(out, *fields)
"""

_ROOT = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_root_driver(tmp_path_factory):
    """One torch thread (restored after the module), and the root driver
    started in a subprocess, which the last case waits for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("root_driver") / "fields.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               CAX_COMPILE_CACHE="0")
    _ROOT["out"] = out
    _ROOT["proc"] = subprocess.Popen(
        [sys.executable, "-c", _ROOT_RUN, str(out)] + DRIVER_ARGS,
        cwd=ROOT / "examples", env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield
    if _ROOT["proc"].poll() is None:
        _ROOT["proc"].kill()
        _ROOT["proc"].wait()
    torch.set_num_threads(n)


def _with_attrs(m, mod, attrs):
    return mod.Mesh(geom=m.geom, vertices=m.vertices, elements=m.elements,
                    attributes=attrs, boundary=m.boundary,
                    bdr_attributes=m.bdr_attributes)


def two_material(kind, mod=tmesh):
    """``tests/test_submesh.py``'s two-material meshes (x < ½ attribute 1,
    else 2), in ``mod``'s package."""
    m = {"quad": lambda: mod.make_cartesian_2d(4, 4),
         "tri": lambda: mod.make_cartesian_2d_tri(4, 3),
         "hex": lambda: mod.make_cartesian_3d(3, 3, 3),
         "tet": lambda: mod.make_cartesian_3d_tet(2, 2, 2)}[kind]()
    cent = m.vertices[m.elements].mean(axis=1)
    return _with_attrs(m, mod, np.where(cent[:, 0] < 0.5, 1, 2))


def jax_mod():
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh

    return jmesh


def assert_mesh_equal(a, b):
    assert a.geom == b.geom
    for f in MESH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


CASES = [("quad", "domain", [1]), ("quad", "domain", [2]), ("tri", "domain", [2]),
         ("hex", "domain", [1]), ("tet", "domain", [2]), ("quad", "boundary", [1, 3]),
         ("hex", "boundary", [6]), ("tet", "boundary", [1])]


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("kind,how,attrs", CASES)
def test_submesh_tables_and_transfers_bitwise(kind, how, attrs, p):
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.mesh import submesh as jsub

    tp, jp = two_material(kind), two_material(kind, jax_mod())
    make = {"domain": "create_from_domain", "boundary": "create_from_boundary"}[how]
    ts, js = getattr(submesh, make)(tp, attrs), getattr(jsub, make)(jp, attrs)
    assert_mesh_equal(ts.mesh, js.mesh)
    assert np.array_equal(ts.parent_elems, js.parent_elems)
    assert ts.from_boundary == js.from_boundary
    if how == "domain":
        assert (ts.mesh.bdr_attributes == jp.bdr_attributes.max() + 1).any()

    tf, sf = FESpace(tp, p), FESpace(ts.mesh, p)
    jf, jsf = JFESpace(jp, p), JFESpace(js.mesh, p)
    tm = submesh.create_transfer_map(tf, sf, ts, device="cpu")
    jm = jsub.create_transfer_map(jf, jsf, js)
    assert np.array_equal(tm.sub_to_parent, np.asarray(jm.sub_to_parent))

    rng = np.random.default_rng(p)
    up, us = rng.standard_normal(tf.ndof), rng.standard_normal(sf.ndof)
    got = tm.to_sub(torch.as_tensor(up))
    assert np.array_equal(got.numpy(), np.asarray(jm.to_sub(jnp.asarray(up))))
    got = tm.to_parent(torch.as_tensor(us), torch.as_tensor(up))
    want = np.asarray(jm.to_parent(jnp.asarray(us), jnp.asarray(up)))
    assert np.array_equal(got.numpy(), want)
    # the port's maps on the JAX map's table give the same bits
    tj = submesh.TransferMap(np.asarray(jm.sub_to_parent), device="cpu")
    assert torch.equal(tj.to_sub(torch.as_tensor(up)), tm.to_sub(torch.as_tensor(up)))
    # and a port SubMesh made of the JAX one's arrays gives the same map
    sj = submesh.SubMesh(mesh=tmesh.Mesh(geom=js.mesh.geom, **{
        f: getattr(js.mesh, f) for f in MESH_FIELDS}), parent=tp,
        parent_elems=np.asarray(js.parent_elems), from_boundary=js.from_boundary)
    assert np.array_equal(submesh.create_transfer_map(
        tf, FESpace(sj.mesh, p), sj, device="cpu").sub_to_parent, tm.sub_to_parent)


def _partial_boundary(mod):
    """A hex mesh whose boundary lists only attributes 1 and 2 (bmax 2), so
    trimming attribute 1 maps it to 3 and the unlisted exterior faces take
    the ``untagged`` attribute 4."""
    m = two_material("hex", mod)
    keep = np.isin(m.bdr_attributes, [1, 2])
    return mod.Mesh(geom=m.geom, vertices=m.vertices, elements=m.elements,
                    attributes=m.attributes, boundary=m.boundary[keep],
                    bdr_attributes=m.bdr_attributes[keep])


TRIMS = [("quad", [2], None), ("hex4", [1], {1: 99}), ("tet", [1], None),
         ("partial", [1], None), ("hex", [7], None)]


@pytest.mark.parametrize("kind,attrs,amap", TRIMS)
def test_trim_bitwise(kind, attrs, amap):
    from cardiac_ablation_ecm2_tpu.mesh.trim import trim as jtrim

    def make(mod):
        if kind == "hex4":
            m = mod.make_cartesian_3d(4, 2, 2)
            cent = m.vertices[m.elements].mean(axis=1)
            return _with_attrs(m, mod, np.where(cent[:, 0] < 0.5, 1, 2))
        if kind == "partial":
            return _partial_boundary(mod)
        return two_material(kind, mod)

    tp, jp = make(tmesh), make(jax_mod())
    got, want = trim(tp, attrs, amap), jtrim(jp, attrs, amap)
    if kind == "hex":                  # nothing to trim: the mesh itself
        assert got is tp and want is jp
        return
    assert_mesh_equal(got, want)
    if kind == "partial":
        assert set(got.bdr_attributes.tolist()) >= {2, 3, 4}


@pytest.mark.parametrize("dim", [2, 3])
def test_delta_lf_equals_jax(dim):
    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.ops.linearform import delta_lf as jdelta_lf

    if dim == 2:
        tm_, jm_ = tmesh.make_cartesian_2d(4, 4), jax_mod().make_cartesian_2d(4, 4)
        pts = [[0.33, 0.61], [0.9, 0.1], [5.0, 5.0]]          # last outside
    else:
        tm_ = tmesh.make_cartesian_3d(3, 3, 2)
        jm_ = jax_mod().make_cartesian_3d(3, 3, 2)
        pts = [[0.2, 0.7, 0.4], [0.5, 0.5, 0.5], [0.9, 0.05, 0.95], [1.5, 0.2, 0.2]]
    s = [2.5, -1.0, 7.0, 0.3][: len(pts)]
    got = delta_lf(FESpace(tm_, 3), pts, s, dtype="float64", device="cpu")
    want = np.asarray(jdelta_lf(JFESpace(jm_, 3), pts, s))
    assert np.abs(got.numpy() - want).max() <= 1e-14 * np.abs(want).max()
    one = delta_lf(FESpace(tm_, 2), pts[:2], dtype="float64", device="cpu")
    assert abs(float(one.sum()) - 2.0) <= 1e-13          # partition of unity


def test_particles_equal_jax():
    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.mesh.particles import ParticleSet as JParticleSet

    from cardiac_ablation_ecm2_tpu_torch.parallel.partition import partition_mesh

    tm_, jm_ = tmesh.make_cartesian_2d(8, 8), jax_mod().make_cartesian_2d(8, 8)
    tf, jf = FESpace(tm_, 2), JFESpace(jm_, 2)
    X = tf.dof_coords
    uvec = np.concatenate([-(X[:, 1] - 0.5), X[:, 0] - 0.5])   # rotation
    u = X[:, 0] ** 2 + 2 * X[:, 1]
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.random((20, 2)) * 0.98 + 0.01, [[0.75, 0.5], [5.0, 5.0]]])
    tp, jp = ParticleSet(positions=pts.copy()), JParticleSet(positions=pts.copy())
    for a, b in zip(tp.locate(tm_), jp.locate(jm_)):
        assert np.array_equal(a, b)
    vals = tp.interpolate(tf, torch.as_tensor(u), name="u")
    assert np.abs(vals - jp.interpolate(jf, u, name="u")).max() <= 1e-12
    assert np.array_equal(tp.fields["u"], vals)
    tp.advect(tf, torch.as_tensor(uvec), dt=0.05, steps=10, clamp=(0.01, 0.99))
    jp.advect(jf, uvec, dt=0.05, steps=10, clamp=(0.01, 0.99))
    assert np.abs(tp.positions - jp.positions).max() <= 1e-12
    assert np.linalg.norm(tp.positions - pts, axis=1)[:20].min() > 0.01
    parts = partition_mesh(tm_, 4)
    for positions in (pts, tp.positions):        # before and after: one escaped
        pid = ParticleSet(positions=positions).assign_partitions(tm_, parts)
        want = JParticleSet(positions=positions).assign_partitions(jm_, parts)
        assert np.array_equal(pid, want)
    assert pid[-1] >= 0 and ParticleSet(positions=pts).assign_partitions(tm_, parts)[-1] == -1


def test_multidomain_driver_equals_root_driver(capsys, monkeypatch):
    fields = []
    to_parent = submesh.TransferMap.to_parent

    def recording(self, u_sub, u_parent):
        fields.append(u_sub.numpy().copy())
        return to_parent(self, u_sub, u_parent)

    monkeypatch.setattr(submesh.TransferMap, "to_parent", recording)
    multidomain_heat.main(DRIVER_ARGS)
    lines = capsys.readouterr().out.strip().splitlines()

    proc = _ROOT["proc"]
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    want = out.strip().splitlines()
    assert lines == want, (lines, want)
    with np.load(_ROOT["out"]) as f:
        ref = [f[f"arr_{i}"] for i in range(len(f.files))]
    assert len(fields) == len(ref) == 6
    for got, exp in zip(fields, ref):
        assert got.shape == exp.shape
        assert np.abs(got - exp).max() <= FIELD_TOL * np.abs(exp).max()
        assert abs(got.max() - exp.max()) <= FIELD_TOL * abs(exp.max())


@pytest.mark.parametrize("fn", ["create_from_domain", "trim"])
def test_mixed_arity_parents_raise(fn):
    """A prism parent (triangle and quad faces): the JAX package's face
    lists come out ragged and ``np.array`` raises ``ValueError``; the port
    raises ``NotImplementedError`` naming the mixed arity (ROADMAP Queue 3)."""
    from cardiac_ablation_ecm2_tpu.mesh import submesh as jsub
    from cardiac_ablation_ecm2_tpu.mesh.trim import trim as jtrim

    def make(mod):
        m = mod.make_cartesian_3d_prism(2, 2, 2)
        return _with_attrs(m, mod, np.arange(m.ne) % 2 + 1)

    jfn = jsub.create_from_domain if fn == "create_from_domain" else jtrim
    tfn = submesh.create_from_domain if fn == "create_from_domain" else trim
    with pytest.raises(ValueError):
        jfn(make(jax_mod()), [1])
    with pytest.raises(NotImplementedError, match="mixed arity"):
        tfn(make(tmesh), [1])
