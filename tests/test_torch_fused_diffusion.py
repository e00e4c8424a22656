"""The fused diffusion apply's plain version (``ops/fused_diffusion.py``)
against the JAX package, on the CPU: against ``diffusion_apply_pallas`` in
Pallas interpret mode on that kernel's own test inputs (4³ lattice, orders
1-3, float32, at most 1e-5·max|y|, the JAX test's bound), and against JAX's
``diffusion.apply`` in float64 at 1e-12; CPU tensors take the plain version
and launch nothing; the kernel's shape checks."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import geom_factors as jgfm
from cardiac_ablation_ecm2_tpu.fem import quadinterp as jqi
from cardiac_ablation_ecm2_tpu.fem.basis import make_dof_to_quad as jd2q
from cardiac_ablation_ecm2_tpu.fem.fespace import element_node_coords
from cardiac_ablation_ecm2_tpu.fem.geometry import Geometry as JGeometry
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_hex_mesh as jmake
from cardiac_ablation_ecm2_tpu.mesh.mesh import make_cartesian_3d as jcart
from cardiac_ablation_ecm2_tpu.ops import diffusion as jdiff
from cardiac_ablation_ecm2_tpu.ops.pallas_kernels import diffusion_apply_pallas
from cardiac_ablation_ecm2_tpu_torch.fem import quadinterp as tqi
from cardiac_ablation_ecm2_tpu_torch.fem.basis import make_dof_to_quad as td2q
from cardiac_ablation_ecm2_tpu_torch.fem.geometry import Geometry
from cardiac_ablation_ecm2_tpu_torch.ops import diffusion as tdiff
from cardiac_ablation_ecm2_tpu_torch.ops import fused_diffusion as fd


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(mesh, p, nq1d, coeff, dtype):
    """(JAX basis, port basis, packed qdata) of ``mesh`` in ``dtype``; the
    qdata is computed once by the JAX package in float64."""
    X = element_node_coords(mesh, p)
    jd = jd2q(JGeometry.CUBE, p, nq1d)
    gf = jgfm.compute_geometric_factors(X, jd, "float64")
    qd = np.asarray(jdiff.setup_packed(gf, coeff)).astype(dtype)
    jdb = jqi.device_basis(jd, str(np.dtype(dtype)))
    tdb = tqi.device_basis(td2q(Geometry.CUBE, p, nq1d), str(np.dtype(dtype)),
                           "cpu")
    return jdb, tdb, qd


@pytest.mark.parametrize("p,coeff,block,seed", [
    (1, 1.3, 16, 0), (2, 1.3, 16, 0), (3, 1.3, 16, 0),
    (2, "variable", 32, 1)])
def test_plain_matches_pallas_interpret(p, coeff, block, seed):
    """The inputs of ``tests/test_pallas_kernels.py``: a 4³ unit lattice,
    nq1d = p + 2, uniform or 1 + x·y conductivity, e uniform in [0, 1)."""
    mesh = jcart(4, 4, 4)
    if coeff == "variable":
        coeff = lambda x: 1.0 + x[..., 0] * x[..., 1]   # noqa: E731
    jdb, tdb, qd = _case(mesh, p, p + 2, coeff, np.float32)
    e = np.random.default_rng(seed).random((mesh.ne, (p + 1) ** 3)).astype(np.float32)
    ref = np.asarray(diffusion_apply_pallas(jdb, jnp.asarray(qd), jnp.asarray(e),
                                            block=block, interpret=True))
    before = fd.diffusion_apply.launches
    y = fd.diffusion_apply(tdb, torch.from_numpy(qd), torch.from_numpy(e))
    assert fd.diffusion_apply.launches == before
    assert y.dtype == torch.float32 and y.shape == e.shape
    assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@functools.lru_cache(maxsize=None)
def _warped_case(p, extra):
    """``_case`` on the n=4 cardiac hex mesh, shared by both layouts."""
    L = 0.04
    mesh = jmake(4, lengths=(L, L, L / 2), electrode_radius=0.004)
    return mesh, *_case(mesh, p, p + 1 + extra, 0.54, np.float64)


@pytest.mark.parametrize("p,extra", [(1, 0), (2, 0), (2, 1), (3, 1), (4, 0)])
@pytest.mark.parametrize("collapsed", [False, True])
def test_plain_matches_jax_apply_f64(p, extra, collapsed):
    """Warped cardiac hexes in float64, also with one element's qdata
    broadcast to all (the collapsed layout)."""
    mesh, jdb, tdb, qd = _warped_case(p, extra)
    if collapsed:
        qd = np.ascontiguousarray(qd[:, :1])
    e = np.random.default_rng(p).standard_normal((mesh.ne, (p + 1) ** 3))
    ref = np.asarray(jdiff.apply(jdb, jnp.asarray(qd), jnp.asarray(e)))
    y = tdiff.apply(tdb, torch.from_numpy(qd), torch.from_numpy(e))
    assert np.abs(y.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    assert torch.equal(y, fd.diffusion_apply_plain(tdb, torch.from_numpy(qd),
                                                   torch.from_numpy(e)))


def _basis(n1, nq1, dtype=torch.float32):
    return tqi.device_basis(td2q(Geometry.CUBE, n1 - 1, nq1), dtype, "cpu")


@pytest.mark.parametrize("bad", ["order5", "nq1", "e_width", "q_elems",
                                 "q_planes", "dtype", "q_dtype", "tet"])
def test_kernel_shape_checks(bad):
    n1, nq1, ne = 3, 3, 5
    db = _basis(n1, nq1)
    e = torch.zeros(ne, n1 ** 3)
    q = torch.zeros(6, ne, nq1 ** 3)
    fd._check(db, q, e)
    fd._check(db, q[:, :1], e)
    if bad == "order5":
        db, e, q = _basis(6, 6), torch.zeros(ne, 216), torch.zeros(6, ne, 216)
    elif bad == "nq1":
        db, q = _basis(3, 5), torch.zeros(6, ne, 125)
    elif bad == "e_width":
        e = torch.zeros(ne, 8)
    elif bad == "q_elems":
        q = torch.zeros(6, ne + 1, 27)
    elif bad == "q_planes":
        q = torch.zeros(3, ne, 27)
    elif bad == "dtype":
        e = e.half()
    elif bad == "q_dtype":
        q = q.double()
    else:
        db = tqi.device_basis(td2q(Geometry.TETRAHEDRON, 2, 3), None, "cpu")
    with pytest.raises(ValueError):
        fd._check(db, q, e)
