"""Device-side setup and applies of the PyTorch port against the JAX package,
float64 on the CPU, rtol 1e-12 (both sides compute the same formulas; only
the summation order inside the contractions differs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import geom_factors as jgfm
from cardiac_ablation_ecm2_tpu.fem import quadinterp as jqi
from cardiac_ablation_ecm2_tpu.fem.basis import make_dof_to_quad as jd2q
from cardiac_ablation_ecm2_tpu.fem.fespace import element_node_coords
from cardiac_ablation_ecm2_tpu.fem.geometry import Geometry as JGeometry
from cardiac_ablation_ecm2_tpu.linalg import solvers as jsol
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_hex_mesh as jmake
from cardiac_ablation_ecm2_tpu.mesh.mesh import make_cartesian_3d as jcart
from cardiac_ablation_ecm2_tpu.ops import diffusion as jdiff
from cardiac_ablation_ecm2_tpu.ops import lanemajor as jlm
from cardiac_ablation_ecm2_tpu.ops import mass as jmass
from cardiac_ablation_ecm2_tpu_torch.fem import geom_factors as tgfm
from cardiac_ablation_ecm2_tpu_torch.fem import quadinterp as tqi
from cardiac_ablation_ecm2_tpu_torch.fem.basis import make_dof_to_quad as td2q
from cardiac_ablation_ecm2_tpu_torch.fem.coefficient import eval_coeff
from cardiac_ablation_ecm2_tpu_torch.fem.geometry import Geometry
from cardiac_ablation_ecm2_tpu_torch.linalg import solvers as tsol
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
from cardiac_ablation_ecm2_tpu_torch.ops import diffusion as tdiff
from cardiac_ablation_ecm2_tpu_torch.ops import lanemajor as tlm
from cardiac_ablation_ecm2_tpu_torch.ops import mass as tmass

L = 0.04
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


def _setup(kind, p=2, nq1d=3):
    """(JAX gf, port gf, JAX basis, port basis) on one mesh."""
    jm = (jmake(4, lengths=(L, L, L / 2), electrode_radius=0.004)
          if kind == "cardiac" else jcart(3, 2, 2, L, L, L / 2))
    X = element_node_coords(jm, p)
    jd, td = jd2q(JGeometry.CUBE, p, nq1d), td2q(Geometry.CUBE, p, nq1d)
    jgf = jgfm.compute_geometric_factors(X, jd, "float64")
    tgf = tgfm.compute_geometric_factors(X, td, "float64", "cpu")
    return (jgf, tgf, jqi.device_basis(jd, "float64"),
            tqi.device_basis(td, "float64", "cpu"))


@pytest.mark.parametrize("kind", ["cardiac", "cartesian"])
def test_geometric_factors(kind):
    jgf, tgf, _, _ = _setup(kind)
    close(tgf.x, jgf.x)
    close(tgf.jac, jgf.jac)
    close(tgf.det, jgf.det)
    close(tgf.wdet, jgf.wdet)
    close(tgfm.adjugate(tgf.jac), jgfm.adjugate(jgf.jac))


def test_affine_element_jacobians_none_for_hexes():
    jm = jmake(4, lengths=(L, L, L / 2), electrode_radius=0.004)
    tm = make_cardiac_hex_mesh(4, lengths=(L, L, L / 2), electrode_radius=0.004)
    assert jgfm.affine_element_jacobians(jm) is None
    assert tgfm.affine_element_jacobians(tm) is None


@pytest.mark.parametrize("kind", ["cardiac", "cartesian"])
def test_qdata_and_diagonals(kind):
    jgf, tgf, jdb, tdb = _setup(kind)
    ctr = (L / 2,) * 3
    jsrc = lambda x: 2e7 * jnp.exp(-sum((x[..., i] - ctr[i]) ** 2 for i in range(3)) / 1.8e-5)
    tsrc = lambda x: 2e7 * torch.exp(-sum((x[..., i] - ctr[i]) ** 2 for i in range(3)) / 1.8e-5)
    close(eval_coeff(tsrc, tgf), jsrc(jgf.x))
    jk = jnp.broadcast_to(jnp.asarray(0.54), jgf.det.shape)
    tk = eval_coeff(0.54, tgf)
    jqm, tqm = jmass.setup(jgf, jk), tmass.setup(tgf, tk)
    close(tqm, jqm)
    jqk = jdiff.setup_packed(jgf, jk)
    tqk = tdiff.setup_packed(tgf, tk)
    close(tqk, jqk)
    close(tdiff.pack_sym(tdiff.setup(tgf, tk)),
          jdiff.pack_sym(jdiff.setup(jgf, jk)))
    close(tmass.diagonal(tdb, tqm), jmass.diagonal(jdb, jqm))
    close(tdiff.diagonal(tdb, tqk), jdiff.diagonal(jdb, jqk))


@pytest.mark.parametrize("kind", ["cardiac", "cartesian"])
def test_element_major_applies(kind):
    jgf, tgf, jdb, tdb = _setup(kind)
    rng = np.random.default_rng(7)
    ne, nq = np.asarray(jgf.det).shape
    e = rng.standard_normal((ne, 27))
    q = rng.standard_normal((ne, nq))
    close(tqi.eval_values_t(tdb, torch.from_numpy(q)), jqi.eval_values_t(jdb, q))
    close(tqi.eval_values(tdb, torch.from_numpy(e)), jqi.eval_values(jdb, e))
    close(tqi.eval_grad(tdb, torch.from_numpy(e)), jqi.eval_grad(jdb, e))
    g = rng.standard_normal((ne, nq, 3))
    close(tqi.eval_grad_t(tdb, torch.from_numpy(g)), jqi.eval_grad_t(jdb, g))
    jqm, tqm = jmass.setup(jgf, 3.6e6), tmass.setup(tgf, 3.6e6)
    close(tmass.apply(tdb, tqm, torch.from_numpy(e)), jmass.apply(jdb, jqm, e))
    jqk = jdiff.setup_packed(jgf, 0.54)
    tqk = tdiff.setup_packed(tgf, 0.54)
    close(tdiff.apply(tdb, tqk, torch.from_numpy(e)), jdiff.apply(jdb, jqk, e))


@pytest.mark.parametrize("kind", ["cardiac", "cartesian"])
def test_lane_major_apply_and_affine_branch(kind):
    jgf, tgf, jdb, tdb = _setup(kind)
    rng = np.random.default_rng(11)
    ne = np.asarray(jgf.det).shape[0]
    eT = rng.standard_normal((27, ne))
    jqmT = jmass.setup(jgf, 3.6e6).T
    tqmT = tmass.setup(tgf, 3.6e6).T.contiguous()
    jqkT = jlm.diffusion_qT(jdiff.setup_packed(jgf, 0.54))
    tqkT = tlm.diffusion_qT(tdiff.setup_packed(tgf, 0.54))
    jlb, tlb = jlm.lane_basis(jdb), tlm.lane_basis(tdb)
    close(tlb.S, jlb.S)
    gamma = 0.1089666
    close(tlm.mass_diffusion_apply(tlb, tqmT, tqkT, torch.from_numpy(eT), gamma),
          jlm.mass_diffusion_apply(jlb, jqmT, jqkT, eT, gamma))

    # the affine detector takes the same branch: warped hexes never
    # separate, lattice hexes always do
    jdk = jlm.separable_collapse(jqkT, jdb.W)
    tdk = tlm.separable_collapse(tqkT, tdb.W)
    jdm = jlm.separable_collapse(jqmT, jdb.W)
    tdm = tlm.separable_collapse(tqmT, tdb.W)
    assert (jdk is None) == (tdk is None) == (kind == "cardiac")
    assert (jdm is None) == (tdm is None) == (kind == "cardiac")
    if kind == "cartesian":
        close(tdk, jdk)
        close(tdm, jdm)
        jaf, taf = jlm.affine_ops(jdb), tlm.affine_ops(tdb, tlb)
        close(taf.Mhat, jaf.Mhat)
        for a, b in zip(taf.Khat, jaf.Khat):
            close(a, b)
        close(tlm.affine_mass_diffusion_apply(taf, tdm, tdk, torch.from_numpy(eT),
                                              gamma),
              jlm.affine_mass_diffusion_apply(jaf, jdm, jdk, eT, gamma))


def test_cg_matches_jax():
    """Same iterates and iteration count as the JAX CG on an SPD system,
    with a Jacobi preconditioner, an initial guess and an absolute floor."""
    rng = np.random.default_rng(5)
    Q = rng.standard_normal((60, 60))
    A = Q @ Q.T + 60 * np.eye(60)
    b = rng.standard_normal(60)
    x0 = 0.1 * rng.standard_normal(60)
    inv = 1.0 / np.diag(A)
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    jx, jinfo = jsol.cg(lambda v: jA @ v, jnp.asarray(b), x0=jnp.asarray(x0),
                        M=lambda r: inv * r, rel_tol=1e-9, abs_tol=1e-14,
                        max_iter=200)
    tinv = torch.from_numpy(inv)
    tx, tinfo = tsol.cg(lambda v: tA @ v, torch.from_numpy(b),
                        x0=torch.from_numpy(x0), M=lambda r: tinv * r,
                        rel_tol=1e-9, abs_tol=1e-14, max_iter=200)
    assert tinfo.iterations == int(jinfo.iterations)
    assert tinfo.converged and bool(jinfo.converged)
    close(tx, jx, rtol=1e-10)


def test_default_dot_accumulates_f32_in_f64():
    rng = np.random.default_rng(6)
    x = rng.standard_normal(100_000).astype(np.float32)
    y = rng.standard_normal(100_000).astype(np.float32)
    d = tsol.default_dot(torch.from_numpy(x), torch.from_numpy(y))
    assert d.dtype == torch.float32
    assert d.item() == np.float32(np.dot(x.astype(np.float64), y.astype(np.float64)))
