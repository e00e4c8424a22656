"""The PyTorch port's simplex pieces against the JAX package on the cardiac
tet mesh: host copies equal exactly (mesh, rules, bases, dof numbering,
essential dofs, node coordinates); device setup in float64 on the CPU at
rtol 1e-12 (geometric factors, mass and diffusion qdata, element
diagonals, the partial-assembly operator's applies).  Also: every port
entry point that allocates on a device runs on the card unless told
otherwise, so with no device and no GPU it raises."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cardiac_ablation_ecm2_tpu.fem import basis as jbasis
from cardiac_ablation_ecm2_tpu.fem import geom_factors as jgfm
from cardiac_ablation_ecm2_tpu.fem import intrules as jrules
from cardiac_ablation_ecm2_tpu.fem import quadinterp as jqi
from cardiac_ablation_ecm2_tpu.fem.fespace import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.fem.fespace import element_node_coords as jenc
from cardiac_ablation_ecm2_tpu.fem.geometry import Geometry as JGeometry
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_tet_mesh as jmake
from cardiac_ablation_ecm2_tpu.models import bioheat as jbio
from cardiac_ablation_ecm2_tpu.ops import diffusion as jdiff
from cardiac_ablation_ecm2_tpu.ops import mass as jmass
from cardiac_ablation_ecm2_tpu_torch.benchmarks import bp
from cardiac_ablation_ecm2_tpu_torch.fem import basis as tbasis
from cardiac_ablation_ecm2_tpu_torch.fem import build as tbuild
from cardiac_ablation_ecm2_tpu_torch.fem import geom_factors as tgfm
from cardiac_ablation_ecm2_tpu_torch.fem import intrules as trules
from cardiac_ablation_ecm2_tpu_torch.fem import quadinterp as tqi
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import element_node_coords
from cardiac_ablation_ecm2_tpu_torch.fem.geometry import Geometry
from cardiac_ablation_ecm2_tpu_torch.fem.restriction import ElementRestriction
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_tet_mesh
from cardiac_ablation_ecm2_tpu_torch.models import elasticity as telasticity
from cardiac_ablation_ecm2_tpu_torch.models.bioheat import BioheatOperator
from cardiac_ablation_ecm2_tpu_torch.ops import diffusion as tdiff
from cardiac_ablation_ecm2_tpu_torch.ops import mass as tmass
from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
from cardiac_ablation_ecm2_tpu_torch.ops import linearform as tlf
from cardiac_ablation_ecm2_tpu_torch.ops.ell import (
    ELLOperator,
    MultiELLOperator,
    MultiELLPair,
)

L = 0.04
KW = dict(lengths=(L, L, L / 2), electrode_radius=0.004)
_MESH_FIELDS = ("vertices", "elements", "attributes", "boundary",
                "bdr_attributes")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


@pytest.mark.parametrize("n", [4, 9])
def test_tet_mesh_equals_jax(n):
    jm, tm = jmake(n, **KW), make_cardiac_tet_mesh(n, **KW)
    assert tm.geom == Geometry.TETRAHEDRON
    for f in _MESH_FIELDS:
        assert np.array_equal(getattr(jm, f), getattr(tm, f)), f
    assert set(np.unique(tm.bdr_attributes)) == {1, 2, 3}


@pytest.mark.parametrize("p", [1, 2])
def test_tet_space_equals_jax(p):
    jfes, tfes = JFESpace(jmake(6, **KW), p), FESpace(make_cardiac_tet_mesh(6, **KW), p)
    assert tfes.ndof == jfes.ndof
    assert np.array_equal(tfes.gather_map, jfes.gather_map)
    assert np.array_equal(tfes.bdr_gather_map, jfes.bdr_gather_map)
    for marker in ([1, 2, 3, 4, 5, 6], [2]):
        assert np.array_equal(tfes.essential_dofs(marker),
                              jfes.essential_dofs(marker))
    assert np.array_equal(element_node_coords(tfes.mesh, p),
                          jenc(jfes.mesh, p))


@pytest.mark.parametrize("dim,order", [(2, 3), (3, 3), (3, 5), (3, 7)])
def test_simplex_rule_equals_jax(dim, order):
    jp, jw = jrules.simplex_rule(dim, order)
    tp, tw = trules.simplex_rule(dim, order)
    assert np.array_equal(tp, jp) and np.array_equal(tw, jw)
    assert np.isclose(tw.sum(), 0.5 if dim == 2 else 1.0 / 6.0)


@pytest.mark.parametrize("p,nq1d", [(1, 2), (2, 3), (3, 4)])
def test_simplex_basis_equals_jax(p, nq1d):
    jd = jbasis.make_dof_to_quad(JGeometry.TETRAHEDRON, p, nq1d)
    td = tbasis.make_dof_to_quad(Geometry.TETRAHEDRON, p, nq1d)
    assert not td.tensor
    assert np.array_equal(tbasis.lattice_multi_index(Geometry.TETRAHEDRON, p),
                          jbasis.lattice_multi_index(JGeometry.TETRAHEDRON, p))
    assert np.array_equal(tbasis.h1_nodes(Geometry.TETRAHEDRON, p),
                          jbasis.h1_nodes(JGeometry.TETRAHEDRON, p))
    for f in ("points", "weights", "B", "G"):
        assert np.array_equal(getattr(td, f), getattr(jd, f)), f
    # order 2 with quad_extra 0 (bench.py): 27 points, 10 dofs
    if p == 2:
        assert td.B.shape == (27, 10) and td.G.shape == (27, 10, 3)


def _setup():
    X = jenc(jmake(5, **KW), 2)
    jd = jbasis.make_dof_to_quad(JGeometry.TETRAHEDRON, 2, 3)
    td = tbasis.make_dof_to_quad(Geometry.TETRAHEDRON, 2, 3)
    jgf = jgfm.compute_geometric_factors(X, jd, "float64")
    tgf = tgfm.compute_geometric_factors(X, td, "float64", "cpu")
    return (jgf, tgf, jqi.device_basis(jd, "float64"),
            tqi.device_basis(td, "float64", "cpu"))


def test_tet_geometric_factors_and_qdata():
    jgf, tgf, jdb, tdb = _setup()
    for f in ("x", "jac", "det", "wdet"):
        close(getattr(tgf, f), getattr(jgf, f))
    rng = np.random.default_rng(0)
    c = rng.uniform(0.5, 2.0, tgf.det.shape)
    close(tmass.setup(tgf, torch.as_tensor(c)), jmass.setup(jgf, c))
    close(tdiff.setup(tgf, torch.as_tensor(c)), jdiff.setup(jgf, c))
    close(tdiff.setup_packed(tgf, torch.as_tensor(c)),
          jdiff.setup_packed(jgf, c))


def test_tet_dense_applies_and_diagonals():
    jgf, tgf, jdb, tdb = _setup()
    qm = tmass.setup(tgf)
    qk = tdiff.setup_packed(tgf)
    close(tmass.diagonal(tdb, qm), jmass.diagonal(jdb, np.asarray(qm)))
    close(tdiff.diagonal(tdb, qk), jdiff.diagonal(jdb, np.asarray(qk)))
    u = np.random.default_rng(1).standard_normal(tgf.det.shape[:1] + (10,))
    tu = torch.as_tensor(u)
    close(tqi.eval_values_t(tdb, tqi.eval_values(tdb, tu)),
          jqi.eval_values_t(jdb, jqi.eval_values(jdb, u)))
    close(tqi.eval_grad_t(tdb, tqi.eval_grad(tdb, tu)),
          jqi.eval_grad_t(jdb, jqi.eval_grad(jdb, u)))


def test_tet_operator_without_ell_matches_jax():
    """The partial-assembly tet operator (no ``assembled_apply``): the
    affine path in both packages, its stage apply, residual and M_ρc apply
    on one vector to 1e-12 (``tests/test_torch_tet_pa.py`` runs its steps)."""
    params = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, ess_bdr=[1, 2, 3],
                  q_met=1e6, dtype="float64")
    jop = jbio.BioheatOperator(fes=JFESpace(jmake(4, **KW), 2), **params)
    top = BioheatOperator(FESpace(make_cardiac_tet_mesh(4, **KW), 2),
                          device="cpu", **params)
    assert top._ell is None and top._aff is not None and jop._aff is not None
    v = np.random.default_rng(2).standard_normal(jop.fes.ndof)
    tv = torch.as_tensor(v)
    close(top._stage_apply(0.1)(tv), jop._implicit_lhs_apply(0.1, v))
    close(top.residual(tv), jop.residual(v))
    close(top._Mrc_apply(tv), jop._Mrc_apply(v))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")


_ENTRY_POINTS = {
    "BioheatOperator": lambda fes: BioheatOperator(fes, dtype="float64",
                                                   assembled_apply="ell"),
    "ElementRestriction": lambda fes: ElementRestriction(fes.gather_map,
                                                         fes.ndof),
    "restriction_for": lambda fes: tbuild.restriction_for(fes),
    "basis_for": lambda fes: tbuild.basis_for(fes, "float64"),
    "device_basis": lambda fes: tqi.device_basis(fes.d2q, "float64"),
    "compute_geometric_factors": lambda fes: tgfm.compute_geometric_factors(
        element_node_coords(fes.mesh, 2), fes.d2q, "float64"),
    "BilinearForm": lambda fes: BilinearForm(fes),
    "BilinearForm.assemble": lambda fes: BilinearForm(fes)
    .add_domain_integrator("diffusion", 0.5).assemble("float64"),
    "BioheatOperator (partial assembly)": lambda fes: BioheatOperator(
        fes, dtype="float64"),
    "MultiELLPair.from_csr_pair": lambda fes: MultiELLPair.from_csr_pair(
        BilinearForm(fes, "cpu").add_domain_integrator("mass").assemble_matrix(),
        BilinearForm(fes, "cpu").add_domain_integrator("mass").assemble_matrix()),
    "ELLOperator.from_csr": lambda fes: ELLOperator.from_csr(
        sp.identity(5, format="csr")),
    "MultiELLOperator.from_csr": lambda fes: MultiELLOperator.from_csr(
        sp.identity(5, format="csr")),
    "BilinearForm.assemble (vdim 3)": lambda fes: BilinearForm(
        FESpace(fes.mesh, 1, vdim=3)).add_domain_integrator("elasticity")
    .assemble("float64"),
    "bdr_restriction_for": lambda fes: tbuild.bdr_restriction_for(fes),
    "bdr_geom_for": lambda fes: tbuild.bdr_geom_for(fes, dtype="float64"),
    "boundary_lf": lambda fes: tlf.boundary_lf(fes, 1.0, dtype="float64"),
    "elasticity.solve": lambda fes: telasticity.solve(fes.mesh, 1,
                                                      dtype="float64"),
    "bp.run": lambda fes: bp.run((1,), 2, "float64", 2),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_without_device_needs_a_card(name):
    _no_card()
    fes = FESpace(make_cardiac_tet_mesh(4, **KW), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[name](fes)
