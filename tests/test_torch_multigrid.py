"""The port's multigrid slice (``fem/transfer``, ``linalg/multigrid``,
``ops/lor``, ``ops/lor_device``) against the JAX package, float64 on the
CPU, quad_extra 0 in both packages.

Tolerances: ``PTransfer`` (hexes and tets) exact on a field of the
coarse space (1e-12,
as ``tests/test_multigrid.py::test_p_transfer_exactness``), equal to JAX's
transfer to 1e-13·max and ``restrict_t`` the adjoint of ``prolongate`` to
1e-13 relative; ``Multigrid.v_cycle`` with Chebyshev smoothers on a shared
``eig_max`` equal to JAX's to 1e-12·max|x|; the LOR slots and connectivity
exactly equal; the LOR element matrices, ``DeviceLOROperator.mult`` and
``diagonal`` (also over JAX's arrays through ``from_jax_arrays``) to
1e-12·max.  The LOR-MG PCG counts are held to the bounds of JAX's
``test_lor_mg_bounded_iterations_under_refinement`` over n = 2, 4, 8, and
at n = 2 to JAX's own counts (Jacobi equal, LOR-MG ±2 for the random
starts of the Chebyshev bounds)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.fem.transfer import PTransfer as JPTransfer
from cardiac_ablation_ecm2_tpu.linalg import multigrid as jmg
from cardiac_ablation_ecm2_tpu.linalg import smoothers as jsmoothers
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_hex_mesh as jcardiac
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_tet_mesh as jcardiac_tet
from cardiac_ablation_ecm2_tpu.mesh.mesh import make_cartesian_3d as jcart
from cardiac_ablation_ecm2_tpu.ops import bilinearform as jbf
from cardiac_ablation_ecm2_tpu.ops import lor as jlor
from cardiac_ablation_ecm2_tpu.ops import lor_device as jlord
from cardiac_ablation_ecm2_tpu.ops.operators import ConstrainedOperator as JConstrained
from cardiac_ablation_ecm2_tpu.utils.config import config as jcfg
from cardiac_ablation_ecm2_tpu.utils.config import configure as jconfigure
from cardiac_ablation_ecm2_tpu_torch.fem import gridfunction as tgf
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.fem.geometry import Geometry
from cardiac_ablation_ecm2_tpu_torch.fem.transfer import PTransfer
from cardiac_ablation_ecm2_tpu_torch.linalg import multigrid as tmg
from cardiac_ablation_ecm2_tpu_torch.linalg import smoothers
from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import (
    make_cardiac_hex_mesh,
    make_cardiac_tet_mesh,
)
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
from cardiac_ablation_ecm2_tpu_torch.ops import bilinearform as tbf
from cardiac_ablation_ecm2_tpu_torch.ops import lor as tlor
from cardiac_ablation_ecm2_tpu_torch.ops import lor_device as tlord
from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf
from cardiac_ablation_ecm2_tpu_torch.ops.operators import ConstrainedOperator
from cardiac_ablation_ecm2_tpu_torch.utils.config import config as tcfg
from cardiac_ablation_ecm2_tpu_torch.utils.config import configure as tconfigure

F64 = dict(dtype="float64", device="cpu")


@pytest.fixture(autouse=True)
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
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


def kappa(x):
    """A variable coefficient, written for jnp and torch alike."""
    return 1.0 + x[..., 0] + 0.5 * x[..., 1]


MESHES = {"cube": (lambda: jcart(2, 2, 2), lambda: make_cartesian_3d(2, 2, 2)),
          "cardiac": (lambda: jcardiac(2, lengths=(0.04, 0.04, 0.02),
                                       electrode_radius=0.004),
                      lambda: make_cardiac_hex_mesh(2, lengths=(0.04, 0.04, 0.02),
                                                    electrode_radius=0.004))}


#: a small cardiac tet mesh for the simplex branch of the transfer
TET = (lambda: jcardiac_tet(3), lambda: make_cardiac_tet_mesh(3))
Q1_FIELD = (lambda x: 1.0 + x[..., 0] - 2.0 * x[..., 1] * x[..., 2]
            + x[..., 0] * x[..., 1] * x[..., 2])
P1_FIELD = (lambda x: 1.0 + x[..., 0] - 2.0 * x[..., 1] + 0.5 * x[..., 2])
P2_FIELD = (lambda x: x[..., 0] ** 2 + 0.5 * x[..., 0] * x[..., 1] - x[..., 2])


@pytest.mark.parametrize("mesh,pc,pf,field", [
    ("cube", 1, 2, Q1_FIELD), ("cube", 2, 3, P2_FIELD),
    ("tet", 1, 2, P1_FIELD), ("tet", 2, 3, P2_FIELD)])
def test_p_transfer(mesh, pc, pf, field):
    jm, tm = MESHES["cube"] if mesh == "cube" else TET
    jmesh, tmesh = jm(), tm()
    jc, jf = JFESpace(jmesh, pc), JFESpace(jmesh, pf)
    tc, tf = FESpace(tmesh, pc), FESpace(tmesh, pf)
    jtr, ttr = JPTransfer(jc, jf), PTransfer(tc, tf, **F64)
    uf = ttr.prolongate(tgf.project(tc, field, **F64))
    close(uf, tgf.project(tf, field, **F64), 1e-12)
    rng = np.random.default_rng(0)
    a, b = rng.random(tc.ndof), rng.random(tf.ndof)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    close(ttr.prolongate(ta), jtr.prolongate(jnp.asarray(a)), 1e-13)
    close(ttr.restrict_t(tb), jtr.restrict_t(jnp.asarray(b)), 1e-13)
    lhs = float(torch.dot(ttr.prolongate(ta), tb))
    assert abs(lhs - float(torch.dot(ta, ttr.restrict_t(tb)))) <= 1e-13 * abs(lhs)
    with pytest.raises(ValueError):
        PTransfer(tc, FESpace(tm(), pf), **F64)


def _diffusion(pkg, fes, ess):
    """The constrained diffusion operator (κ variable) of one package."""
    if pkg == "jax":
        A = jbf.BilinearForm(fes).add_domain_integrator("diffusion", kappa).assemble()
        return JConstrained.wrap(A.operator(), ess)
    A = tbf.BilinearForm(fes, "cpu").add_domain_integrator(
        "diffusion", kappa).assemble("float64")
    return ConstrainedOperator.wrap(A.operator(), ess, "float64", "cpu")


def _levels(pkg, kind, n=2):
    """Two levels (order 1 under order 3 on the n³ cube, faces 1 and 2
    essential) in one package: the fine level the order-3 operator
    (``"p"``) or the LOR operator (``"lor"``); Chebyshev smoothers of
    order 3 on ``eig_max`` 1.9 and 2.1 shared by both packages."""
    mesh = jcart(n, n, n) if pkg == "jax" else make_cartesian_3d(n, n, n)
    Space = JFESpace if pkg == "jax" else FESpace
    f1, f3 = Space(mesh, 1), Space(mesh, 3)
    e1, e3 = f1.essential_dofs([1, 2]), f3.essential_dofs([1, 2])
    A1 = _diffusion(pkg, f1, e1)
    if kind == "p":
        A3 = _diffusion(pkg, f3, e3)
    elif pkg == "jax":
        A3 = jlord.DeviceLOROperator(f3, kappa, ess=e3)
    else:
        A3 = tlord.DeviceLOROperator(f3, kappa, ess=e3, **F64)
    if pkg == "jax":
        tr = JPTransfer(f1, f3)
        cheb, MG, Lvl, ess = jsmoothers.chebyshev, jmg.Multigrid, jmg.MGLevel, jnp.asarray
    else:
        tr = PTransfer(f1, f3, **F64)
        cheb, MG, Lvl = smoothers.chebyshev, tmg.Multigrid, tmg.MGLevel
        ess = lambda e: tmg.ess_tensor(e, "cpu")  # noqa: E731
    levels = [Lvl(A1.mult, cheb(A1.mult, A1.diagonal(), order=3, eig_max=1.9),
                  None, None, ess(e1)),
              Lvl(A3.mult, cheb(A3.mult, A3.diagonal(), order=3, eig_max=2.1),
                  tr.prolongate, tr.restrict_t, ess(e3))]
    return MG(levels=levels), f3.ndof


@pytest.mark.parametrize("kind", ["p", "lor"])
def test_v_cycle_matches_jax(kind):
    jm, n = _levels("jax", kind)
    tm, _ = _levels("torch", kind)
    b = np.random.default_rng(5).standard_normal(n)
    close(tm.v_cycle(torch.as_tensor(b)), jm.v_cycle(jnp.asarray(b)), 1e-12)
    assert tm.cycles == 0
    tm.preconditioner()(torch.as_tensor(b))
    assert tm.cycles == 1


def test_make_p_multigrid_pcg():
    """make_p_multigrid (orders 1, 2, 3) as a CG preconditioner converges
    in fewer iterations than Jacobi, to the same solution."""
    mesh = make_cartesian_3d(3, 3, 3)
    spaces = {}

    def space(p):
        return spaces.setdefault(p, FESpace(mesh, p))

    def op(f):
        return _diffusion("torch", f, f.essential_dofs())

    mg = tmg.make_p_multigrid(space, op, (1, 2, 3),
                              ess_factory=lambda f: f.essential_dofs(), **F64)
    A = op(space(3))
    b = domain_lf(space(3), 1.0, **F64) * A.mask
    x_mg, i_mg = cg(A.mult, b, M=mg.preconditioner(), rel_tol=1e-10, max_iter=500)
    x_j, i_j = cg(A.mult, b, M=smoothers.jacobi(A.diagonal()), rel_tol=1e-10,
                  max_iter=500)
    assert i_mg.converged and i_j.converged
    assert i_mg.iterations < i_j.iterations / 2, (i_mg, i_j)
    close(x_mg, x_j, 1e-8)


@pytest.mark.parametrize("geom,p", [(Geometry.CUBE, 1), (Geometry.CUBE, 2),
                                    (Geometry.CUBE, 3), (Geometry.SQUARE, 3)])
def test_lor_corner_slots(geom, p):
    from cardiac_ablation_ecm2_tpu.fem.geometry import Geometry as JGeometry

    np.testing.assert_array_equal(tlor.lor_corner_slots(geom, p),
                                  jlor.lor_corner_slots(JGeometry(int(geom)), p))
    with pytest.raises(ValueError):
        tlor.lor_corner_slots(Geometry.TETRAHEDRON, p)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("p", [2, 3])
def test_lor_connectivity_and_matrices(mesh, p):
    jm, tm = MESHES[mesh]
    jf, tf = JFESpace(jm(), p), FESpace(tm(), p)
    np.testing.assert_array_equal(tlor.lor_submesh_connectivity(tf),
                                  jlor.lor_submesh_connectivity(jf))
    for kw in (dict(diffusion_coeff=1.0), dict(diffusion_coeff=kappa),
               dict(diffusion_coeff=0.7, mass_coeff=kappa),
               dict(diffusion_coeff=None, mass_coeff=2.0)):
        jA, jconn = jlord.lor_element_matrices(jf, **kw)
        tA, tconn = tlord.lor_element_matrices(tf, **kw, **F64)
        np.testing.assert_array_equal(tconn, jconn)
        close(tA, jA, 1e-12)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_device_lor_operator(mesh):
    jm, tm = MESHES[mesh]
    jf, tf = JFESpace(jm(), 3), FESpace(tm(), 3)
    ess = jf.essential_dofs([2, 3])
    jop = jlord.DeviceLOROperator(jf, kappa, mass_coeff=0.3, ess=ess)
    top = tlord.DeviceLOROperator(tf, kappa, mass_coeff=0.3, ess=ess, **F64)
    A_e, conn = jlord.lor_element_matrices(jf, kappa, mass_coeff=0.3)
    carried = tlord.DeviceLOROperator.from_jax_arrays(np.array(A_e), conn, ess,
                                                      jf.ndof_scalar, "cpu")
    assert carried.A_e.dtype == torch.float64
    x = np.sin(np.arange(tf.ndof, dtype=np.float64))
    jy = jop.mult(jnp.asarray(x))
    for op in (top, carried):
        close(op.mult(torch.as_tensor(x)), jy, 1e-12)
        close(op.diagonal(), jop.diagonal(), 1e-12)
    for key in ("lor_matrices", "lor_restriction"):
        assert top.setup_seconds[key] >= 0.0


def _poisson_iters(n, p, lor):
    """PCG iterations of −Δu = sin(3x) + y on the n³ cube, order p, all
    faces essential, rel_tol 1e-10 (JAX's ``_poisson_iters``): Jacobi, or
    the LOR multigrid under the same masking."""
    fes = FESpace(make_cartesian_3d(n, n, n), p)
    A = tbf.BilinearForm(fes, "cpu").add_domain_integrator(
        "diffusion").assemble("float64")
    ess = fes.essential_dofs(None)
    mask = torch.zeros(fes.ndof, dtype=torch.float64)
    mask[torch.as_tensor(ess, dtype=torch.int64)] = 1.0

    def Aop(x):
        z = x * (1 - mask)
        return A.mult(z) * (1 - mask) + x * mask

    b = domain_lf(fes, lambda x: torch.sin(3 * x[..., 0]) + x[..., 1], **F64)
    b = b * (1 - mask)
    if lor:
        inner = tlord.make_lor_multigrid(fes, 1.0, ess_bdr=None, **F64).preconditioner()
        M = lambda r: inner(r * (1 - mask)) * (1 - mask) + r * mask  # noqa: E731
    else:
        dg = A.diagonal() * (1 - mask) + mask
        M = lambda r: r / dg  # noqa: E731
    x, info = cg(Aop, b, M=M, rel_tol=1e-10, max_iter=3000)
    assert float(torch.linalg.norm(b - Aop(x))) < 1e-8 * max(1.0, float(torch.linalg.norm(b)))
    return info.iterations


def test_lor_mg_bounded_iterations_under_refinement():
    """JAX's bounds over n = 2, 4, 8 (at n = 2, 4 alone they do not hold:
    both packages take 23 and 30 LOR-MG iterations against Jacobi's 20 and
    41); at n = 2 the counts are JAX's, ±2 for the random starts."""
    jac = [_poisson_iters(n, 3, False) for n in (2, 4, 8)]
    lor = [_poisson_iters(n, 3, True) for n in (2, 4, 8)]
    assert jac[-1] / jac[0] > 2.0, jac
    assert lor[-1] <= lor[0] + 6, (jac, lor)
    assert lor[-1] < jac[-1] / 2, (jac, lor)
    assert jac[0] == _jax_poisson_iters(2, 3, False)
    assert abs(lor[0] - _jax_poisson_iters(2, 3, True)) <= 2


def _jax_poisson_iters(n, p, lor):
    from test_lor_device import _poisson_iters as jax_iters

    M = None
    if lor:
        fes = JFESpace(jcart(n, n, n), p)
        M = jlord.make_lor_multigrid(fes, 1.0, ess_bdr=None).preconditioner()
    return jax_iters(n, p, M=M)
