"""The port's volume forms on 2D meshes against the JAX package, float64
on the CPU, quad_extra 0 in both packages: ``make_cartesian_2d(8, 8)`` and
``make_cartesian_2d_tri(8, 8)`` at orders 1–3.

* ``PAOperator`` mult and diagonal of a scalar form (mass, diffusion,
  convection with a constant velocity, a boundary mass on a marker) on the
  affine lane path and on the lane-major one (packed (3, ne, nq) diffusion
  qdata), of a matrix diffusion coefficient (full (ne, nq, 2, 2) qdata,
  the einsum chain) and of vdim-2 elasticity, against JAX's FULL assembly
  (JAX's own PA operator enters through ``poisson.solve``);
  ``assemble_matrix`` of the three forms;
* ``models/poisson.solve`` (Jacobi-PCG, quads and triangles) and three
  SDIRK33 steps of ex16's ``ConductionOperator`` (quads), with equal CG
  counts (``models/elasticity.solve``
  on the 2D cantilever is held by ``test_torch_examples.py``).

Everything is held to 1e-10 relative to the reference's max|·|; the
packed 2D qdata are (3, ne, nq) and never reach the 3D fused kernel."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.fem import gridfunction as jgridfunction
from cardiac_ablation_ecm2_tpu.linalg import ode as jode
from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh
from cardiac_ablation_ecm2_tpu.models import heat as jheat
from cardiac_ablation_ecm2_tpu.models import poisson as jpoisson
from cardiac_ablation_ecm2_tpu.ops import bilinearform as jbf
from cardiac_ablation_ecm2_tpu.utils.config import config as jcfg
from cardiac_ablation_ecm2_tpu.utils.config import configure as jconfigure
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import ode as tode
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.models import heat, poisson
from cardiac_ablation_ecm2_tpu_torch.ops import bilinearform as tbf
from cardiac_ablation_ecm2_tpu_torch.ops import diffusion as tdiffusion
from cardiac_ablation_ecm2_tpu_torch.utils.config import config as tcfg
from cardiac_ablation_ecm2_tpu_torch.utils.config import configure as tconfigure
from test_torch_heat import _JaxStages

RTOL = 1e-10
N = 8
VEL = (1.0, 0.5)
MARKER = (1, 3)
KMAT = np.array([[2.0, 0.3], [0.3, 1.0]])
MAKERS = {"quad": (jmesh.make_cartesian_2d, tmesh.make_cartesian_2d),
          "tri": (jmesh.make_cartesian_2d_tri, tmesh.make_cartesian_2d_tri)}
CASES = [(g, p) for g in MAKERS for p in (1, 2, 3)]


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


def close(a, b, rtol=RTOL):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


@functools.lru_cache(maxsize=None)
def _spaces(geom, p, vdim=1):
    jmake, tmake = MAKERS[geom]
    jfes, tfes = JFESpace(jmake(N, N), p, vdim), FESpace(tmake(N, N), p, vdim)
    assert tfes.ndof == jfes.ndof
    assert np.array_equal(tfes.gather_map, jfes.gather_map)
    assert np.array_equal(tfes.bdr_gather_map, jfes.bdr_gather_map)
    return jfes, tfes


def _x(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def _scalar(form):
    return (form.add_domain_integrator("mass", 2.0)
            .add_domain_integrator("diffusion", 0.7)
            .add_domain_integrator("convection", 0.9, vector_coeff=VEL)
            .add_boundary_integrator("mass", 1.5, marker=MARKER))


def _matrix_diffusion(form, pkg):
    if pkg == "jax":
        return form.add_domain_integrator(
            "diffusion", lambda y: jnp.broadcast_to(jnp.asarray(KMAT),
                                                    y.shape[:-1] + (2, 2)))
    return form.add_domain_integrator(
        "diffusion", lambda y: torch.as_tensor(KMAT).expand(*y.shape[:-1], 2, 2))


def same_as_matrix(tA, jM, x):
    """The port's PA apply and diagonal against JAX's assembled matrix."""
    close(tA.mult(torch.as_tensor(x)), jM @ x)
    close(tA.diagonal(), jM.diagonal())


@pytest.mark.parametrize("geom,p", CASES)
def test_scalar_forms_equal_jax(geom, p):
    """The scalar form and a matrix diffusion coefficient, partially
    assembled (the affine lane path; with ``affine_collapse`` "off", the
    lane-major path with 2D bases) and fully assembled, against JAX's
    FULL assembly (JAX's eager partial assembly compiles for ~3 s a space;
    ``poisson.solve`` holds the port to JAX's PA operator)."""
    jfes, tfes = _spaces(geom, p)
    assert np.array_equal(tfes.essential_dofs([1, 2]), jfes.essential_dofs([1, 2]))
    x = _x(tfes.ndof, p)
    jM = _scalar(jbf.BilinearForm(jfes)).assemble_matrix("float64")
    tM = _scalar(tbf.BilinearForm(tfes, "cpu")).assemble_matrix("float64")
    close(tM.toarray(), jM.toarray())
    tA = _scalar(tbf.BilinearForm(tfes, "cpu")).assemble("float64")
    assert [k for k, _ in tA.lane.aff_terms] == ["mass", "diffusion", "convection"]
    same_as_matrix(tA, jM, x)
    old = tcfg.affine_collapse
    tconfigure(affine_collapse="off")
    try:
        tA = _scalar(tbf.BilinearForm(tfes, "cpu")).assemble("float64")
    finally:
        tconfigure(affine_collapse=old)
    assert tA.lane.aff_terms == () and len(tA.lane.terms) == 3
    assert tA.terms[1].qdata.shape[0] == 3 and tdiffusion.is_packed(tA.terms[1].qdata)
    same_as_matrix(tA, jM, x)
    jK = _matrix_diffusion(jbf.BilinearForm(jfes), "jax").assemble_matrix("float64")
    tK = _matrix_diffusion(tbf.BilinearForm(tfes, "cpu"), "torch")
    close(tK.assemble_matrix("float64").toarray(), jK.toarray())
    same_as_matrix(tK.assemble("float64"), jK, x)


@pytest.mark.parametrize("geom,p", CASES)
def test_elasticity_equal_jax(geom, p):
    """vdim-2 elasticity (λ 1.3, μ 0.8), partially and fully assembled,
    against JAX's FULL assembly."""
    jfes, tfes = _spaces(geom, p, 2)
    x = _x(tfes.ndof, 10 + p)
    jM = jbf.BilinearForm(jfes).add_domain_integrator(
        "elasticity", (1.3, 0.8)).assemble_matrix("float64")
    tform = tbf.BilinearForm(tfes, "cpu").add_domain_integrator("elasticity",
                                                                (1.3, 0.8))
    close(tform.assemble_matrix("float64").toarray(), jM.toarray())
    same_as_matrix(tform.assemble("float64"), jM, x)


@functools.lru_cache(maxsize=None)
def jax_poisson(geom):
    """JAX's Jacobi-PCG Poisson at order 2 on the N × N mesh, u = 0 on every
    side, rel_tol 1e-10 (ex1's defaults): (u, CG iterations, final norm)."""
    r = jpoisson.solve(MAKERS[geom][0](N, N), order=2, rel_tol=1e-10)
    return np.asarray(r.u), int(r.iterations), float(r.final_norm)


@pytest.mark.parametrize("geom", list(MAKERS))
def test_poisson_solve_equals_jax(geom):
    u, its, _ = jax_poisson(geom)
    tr = poisson.solve(MAKERS[geom][1](N, N), order=2, rel_tol=1e-10,
                       dtype="float64", device="cpu")
    assert tr.converged and tr.iterations == its
    close(tr.u, u)


@functools.lru_cache(maxsize=None)
def jax_heat(geom):
    """Three SDIRK33 steps of JAX's ex16 (κ = 0.5 + 0.01u, natural
    boundaries, dt 0.01, u₀ = exp(−20 r²) about the centre) at order 2 on
    the 4 × 4 mesh, its stage solves written out: (u₀, the state and
    ‖u‖_L2 after each step, the stage CG counts)."""
    jf = JFESpace(MAKERS[geom][0](4, 4), 2)
    jop = jheat.ConductionOperator(jf, kappa=0.5, alpha=0.01)
    u0 = np.exp(-20.0 * ((jf.dof_coords - 0.5) ** 2).sum(axis=1))
    stages = _JaxStages(jop)
    u, t, out = jnp.asarray(u0), 0.0, []
    for _ in range(3):
        u, t = jode.select("sdirk33").step(stages, u, t, 0.01)
        out.append((np.asarray(u), float(jgridfunction.l2_norm(jf, u))))
    return u0, out, stages.iters


def test_heat_steps_equal_jax():
    """ex16 on quads (the triangles' mass and packed diffusion are held by
    the FULL-assembly and Poisson tests)."""
    geom = "quad"
    u0, states, iters = jax_heat(geom)
    tf = FESpace(MAKERS[geom][1](4, 4), 2)
    top = heat.ConductionOperator(tf, kappa=0.5, alpha=0.01, dtype="float64",
                                  device="cpu")
    step = heat.make_stepper(top, tode.select("sdirk33"))
    u, t = torch.as_tensor(u0), 0.0
    for ref, _ in states:
        u, t = step(u, t, 0.01)
        close(u, ref)
    assert top.cg_iterations == iters and len(iters) == 9
