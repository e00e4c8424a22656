"""The port's operator layer against the JAX package, float64 on the CPU,
on the unit cube of hexes and of tets (``make_cartesian_3d`` /
``make_cartesian_3d_tet``, n = 2) at orders 1–4:

* ``PAOperator`` mult and diagonal of a scalar form (mass, diffusion,
  convection with a constant velocity, a boundary mass on a marker) on the
  affine lane path, and of the same form with a callable velocity and
  ``affine_collapse`` "off" in both packages (restored after) on the
  lane-major path;
* ``assemble_matrix`` of that form against JAX's CSR, and the PA apply
  against it;
* ``ELLOperator`` / ``MultiELLOperator`` (square and rectangular) against
  JAX's ``ELLOperator`` / ``MultiELLOperator`` on the same CSR, the JAX
  kernel in Pallas interpret mode.

Everything is held to 1e-10 relative to the reference's max|·|.  The
vdim-3 forms are in ``test_torch_vector.py``."""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_3d as jhex
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_3d_tet as jtet
from cardiac_ablation_ecm2_tpu.ops import bilinearform as jbf
from cardiac_ablation_ecm2_tpu.ops import ell as jell
from cardiac_ablation_ecm2_tpu.utils.config import config as jcfg
from cardiac_ablation_ecm2_tpu.utils.config import configure as jconfigure
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d as thex
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d_tet as ttet
from cardiac_ablation_ecm2_tpu_torch.ops import bilinearform as tbf
from cardiac_ablation_ecm2_tpu_torch.ops import ell as tell
from cardiac_ablation_ecm2_tpu_torch.utils.config import config as tcfg
from cardiac_ablation_ecm2_tpu_torch.utils.config import configure as tconfigure

RTOL = 1e-10
N = 2
VEL = (1.0, 0.5, 0.25)
MARKER = (1, 3, 5)
CASES = [(g, p) for g in ("hex", "tet") for p in (1, 2, 3, 4)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= rtol, err


def _vel(x):
    """A callable velocity, written for either package's arrays."""
    return 0.0 * x + x[..., [1, 2, 0]] * x[..., [2, 0, 1]] + 0.5


@functools.lru_cache(maxsize=None)
def _spaces(geom, p, vdim=1):
    """The JAX and port spaces of one case, shared by every test of this
    module and of ``test_torch_vector`` (with them the JAX package's
    geometric factors, cached per space)."""
    jmake, tmake = (jhex, thex) if geom == "hex" else (jtet, ttet)
    jfes, tfes = JFESpace(jmake(N, N, N), p, vdim), FESpace(tmake(N, N, N), p, vdim)
    assert tfes.ndof == jfes.ndof
    return jfes, tfes


def _scalar_forms(jfes, tfes, vel):
    def build(form):
        return (form.add_domain_integrator("mass", 2.0)
                .add_domain_integrator("diffusion", 0.7)
                .add_domain_integrator("convection", 0.9, vector_coeff=vel)
                .add_boundary_integrator("mass", 1.5, marker=MARKER))
    return build(jbf.BilinearForm(jfes)), build(tbf.BilinearForm(tfes, "cpu"))


def _x(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def jax_apply(jA, x):
    """JAX's mult of ``x`` and diagonal, each under ``jax.jit`` (one
    compile of the whole apply instead of one per eager operation)."""
    return jax.jit(jA.mult)(jnp.asarray(x)), jax.jit(jA.diagonal)()


def same_apply(tA, jA, x):
    jy, jd = jax_apply(jA, x)
    close(tA.mult(torch.as_tensor(x)), jy)
    close(tA.diagonal(), jd)


@pytest.mark.parametrize("geom,p", CASES)
def test_pa_operator_equals_jax(geom, p):
    jfes, tfes = _spaces(geom, p)
    x = _x(tfes.ndof, p)
    jform, tform = _scalar_forms(jfes, tfes, VEL)
    jA, tA = jform.assemble("float64"), tform.assemble("float64")
    assert [k for k, _ in tA.lane.aff_terms] == ["mass", "diffusion", "convection"]
    assert len(jA.lane.aff_terms) == 3 and len(tA.std_terms) == 1
    same_apply(tA, jA, x)
    old = jcfg.affine_collapse, tcfg.affine_collapse
    jconfigure(affine_collapse="off")
    tconfigure(affine_collapse="off")
    try:
        jform, tform = _scalar_forms(jfes, tfes, _vel)
        jA, tA = jform.assemble("float64"), tform.assemble("float64")
    finally:
        jconfigure(affine_collapse=old[0])
        tconfigure(affine_collapse=old[1])
    assert tA.lane.aff_terms == () and len(tA.lane.terms) == 3
    assert len(jA.lane.terms) == 3
    same_apply(tA, jA, x)
    # FULL assembly of the same form, and the PA apply against it
    jM, tM = jform.assemble_matrix("float64"), tform.assemble_matrix("float64")
    close(tM.toarray(), jM.toarray())
    close(tA.mult(torch.as_tensor(x)), tM @ x)


def _ell_matrices(kind):
    """For JAX's ``ELLOperator`` (one global width, every plane unrolled in
    its interpret-mode kernel) a tet order-1 mass and a random rectangular
    matrix; for ``MultiELLOperator`` (width buckets) a hex order-2
    stiffness, rows 8 to 125 wide."""
    if kind == "MultiELLOperator":
        jfes = _spaces("hex", 2)[0]
        return [jbf.BilinearForm(jfes).add_domain_integrator("diffusion")
                .assemble_matrix("float64")]
    jt = _spaces("tet", 1)[0]
    M = jbf.BilinearForm(jt).add_domain_integrator("mass") \
        .assemble_matrix("float64")
    return [M, sp.random(97, 61, density=0.08, random_state=3, format="csr")]


@pytest.mark.parametrize("kind", ["ELLOperator", "MultiELLOperator"])
def test_ell_operators_equal_jax(kind):
    for A in _ell_matrices(kind):
        x = _x(A.shape[1], A.shape[0])
        jop = getattr(jell, kind).from_csr(A, "float64")
        top = getattr(tell, kind).from_csr(A, "float64", device="cpu")
        assert top.shape == A.shape
        close(top.mult(torch.as_tensor(x)), jop.mult(jnp.asarray(x)))
        close(top.mult(torch.as_tensor(x)), A @ x)
        close(top.diagonal(), jop.diagonal())
        assert top.operator().shape == A.shape


@pytest.mark.parametrize("geom,p", [("tet", 1), ("hex", 4)])
def test_assemble_ell_is_the_matrix(geom, p):
    """``assemble_ell`` and ``MultiELLOperator.from_csr(assemble_matrix())``
    (hex order 4: vertex rows 729 wide) apply the matrix and equal the PA
    apply."""
    tfes = _spaces(geom, p)[1]
    form = tbf.BilinearForm(tfes, "cpu").add_domain_integrator("diffusion", 0.5)
    M = form.assemble_matrix("float64")
    x = torch.as_tensor(_x(tfes.ndof, 4))
    for E in (form.assemble_ell("float64"),
              tell.MultiELLOperator.from_csr(M, "float64", device="cpu")):
        close(E.mult(x), M @ x.numpy())
        close(E.mult(x), form.assemble("float64").mult(x))
    if geom == "hex":
        assert E.max_width == (2 * p + 1) ** 3
