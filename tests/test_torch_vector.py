"""The port's vector (vdim 3, byNODES) operator layer against the JAX
package, float64 on the CPU, on the unit cube of hexes and of tets (n = 2)
at orders 1–4: ``PAOperator`` mult and diagonal of a form holding
elasticity, a callable mass, a callable-velocity convection, a matrix
diffusion coefficient and a boundary mass on a marker (the element-major
per-component and coupled paths), FULL assembly of elasticity against
JAX's CSR and the PA apply against it, and the vector space's numbering.
Everything is held to 1e-10 relative to the reference's max|·|."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.ops import bilinearform as jbf
from cardiac_ablation_ecm2_tpu_torch.ops import bilinearform as tbf

from test_torch_operators import (MARKER, _one_thread, _spaces, _vel, _x,  # noqa: F401
                                  close, same_apply)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [(g, p) for g in ("hex", "tet") for p in (1, 2, 3, 4)]


def _kappa(x):
    return 1.0 + x[..., 0] * x[..., 1]


def _matrix_coeff(ne, nq, xp):
    """A constant SPD conductivity as an (ne, nq, 3, 3) Q-vector."""
    K = np.array([[2.0, 0.3, 0.1], [0.3, 1.5, 0.2], [0.1, 0.2, 1.0]])
    return xp(np.broadcast_to(K, (ne, nq, 3, 3)).copy())


def _vector_forms(jfes, tfes):
    nq = jfes.d2q.weights.shape[0]
    ne = jfes.mesh.ne

    def build(form, xp):
        return (form.add_domain_integrator("elasticity", (1.3, 0.8))
                .add_domain_integrator("mass", _kappa)
                .add_domain_integrator("convection", None, vector_coeff=_vel)
                .add_domain_integrator("diffusion", _matrix_coeff(ne, nq, xp))
                .add_boundary_integrator("mass", 0.6, marker=MARKER))
    return (build(jbf.BilinearForm(jfes), jnp.asarray),
            build(tbf.BilinearForm(tfes, "cpu"), torch.as_tensor))


@pytest.mark.parametrize("geom,p", CASES)
def test_vector_pa_operator_equals_jax(geom, p):
    jfes, tfes = _spaces(geom, p, vdim=3)
    x = _x(tfes.ndof, 10 + p)
    jform, tform = _vector_forms(jfes, tfes)
    jA, tA = jform.assemble("float64"), tform.assemble("float64")
    assert tA.lane is None and len(tA.terms) == 5
    same_apply(tA, jA, x)
    jE = jbf.BilinearForm(jfes).add_domain_integrator("elasticity", (1.3, 0.8))
    tE = tbf.BilinearForm(tfes, "cpu").add_domain_integrator("elasticity",
                                                             (1.3, 0.8))
    jM, tM = jE.assemble_matrix("float64"), tE.assemble_matrix("float64")
    close(tM.toarray(), jM.toarray())
    close(tE.assemble("float64").mult(torch.as_tensor(x)), tM @ x)


def test_vector_space_numbering_equals_jax():
    for geom in ("hex", "tet"):
        jfes, tfes = _spaces(geom, 2, vdim=3)
        assert (tfes.ndof, tfes.ndof_scalar) == (jfes.ndof, jfes.ndof_scalar)
        assert tfes.ndof == 3 * tfes.ndof_scalar
        assert np.array_equal(tfes.gather_map, jfes.gather_map)
        assert np.array_equal(tfes.bdr_gather_map, jfes.bdr_gather_map)
        assert np.array_equal(tfes.essential_dofs([5]), jfes.essential_dofs([5]))
