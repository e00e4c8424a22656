"""The port's normal constraints (``linalg/constrained.py``) on ex28's
sliding trapezoid against the JAX package, float64 on the CPU:
``boundary_face_normals`` and ``build_normal_constraints`` array for
array; the elimination solve at order 1 and with the order-2 normal
constraints, the Schur-complement solve at order 1: x and λ within 1e-10
relative (the Schur x 1e-9), equal CG / MINRES counts."""

import numpy as np
import pytest

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.linalg import constrained as jc
from cardiac_ablation_ecm2_tpu.mesh import Mesh as JMesh
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.ops import BilinearForm as JBilinearForm
from cardiac_ablation_ecm2_tpu.ops.linearform import boundary_lf_vector as jblf
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import constrained as tc
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import Mesh, make_cartesian_2d
from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
from cardiac_ablation_ecm2_tpu_torch.ops.linearform import boundary_lf_vector
from test_torch_constrained import _one_thread, close, same_info  # noqa: F401 (a fixture)


def _trapezoid(make, mesh_cls, nx, ny, offset=0.3):
    m0 = make(nx, ny)
    V = m0.vertices.copy()
    V[:, 0] = V[:, 0] + (1.0 - V[:, 0]) * offset * V[:, 1]
    return mesh_cls(geom=m0.geom, vertices=V, elements=m0.elements,
                    attributes=m0.attributes, boundary=m0.boundary,
                    bdr_attributes=m0.bdr_attributes)


@pytest.mark.parametrize("n,order", [(8, 1), (4, 2)])
def test_ex28_sliding(n, order):
    jf = JFESpace(_trapezoid(jquad, JMesh, n, n), order, vdim=2)
    tf = FESpace(_trapezoid(make_cartesian_2d, Mesh, n, n), order, vdim=2)
    assert np.array_equal(tc.boundary_face_normals(tf.mesh),
                          jc.boundary_face_normals(jf.mesh))
    Bj = jc.build_normal_constraints(jf, [1, 4], dtype=jnp.float64)
    Bt = tc.build_normal_constraints(tf, [1, 4], dtype="float64", device="cpu")
    assert np.array_equal(Bt.idx.numpy(), np.asarray(Bj.idx))
    assert np.array_equal(Bt.val.numpy(), np.asarray(Bj.val))
    assert np.array_equal(Bt.rowstarts, Bj.rowstarts)
    Aj = JBilinearForm(jf).add_domain_integrator("elasticity", coeff=(1.0, 1.0)).assemble()
    At = BilinearForm(tf, "cpu").add_domain_integrator("elasticity",
                                                       coeff=(1.0, 1.0)).assemble()
    bj = jblf(jf, np.array([-5e-2, 0.0]), bdr_marker=[2])
    bt = boundary_lf_vector(tf, np.array([-5e-2, 0.0]), bdr_marker=[2], device="cpu")
    dj, dt = Aj.diagonal(), At.diagonal()
    xj, lj, ij = jc.eliminate_constrained_solve(Aj.mult, Bj, bj, M=lambda v: v / dj,
                                                rel_tol=1e-12, max_iter=6000)
    xt, lt, it = tc.eliminate_constrained_solve(At.mult, Bt, bt, M=lambda v: v / dt,
                                                rel_tol=1e-12, max_iter=6000)
    same_info(it, ij)
    close(xt, xj)
    close(lt, lj)
    if order == 1:
        xj, lj, ij = jc.schur_constrained_solve(Aj.mult, Bj, bj, Adiag=dj,
                                                rel_tol=1e-12, max_iter=8000)
        xt, lt, it = tc.schur_constrained_solve(At.mult, Bt, bt, Adiag=dt,
                                                rel_tol=1e-12, max_iter=8000)
        same_info(it, ij)
        close(xt, xj, 1e-9)
