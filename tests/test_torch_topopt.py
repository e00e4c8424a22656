"""The port's topology optimisation (``models/topopt.py``) against the JAX
package, float64 on the CPU: three SIMP/OC iterations on JAX's cantilever
with the density filter: equal CG counts, ρ and the compliances to
1e-10."""

import torch

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.mesh import Mesh as JMesh
from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jquad
from cardiac_ablation_ecm2_tpu.models.topopt import TopOpt as JTopOpt
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import Mesh, make_cartesian_2d
from cardiac_ablation_ecm2_tpu_torch.models.topopt import TopOpt
from test_torch_constrained import RTOL, _one_thread, close  # noqa: F401 (a fixture)
from torch_threads import beside


def _beam(make, mesh_cls, nx, ny):
    m0 = make(nx, ny)
    V = m0.vertices.copy()
    V[:, 0] *= 2.0
    return mesh_cls(geom=m0.geom, vertices=V, elements=m0.elements,
                    attributes=m0.attributes, boundary=m0.boundary,
                    bdr_attributes=m0.bdr_attributes)


def test_topopt():
    jo = JTopOpt(_beam(jquad, JMesh, 12, 6), volfrac=0.4, filter_radius=0.3)
    to = TopOpt(_beam(make_cartesian_2d, Mesh, 12, 6), volfrac=0.4,
                filter_radius=0.3, device="cpu")

    def jax_side():
        rj, uj, out = jnp.full(jo.mesh.ne, 0.4), None, []
        for _ in range(3):
            _, info = jo._solve(rj, uj)      # JAX's solve of this step, for its count
            rj, uj, cj = jo.step(rj, uj)
            out.append((int(info.iterations), rj, uj, cj))
        return out

    jax_run = beside(jax_side)
    rt, ut = torch.full((to.mesh.ne,), 0.4, dtype=torch.float64), None
    ours = []
    for _ in range(3):
        rt, ut, ct = to.step(rt, ut)
        ours.append((to.info.iterations, rt.clone(), ut.clone(), ct))
    for (it, rt, ut, ct), (ij, rj, uj, cj) in zip(ours, jax_run.result()):
        assert it == ij
        assert abs(ct - cj) <= RTOL * abs(cj)
        close(ut, uj)
        close(rt, rj)
