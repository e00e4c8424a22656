"""The port's sharded vector-FE solve (``parallel/pvecfe``) over 2 and 4
spawned gloo ranks against the JAX package, float64 on the CPU: ND and RT
spaces (tensor HO and simplex, signs and DofTransformations, with and
without essential BCs) with Jacobi-PCG, and ND₁ with the in-shard AMS.

Every solution is held to JAX's serial Jacobi-PCG solve (the problem of
``_serial`` in the JAX package's own ``test_pvecfe``: its operator,
right-hand side and diagonal, with its ``cg`` recurrence written out over
the jitted apply, ``test_torch_ams.jax_pcg``) within 1e-10 of max|u|
(both at rel_tol 1e-12; 4e-13 apart at world 1, measured on a
rehearsal).  The Jacobi counts are held as the JAX package's own sharded
test holds its counts to its serial ones, within max(3, 10%): these
small problems take 60–280 iterations and sit in CG's round-off regime,
where partial sums in another order move the stopping iteration (rt-hex
stops at 66 against JAX's 67 at world 1; nd-tet-ess at 282 against 283
at world 1 and at 298 at world 4; JAX's own ``cg`` loop and the written-out
recurrence stop at 97 and 98 on nd-hex, measured), while the solutions
agree.  The JAX references are computed in a thread while the ranks
run.  World 1 over NCCL against gloo is
a card test (``test_torch_cuda``).
The in-shard AMS count equals JAX's sharded AMS count over the same
number of devices.  The rank bodies live here (a spawned rank imports
this module), and JAX is imported inside the tests only.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector as tv
from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector_ho as tho
from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector_simplex as ts
from cardiac_ablation_ecm2_tpu_torch.fem.geometry import Geometry
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.parallel import launch, pvecfe

REL_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f(x):
    x = np.asarray(x)
    comps = [np.sin(x[..., 0]) + x[..., 1], np.cos(x[..., 1]) - 0.5 * x[..., 0]]
    if x.shape[-1] == 3:
        comps.append(x[..., 2] ** 2)
    return np.stack(comps, axis=-1)


#: name → (space class name, order, JAX mesh maker, permutation seed,
#: coefficients, essential BCs, preconditioner)
CASES = {
    "nd-hex": ("NDSpaceHO", 2, ("make_cartesian_3d", (2, 2, 2)), 3,
               dict(mass_coeff=1.0, curlcurl_coeff=1.0), False, "jacobi"),
    "rt-hex": ("RTSpaceHO", 2, ("make_cartesian_3d", (2, 2, 2)), 5,
               dict(mass_coeff=1.0, divdiv_coeff=0.7), False, "jacobi"),
    "nd-tet-ess": ("NDSimplexSpace", 2, ("make_cartesian_3d_tet", (2, 2, 2)), 1,
                   dict(mass_coeff=1.0, curlcurl_coeff=1.0), True, "jacobi"),
    "rt-tri-ess": ("RTSimplexSpace", 2, ("make_cartesian_2d_tri", (3, 3)), 7,
                   dict(mass_coeff=1.0, divdiv_coeff=1.0), True, "jacobi"),
    "nd0-ams": ("NDSpace", None, ("make_cartesian_3d", (4, 4, 4)), None,
                dict(mass_coeff=1.0, curlcurl_coeff=1.0), True, "ams"),
}
WORLDS = {2: ("nd-hex", "rt-tri-ess", "nd0-ams"), 4: ("rt-hex", "nd-tet-ess", "nd0-ams")}
MODULES = {"NDSpace": tv, "NDSpaceHO": tho, "RTSpaceHO": tho,
           "NDSimplexSpace": ts, "RTSimplexSpace": ts}


def _space(name, mesh):
    cls, p = CASES[name][:2]
    return getattr(MODULES[cls], cls)(mesh, *(() if p is None else (p,)))


def _ess_bdr(name, mesh):
    return sorted(set(mesh.bdr_attributes.tolist())) if CASES[name][5] else None


def _rank_cases(rank, world, dev, names, meshes):
    torch.set_num_threads(1)
    out = []
    for name, mesh in zip(names, meshes):
        pv = pvecfe.setup(_space(name, mesh), nq1d=4 if CASES[name][1] else 3,
                          rhs_fn=_f, ess_bdr=_ess_bdr(name, mesh), rel_tol=REL_TOL,
                          max_iter=4000, precond=CASES[name][6], dtype="float64",
                          device=dev, **CASES[name][4])
        out.append(pv.solve())
    return out


@functools.lru_cache(maxsize=None)
def _meshes(name):
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh
    from test_fespace import permute_vertices

    maker, args = CASES[name][2]
    jm = getattr(jmesh, maker)(*args)
    if CASES[name][3] is not None:
        jm = permute_vertices(jm, CASES[name][3])
    tm = tmesh.Mesh(geom=Geometry(int(jm.geom)), vertices=jm.vertices,
                    elements=jm.elements, attributes=jm.attributes,
                    boundary=jm.boundary, bdr_attributes=jm.bdr_attributes)
    return jm, tm


@functools.lru_cache(maxsize=None)
def _jax_serial(name):
    """JAX's serial Jacobi-PCG solve of case ``name`` (x, count)."""
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem import fe_vector as jv
    from cardiac_ablation_ecm2_tpu.fem import fe_vector_ho as jho
    from cardiac_ablation_ecm2_tpu.fem import fe_vector_simplex as js
    from cardiac_ablation_ecm2_tpu.ops import vecfe as jo
    from test_torch_ams import jax_pcg

    jm, _ = _meshes(name)
    cls, p = CASES[name][:2]
    mod = {"NDSpace": jv, "NDSpaceHO": jho, "RTSpaceHO": jho,
           "NDSimplexSpace": js, "RTSimplexSpace": js}[cls]
    sp = getattr(mod, cls)(jm, *(() if p is None else (p,)))
    build = jo.build_nd_operator if "nd" in name else jo.build_rt_operator
    op = build(sp, nq1d=4 if p else 3, **CASES[name][4])
    b, d = jo.vecfe_linear_form(op, _f), op.diagonal()
    bdr = _ess_bdr(name, jm)
    A = op.mult
    if bdr:
        m = jnp.ones(op.ndof).at[jnp.asarray(sp.essential_dofs(bdr))].set(0.0)
        b = b * m
        A = lambda v: op.mult(v * m) * m + v * (1 - m)      # noqa: E731
        d = d * m + (1 - m)
    x, its = jax_pcg(A, b, lambda r: r / d, rel_tol=REL_TOL, max_iter=4000)
    assert its < 4000
    return np.asarray(x), its


def _jax_sharded_ams_count(name, world):
    import jax

    from cardiac_ablation_ecm2_tpu.fem import fe_vector as jv
    from cardiac_ablation_ecm2_tpu.parallel import pvecfe as jp

    jm, _ = _meshes(name)
    pv = jp.setup(jv.NDSpace(jm), rhs_fn=_f, ess_bdr=_ess_bdr(name, jm), rel_tol=REL_TOL,
                  max_iter=4000, precond="ams", ndev=world,
                  devices=jax.devices("cpu")[:world], **CASES[name][4])
    return int(pv.solve()[1])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_solves_equal_jax(world):
    names = WORLDS[world]
    meshes = [_meshes(n)[1] for n in names]

    def references():
        return [(_jax_serial(n), _jax_sharded_ams_count(n, world)
                 if CASES[n][6] == "ams" else None) for n in names]

    with ThreadPoolExecutor(1) as pool:
        refs = pool.submit(references)
        got = launch.spawn(_rank_cases, world, "cpu", names, meshes)[0]
        refs = refs.result()
    for name, (u, its, _), ((x, serial_its), ams_its) in zip(names, got, refs):
        assert np.abs(u - x).max() <= 1e-10 * np.abs(x).max(), name
        if CASES[name][6] == "jacobi":
            assert abs(its - serial_its) <= max(3, serial_its // 10), (name, its, serial_its)
        else:
            assert its == ams_its, name
