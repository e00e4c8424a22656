"""The port's sharded NC Poisson (``parallel/pnc``) and ``pfespace.build``'s
``extra_dofs`` against the JAX package, float64 on the CPU.

The ranks are gloo processes (``launch.spawn``, 2 and 4 ranks, started
together in background threads while JAX works in this process).  As
``tests/test_pnc.py`` holds JAX's sharded solve, each sharded solution
(Jacobi-PCG to rel_tol 1e-12) is held within 1e-8·max|u| of JAX's serial
NCFESpace solve of the same problem (unpreconditioned, so the counts
differ by design), for (order, rounds) = (1, 2), (2, 2), (3, 1) on the
nested-corner quad mesh.  The ghost layer and every table of the
partitioned space equal JAX's ``pnc.setup``'s; the dryrun's part (a) runs
on the same ranks and is finite."""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem.ncfespace import NCFESpace
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d
from cardiac_ablation_ecm2_tpu_torch.mesh.ncmesh import make_nc, refine_quads
from cardiac_ablation_ecm2_tpu_torch.parallel import launch, partition, pfespace, pnc

CASES = ((1, 2), (2, 2), (3, 1))
TABLES = ("parts", "ne_loc", "nloc", "ncolors", "max_shared", "elems",
          "elem_weight", "gather", "loc2glob", "dof_weight", "send_idx")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nc_mesh(rounds, mod=None, n=4):
    """``tests/test_pnc.py``'s nested-corner quad mesh, in ``mod``'s package
    (the port's by default)."""
    make, refine, nc_of = mod or (make_cartesian_2d, refine_quads, make_nc)
    nc = nc_of(make(n, n))
    for r in range(rounds):
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        marks = (cent[:, 0] < 0.5 ** (r + 1)) & (cent[:, 1] < 0.5 ** (r + 1))
        nc, _ = refine(nc, marks)
    return nc


def _rank_cases(rank, world, dev):
    """Every sharded solve of one world size on this rank, and the dryrun's
    part (a)."""
    from cardiac_ablation_ecm2_tpu_torch.entry import _dryrun_nc

    out = {}
    for order, rounds in CASES:
        sp = NCFESpace(nc_mesh(rounds), order, device=dev)
        solver = pnc.setup(sp, rel_tol=1e-12, dtype="float64", device=dev)
        u, its, _ = solver.solve()
        out[(order, rounds)] = (u, its, solver.restr is not None)
    out["dryrun_a"] = _dryrun_nc(dev)
    return out


@pytest.fixture(scope="module")
def ranks():
    with ThreadPoolExecutor(2) as pool:
        yield {w: pool.submit(launch.spawn, _rank_cases, w, "cpu") for w in (2, 4)}


@functools.lru_cache(maxsize=None)
def jax_space(order, rounds):
    from cardiac_ablation_ecm2_tpu.fem.ncfespace import NCFESpace as JNCFESpace
    from cardiac_ablation_ecm2_tpu.mesh import make_cartesian_2d as jmake
    from cardiac_ablation_ecm2_tpu.mesh.ncmesh import make_nc as jmake_nc
    from cardiac_ablation_ecm2_tpu.mesh.ncmesh import refine_quads as jrefine

    return JNCFESpace(nc_mesh(rounds, (jmake, jrefine, jmake_nc)), order)


def jax_serial(order, rounds):
    """``tests/test_pnc.py``'s serial solve: JAX's tables and FULL assembly,
    f = 1, u = 0 on the boundary, its cg recurrence (rel_tol 1e-12)."""
    import scipy.sparse as sps

    from cardiac_ablation_ecm2_tpu.ops import BilinearForm as JBilinearForm
    from cardiac_ablation_ecm2_tpu.ops.linearform import domain_lf as jdomain_lf
    from test_torch_ncfespace import np_cg

    js = jax_space(order, rounds)
    fes = js.fes
    A = JBilinearForm(fes).add_domain_integrator("diffusion").assemble_matrix()
    nL, nC = fes.ndof_scalar, js.ndof_conf
    si, sm = np.asarray(js._slave_idx), np.asarray(js._slave_masters)
    P = sps.csr_matrix(
        (np.concatenate([np.ones(nC), np.asarray(js._slave_w).reshape(-1)]),
         (np.concatenate([js.L_of_conf, np.repeat(si, sm.shape[1])]),
          np.concatenate([np.arange(nC), sm.reshape(-1)]))), shape=(nL, nC))
    AC = (P.T @ A @ P).tocsr()
    m = np.ones(nC)
    m[js.essential_dofs()] = 0.0
    b = (P.T @ np.asarray(jdomain_lf(fes, lambda x: 1.0 + 0 * np.asarray(x)[..., 0]))) * m
    u, _ = np_cg(lambda x: AC @ (x * m) * m + x * (1 - m), b, 1e-12, 4000)
    return u


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("order,rounds", CASES)
def test_sharded_nc_equals_jax_serial(ranks, world, order, rounds):
    u_ref = jax_serial(order, rounds)
    res = ranks[world].result()
    u, its, _ = res[0][(order, rounds)]
    assert all(r[(order, rounds)][0] is None for r in res[1:])
    assert 0 < its < 3000
    assert np.abs(u - u_ref).max() < 1e-8 * np.abs(u_ref).max()


@pytest.mark.parametrize("world", [2, 4])
def test_ghost_layer_equals_jax(world):
    """``ghost_masters`` and every table of ``build(..., extra_dofs=...)``
    equal those of JAX's ``pnc.setup`` (its ``ParFESpace``); at p = 2 some
    rank imports ghost masters."""
    import jax

    from cardiac_ablation_ecm2_tpu.parallel import pnc as jpnc

    jsp = jax_space(2, 2)
    jpf = jpnc.setup(jsp, ndev=world, devices=jax.devices("cpu")).pf
    sp = NCFESpace(nc_mesh(2), 2, device="cpu")
    parts = partition.partition_mesh(sp.fes.mesh, world)
    extra = pnc.ghost_masters(sp, parts, world)
    assert sum(len(e) for e in extra) > 0
    pf = pfespace.build(sp.fes, world, parts, extra_dofs=extra)
    for name in TABLES:
        assert np.array_equal(np.asarray(getattr(pf, name)),
                              np.asarray(getattr(jpf, name))), name
    assert pf.perms == tuple(tuple(tuple(int(x) for x in pr) for pr in c)
                             for c in jpf.perms)
    gm = sp.fes.gather_map.astype(np.int64)
    grew = [len(pf.loc2glob[d][pf.loc2glob[d] >= 0])
            > len(np.unique(gm[pf.parts == d])) for d in range(world)]
    assert any(grew)


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_part_a(ranks, world):
    """``entry.dryrun_multichip``'s part (a) on the ranks: finite, the
    conforming size of the order-2 space, u > 0 inside (f = 1, u = 0 on the
    boundary); rank 0 alone holds the result."""
    res = ranks[world].result()
    u = res[0]["dryrun_a"]
    sp = NCFESpace(nc_mesh(1), 2, device="cpu")
    assert u.shape == (sp.ndof_conf,) and np.isfinite(u).all() and u.max() > 0
    assert all(r["dryrun_a"] is None for r in res[1:])
