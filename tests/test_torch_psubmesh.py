"""The port's sharded SubMesh transfer (``parallel/psubmesh``) and sharded
point evaluation (``parallel/pointeval``) over 2 and 4 spawned gloo ranks
(``launch.spawn``, started together in background threads while JAX
builds its tables in this process), float64 on the CPU.

* ``build_sub``'s tables (the sub ``ParFESpace``, ``idx``, ``wmask``) and
  ``sub_partition`` / ``boundary_adjacent_elements`` are bitwise JAX's
  (``tests/test_psubmesh.py``'s problems: domain submeshes of the
  two-material 3×3×3 hex mesh at orders 1–3, the z = 1 boundary sheet at
  order 2).
* ``transfer_to_sub`` and ``transfer_to_parent`` (with the halo select) on
  the ranks, gathered to global vectors, are bitwise the serial transfer
  (the port's, itself bitwise JAX's).
* ``prepare`` / ``interpolate_sharded`` give every rank the serial point
  values within 1e-13 (``mesh/point_eval``, JAX's), points outside the
  mesh 0; the routing tables are bitwise JAX's ``prepare``'s.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.fem.gridfunction import project
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.mesh import submesh
from cardiac_ablation_ecm2_tpu_torch.mesh.point_eval import evaluate_at_points
from cardiac_ablation_ecm2_tpu_torch.parallel import launch, pfespace, pointeval, psubmesh

#: (submesh kind, attributes, order)
TRANSFERS = (("domain", (1,), 1), ("domain", (1,), 2), ("domain", (2,), 3),
             ("boundary", (6,), 2))
#: (dim, order) of the point sets; each set has two points outside
POINTS = ((2, 2), (3, 2), (2, 3))
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def two_material_3d(mod=tmesh):
    m = mod.make_cartesian_3d(3, 3, 3)
    cent = m.vertices[m.elements].mean(axis=1)
    return mod.Mesh(geom=m.geom, vertices=m.vertices, elements=m.elements,
                    attributes=np.where(cent[:, 0] < 0.5, 1, 2), boundary=m.boundary,
                    bdr_attributes=m.bdr_attributes)


def parent_field(x):
    return x[..., 0] ** 2 + 2 * x[..., 1] - x[..., 2]


def transfer_problem(kind, attrs, order, world):
    """(parent space, sub space, submesh, parent ParFESpace, sub
    ParFESpace, ParTransferMap) of the port."""
    parent = two_material_3d()
    make = submesh.create_from_domain if kind == "domain" else submesh.create_from_boundary
    sm = make(parent, list(attrs))
    pfes, sfes = FESpace(parent, order), FESpace(sm.mesh, order)
    ppf = pfespace.build(pfes, world)
    spf, pt = psubmesh.build_sub(ppf, sm, sfes)
    return pfes, sfes, sm, ppf, spf, pt


def point_problem(dim, order, world):
    mesh = tmesh.make_cartesian_2d(4, 4) if dim == 2 else tmesh.make_cartesian_3d(3, 3, 3)
    fes = FESpace(mesh, order)
    pts = np.random.default_rng(dim).uniform(0.05, 0.95, size=(40, dim))
    pts = np.concatenate([pts, np.full((1, dim), 2.5), np.full((1, dim), -1.0)])
    return fes, pfespace.build(fes, world), pts


def point_field(x):
    return np.sin(2 * x[..., 0]) + x[..., 1] ** 2


def _rank_cases(rank, world, dev):
    """Every transfer and point evaluation of one world size on this rank:
    the rank's sub and parent local vectors, and the point values."""
    out = {}
    for case in TRANSFERS:
        pfes, sfes, sm, ppf, spf, pt = transfer_problem(*case, world)
        up = project(pfes, parent_field, dtype="float64", device="cpu").numpy()
        ls = ppf.local(rank, dev, "float64")
        idx, wmask = pt.local(rank, dev, "float64")
        up_loc = torch.as_tensor(pfespace.scatter_global(ppf, up)[rank], device=dev)
        us = psubmesh.transfer_to_sub(idx, up_loc)
        up2 = psubmesh.transfer_to_parent(idx, us * 2.0, up_loc, wmask, ls.halo)
        out[case] = (us.numpy(), up2.numpy())
    for dim, order in POINTS:
        fes, pf, pts = point_problem(dim, order, world)
        u = fes.dof_coords
        pe = pointeval.prepare(pf, pts)
        out[("points", dim, order)] = pointeval.interpolate_sharded(
            pe, point_field(u), device=dev, dtype="float64").numpy()
    return out


@pytest.fixture(scope="module")
def ranks():
    with ThreadPoolExecutor(2) as pool:
        yield {w: pool.submit(launch.spawn, _rank_cases, w, "cpu") for w in WORLDS}


@functools.lru_cache(maxsize=None)
def jax_transfer_tables(kind, attrs, order, world):
    """JAX's ``build_sub`` and ``sub_partition`` on the same problem, as
    numpy."""
    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.mesh import submesh as jsub
    from cardiac_ablation_ecm2_tpu.parallel import pfespace as jpf
    from cardiac_ablation_ecm2_tpu.parallel import psubmesh as jps

    parent = two_material_3d(jmesh)
    make = jsub.create_from_domain if kind == "domain" else jsub.create_from_boundary
    sm = make(parent, list(attrs))
    ppf = jpf.build(JFESpace(parent, order), world)
    spf, pt = jps.build_sub(ppf, sm, JFESpace(sm.mesh, order))
    return spf, np.asarray(pt.idx), np.asarray(pt.wmask), jps.sub_partition(ppf.parts, sm)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", TRANSFERS)
def test_transfer_tables_bitwise(case, world):
    _, _, sm, ppf, spf, pt = transfer_problem(*case, world)
    jspf, jidx, jwmask, jparts = jax_transfer_tables(*case, world)
    assert np.array_equal(psubmesh.sub_partition(ppf.parts, sm), jparts)
    for name in pfespace._TABLES:
        got, want = getattr(spf, name), getattr(jspf, name)
        if name == "perms":
            want = tuple(tuple(tuple(int(r) for r in pr) for pr in c) for c in want)
            assert got == want
        else:
            assert np.array_equal(np.asarray(got), np.asarray(want)), name
    assert np.array_equal(pt.idx, jidx) and np.array_equal(pt.wmask, jwmask)
    # the port's rank-local gather on JAX's tables: the same sub vectors
    pfes = ppf.fes
    up = pfespace.scatter_global(ppf, parent_field(pfes.dof_coords))
    jpt = psubmesh.ParTransferMap(idx=jidx, wmask=jwmask)
    for rank in range(world):
        ours, theirs = pt.local(rank, "cpu"), jpt.local(rank, "cpu")
        assert torch.equal(theirs[1], ours[1])
        u = torch.as_tensor(up[rank])
        assert torch.equal(psubmesh.transfer_to_sub(theirs[0], u),
                           psubmesh.transfer_to_sub(ours[0], u))


def test_boundary_adjacent_elements_equal_jax():
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.parallel.psubmesh import (
        boundary_adjacent_elements as jadj,
    )

    for make in ("make_cartesian_3d", "make_cartesian_3d_tet"):
        got = psubmesh.boundary_adjacent_elements(getattr(tmesh, make)(3, 2, 2))
        assert np.array_equal(got, jadj(getattr(jmesh, make)(3, 2, 2)))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", TRANSFERS)
def test_sharded_transfers_equal_serial(ranks, case, world):
    pfes, sfes, sm, ppf, spf, _ = transfer_problem(*case, world)
    up = project(pfes, parent_field, dtype="float64", device="cpu")
    tm = submesh.create_transfer_map(pfes, sfes, sm, device="cpu")
    us = tm.to_sub(up)
    up2 = tm.to_parent(us * 2.0, up)
    rows = ranks[world].result()
    us_par = pfespace.gather_global(spf, np.stack([r[case][0] for r in rows]))
    up2_par = pfespace.gather_global(ppf, np.stack([r[case][1] for r in rows]))
    assert np.array_equal(us_par, us.numpy())
    assert np.array_equal(up2_par, up2.numpy())
    # every rank holds the parent's values at its dofs, interface included
    for rank, r in enumerate(rows):
        g = ppf.loc2glob[rank]
        real = g >= 0
        assert np.array_equal(r[case][1][: ppf.nloc][real], up2.numpy()[g[real]])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dim,order", POINTS)
def test_sharded_point_values_equal_serial(ranks, dim, order, world):
    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.parallel import pfespace as jpf
    from cardiac_ablation_ecm2_tpu.parallel.pointeval import prepare as jprepare

    fes, pf, pts = point_problem(dim, order, world)
    u = point_field(fes.dof_coords)
    ref = evaluate_at_points(fes, u, pts)
    pe = pointeval.prepare(pf, pts)
    assert pe.found.tolist() == [True] * 40 + [False, False]
    for rank, r in enumerate(ranks[world].result()):
        vals = r[("points", dim, order)]
        assert np.abs(vals - ref).max() <= 1e-13, rank
        assert vals[-2] == 0.0 and vals[-1] == 0.0
    jmake = jmesh.make_cartesian_2d(4, 4) if dim == 2 else jmesh.make_cartesian_3d(3, 3, 3)
    je = jprepare(jpf.build(JFESpace(jmake, order), world), pts)
    for name in ("B", "slot", "out_idx", "found"):
        assert np.array_equal(getattr(pe, name), np.asarray(getattr(je, name))), name
    # a process with no group evaluates alone: the serial values
    one = pointeval.prepare(pfespace.build(fes, 1), pts)
    assert np.abs(pointeval.interpolate_sharded(one, u, device="cpu", dtype="float64")
                  .numpy() - ref).max() <= 1e-13
