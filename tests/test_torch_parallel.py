"""The port's sharded layer (``parallel/partition``, ``pfespace``, ``ops``,
``poisson``, ``pmg``, ``rebalance``, ``launch`` and ``entry.dryrun_multichip``)
against the JAX package, float64 on the CPU.

The port's ranks are gloo processes (``launch.spawn``, one spawn per world
size, started in a background thread when the first test asks, while the
JAX side compiles in this process on the conftest's virtual devices).  The
rank bodies live in this module, which imports JAX only inside the tests,
so that no rank loads it.

Tolerances: the host tables bitwise; the halo-assembled E→L sum on every
rank to 1e-12·max|y| of the serial sum (the summation order differs); the
sharded Poisson solve with every preconditioner to 1e-10·max|u| of JAX's
sharded solve with equal CG counts (both sides sum in other orders, and
the differences pass through the CG iterations); the rebalance transfer
exactly.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import (
    make_cardiac_hex_mesh,
    make_cardiac_tet_mesh,
)
from cardiac_ablation_ecm2_tpu_torch.parallel import launch, partition, pfespace
from cardiac_ablation_ecm2_tpu_torch.parallel import ops as pops
from cardiac_ablation_ecm2_tpu_torch.parallel import poisson as ppoisson
from cardiac_ablation_ecm2_tpu_torch.parallel import rebalance


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L = 0.04
MESH_KW = dict(lengths=(L, L, L / 2), electrode_radius=0.004)
PRECONDS = ("jacobi", "chebyshev", "pmg", "lor")
POISSON = dict(order=2, rel_tol=1e-10)


def _mesh(pkg, kind):
    """The cardiac hex n=4 or tet n=8 mesh from the makers of ``pkg``."""
    if pkg == "jax":
        from cardiac_ablation_ecm2_tpu.mesh import cardiac as jcardiac

        return (jcardiac.make_cardiac_hex_mesh(4, **MESH_KW) if kind == "hex"
                else jcardiac.make_cardiac_tet_mesh(8, **MESH_KW))
    return (make_cardiac_hex_mesh(4, **MESH_KW) if kind == "hex"
            else make_cardiac_tet_mesh(8, **MESH_KW))


@functools.lru_cache(maxsize=None)
def _spaces(kind):
    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace

    return (JFESpace(_mesh("jax", kind), 2), FESpace(_mesh("torch", kind), 2))


def _weights(ne):
    return np.linspace(1.0, 5.0, ne) ** 2


# ----------------------------------------------------------------------------
# rank bodies (run in the spawned gloo ranks)
# ----------------------------------------------------------------------------


def _rank_cases(rank, world, dev):
    """Every case of one world size on this rank."""
    fes = FESpace(_mesh("torch", "hex"), 2)
    pf = pfespace.build(fes, world)
    loc = pf.local(rank, dev, torch.float64)
    # the halo-assembled E→L sum of a seeded random E-vector (pad elements
    # weighted out, as the JAX test does)
    E = np.random.default_rng(0).random(fes.gather_map.shape)
    Es = torch.as_tensor(E[pf.elems[rank]] * pf.elem_weight[rank][:, None])
    y = loc.halo(pops.local_scatter(Es, loc.restr, loc.nloc))
    out = dict(halo=y.numpy(), loc2glob=pf.loc2glob[rank])
    if world == 2:
        mesh = fes.mesh
        for pc in PRECONDS:
            u, its, _ = ppoisson.setup(mesh, precond=pc, device=dev,
                                       dtype="float64", **POISSON).solve()
            out[f"poisson_{pc}"] = (u, its)
        pf_new = rebalance.repartition(pf, _weights(mesh.ne))
        u = np.random.default_rng(1).random(fes.ndof_scalar)
        u_old = torch.as_tensor(pfespace.scatter_global(pf, u)[rank])
        u_new = rebalance.transfer_map(pf, pf_new, rank, dev)(u_old)
        out["rebalance"] = (u_new.numpy(), pfespace.scatter_global(pf_new, u)[rank])
    return out


@pytest.fixture(scope="module")
def ranks():
    """The spawned runs' futures by world size, started together."""
    with ThreadPoolExecutor(3) as pool:
        yield {w: pool.submit(launch.spawn, _rank_cases, w, "cpu")
               for w in (2, 3, 4)}


# ----------------------------------------------------------------------------
# host tables
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("ndev", [2, 3, 4])
@pytest.mark.parametrize("kind", ["hex", "tet"])
def test_tables_bitwise(kind, ndev):
    """partition_mesh, rcb_weighted and every table of build equal JAX's."""
    from cardiac_ablation_ecm2_tpu.parallel import partition as jpartition
    from cardiac_ablation_ecm2_tpu.parallel import pfespace as jpfespace

    jfes, tfes = _spaces(kind)
    jm, tm = jfes.mesh, tfes.mesh
    assert np.array_equal(partition.partition_mesh(tm, ndev),
                          jpartition.partition_mesh(jm, ndev))
    w = _weights(tm.ne)
    assert np.array_equal(
        partition.rcb_weighted(partition.element_centroids(tm), w, ndev),
        jpartition.rcb_weighted(jpartition.element_centroids(jm), w, ndev))
    jpf = jpfespace.build(jfes, ndev)
    tpf = pfespace.build(tfes, ndev)
    for name in pfespace._TABLES + ("scat_perm", "scat_seg", "node_coords"):
        a, b = getattr(tpf, name), getattr(jpf, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert a == b, name
    # the same tables carried across, and the state helpers' round trip
    cpf = pfespace.from_jax_tables(tfes, jpf)
    assert all(np.array_equal(getattr(cpf, n), getattr(tpf, n))
               for n in pfespace._TABLES if n != "perms") and cpf.perms == tpf.perms
    u = np.random.default_rng(ndev).random(tfes.ndof_scalar)
    stacked = jpfespace.scatter_global(jpf, u)
    rows = [pfespace.local_state(stacked, r, "cpu", "float64") for r in range(ndev)]
    assert np.array_equal(pfespace.stack_states(rows), stacked)
    assert np.array_equal(pfespace.gather_global(tpf, stacked), u)


# ----------------------------------------------------------------------------
# over gloo ranks
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 3, 4])
def test_halo_equals_serial_sum(ranks, world):
    """Local E→L sum plus halo exchange on every rank equals the serial Rᵀ
    at every dof the rank holds; the trash slot reads 0."""
    fes = _spaces("hex")[1]
    E = np.random.default_rng(0).random(fes.gather_map.shape)
    y = np.zeros(fes.ndof_scalar)
    np.add.at(y, fes.gather_map, E)
    for r in ranks[world].result():
        g = r["loc2glob"]
        real = g >= 0
        assert np.abs(r["halo"][:-1][real] - y[g[real]]).max() <= 1e-12 * y.max()
        assert r["halo"][-1] == 0.0


@pytest.mark.parametrize("precond", PRECONDS)
def test_poisson_matches_jax(ranks, precond):
    """The sharded Poisson solve over 2 ranks against JAX's at ndev 2."""
    from cardiac_ablation_ecm2_tpu.parallel import poisson as jpoisson

    uj, itj, _ = jpoisson.setup(_mesh("jax", "hex"), ndev=2, precond=precond,
                                **POISSON).solve()
    u, its = ranks[2].result()[0][f"poisson_{precond}"]
    assert its == itj
    assert np.abs(u - uj).max() <= 1e-10 * np.abs(uj).max()


def test_rebalance_transfer_exact(ranks):
    """The old → new transfer over 2 ranks gives each rank exactly the new
    partition's scatter of the global field; repartition equals JAX's."""
    from cardiac_ablation_ecm2_tpu.parallel import pfespace as jpfespace
    from cardiac_ablation_ecm2_tpu.parallel import rebalance as jrebalance

    jfes, tfes = _spaces("hex")
    w = _weights(tfes.mesh.ne)
    jnew = jrebalance.repartition(jpfespace.build(jfes, 2), w)
    tnew = rebalance.repartition(pfespace.build(tfes, 2), w)
    assert np.array_equal(tnew.parts, jnew.parts)
    for r in ranks[2].result():
        got, expect = r["rebalance"]
        assert np.array_equal(got, expect)


def test_dryrun_multichip_cpu():
    """One sharded SDIRK33 step over 2 gloo ranks: finite, and the source
    heats."""
    from cardiac_ablation_ecm2_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(2, device="cpu")
    assert out.shape == (405,) and np.isfinite(out).all() and out.max() > 37.0


def test_world_larger_than_card_count_raises(monkeypatch):
    """``init`` on the card refuses a world larger than the card count, as
    ``dryrun_multichip`` does, before touching a card or a process group."""
    from cardiac_ablation_ecm2_tpu_torch.entry import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        launch.init(None, rank=0, world=2)
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        dryrun_multichip(2)


def test_torchrun_rank_takes_its_local_card(monkeypatch):
    """Under ``torchrun`` on several hosts a rank takes the card of its
    ``LOCAL_RANK``, and only the ranks of its own host count against the
    card count."""
    picked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    monkeypatch.setattr(launch.dist, "is_initialized", lambda: True)
    for k, v in dict(RANK=5, WORLD_SIZE=8, LOCAL_RANK=1,
                     LOCAL_WORLD_SIZE=2).items():
        monkeypatch.setenv(k, str(v))
    assert launch.init(None) == torch.device("cuda", 1) and picked == [1]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="needs 4 cards"):
        launch.init(None)


def test_prebuilt_space_must_be_the_mesh_order_space():
    """``fes=`` of the sharded setups is taken only as the order-``order``
    space of ``mesh``."""
    mesh = make_cardiac_hex_mesh(2, **MESH_KW)
    fes = FESpace(mesh, 2)
    assert pfespace.space_of(mesh, 2, fes) is fes
    with pytest.raises(ValueError, match="order-1 space"):
        pfespace.space_of(mesh, 1, fes)
    with pytest.raises(ValueError, match="order-2 space"):
        pfespace.space_of(make_cardiac_hex_mesh(2, **MESH_KW), 2, fes)


def test_rk_stepper_takes_explicit_stages_as_zero_gamma_solves():
    """An explicit stage (a_ii = 0) is the stage solve at γ = 0, as the JAX
    package's unrolled step takes it; a solver without a tableau raises."""
    gammas = []

    def solve(gamma, y):
        gammas.append(gamma)
        return -y

    T, t = pops.rk_stepper("rk4", solve)(torch.ones(3, dtype=torch.float64),
                                         0.0, 0.5)
    assert gammas == [0.0] * 4 and t == 0.5
    assert torch.allclose(T, torch.full((3,), 1 - 0.5 + 0.125 - 0.5 ** 3 / 6
                                        + 0.5 ** 4 / 24, dtype=torch.float64))
    gammas.clear()
    pops.rk_stepper("sdirk33", solve)(torch.ones(3, dtype=torch.float64), 0.0, 0.5)
    assert len(gammas) == 3 and all(g > 0 for g in gammas)
    with pytest.raises(ValueError, match="Butcher tableau"):
        pops.rk_stepper("imex_euler", solve)
