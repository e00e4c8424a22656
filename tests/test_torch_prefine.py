"""The port's parallel uniform refinement (``parallel/refine``:
``refine_uniform``, ``ParHTransfer``) against the JAX package's, float64
on the CPU, on ``tests/test_prefine.py``'s cases: the 4 × 4 quads at
order 2 and the 2 × 2 × 2 hexes at order 1.

The port's ranks are gloo processes (``launch.spawn``, one spawn per world
size, 2 and 4, started in a background thread while JAX works in this
process).  The fine space's host tables, the child slots and the child
interpolation are bitwise those of JAX's ``refine_uniform``; every rank's
fine local L-vector (halo-consistent) equals the local rows of JAX's
serial ``HTransfer.prolongate`` to 1e-12, the bar ``tests/test_prefine.py``
holds JAX's sharded prolongation to against the same serial transfer.
(JAX's ``shard_map`` of the prolongation compiles for ~13 s a case on the
CPU, too long to run here for every case.)"""

from concurrent.futures import ThreadPoolExecutor
import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.fem.transfer import HTransfer
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.parallel import launch, pfespace
from cardiac_ablation_ecm2_tpu_torch.parallel.refine import refine_uniform


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: (dim, order) of each case
CASES = ((2, 2), (3, 1))
WORLDS = (2, 4)


def _mesh(m, dim):
    return m.make_cartesian_2d(4, 4) if dim == 2 else m.make_cartesian_3d(2, 2, 2)


def _coarse_field(n, dim, order):
    return np.random.default_rng(dim * 10 + order).standard_normal(n)


# ----------------------------------------------------------------------------
# rank body (runs in the spawned gloo ranks)
# ----------------------------------------------------------------------------


def _rank_cases(rank, world, dev):
    """Every case on this rank: its fine local L-vector from the coarse
    field's local row."""
    out = {}
    for dim, order in CASES:
        fes = FESpace(_mesh(tmesh, dim), order)
        pf = pfespace.build(fes, world)
        pf_f, pt = refine_uniform(pf)
        uc = _coarse_field(fes.ndof_scalar, dim, order)
        uc_loc = torch.as_tensor(pfespace.scatter_global(pf, uc)[rank])
        lt = pt.local(rank, dev, "float64")
        out[(dim, order)] = lt.prolongate(uc_loc).numpy()
        # a second call reuses the counts: the same result
        assert torch.equal(lt.prolongate(uc_loc), torch.as_tensor(out[(dim, order)]))
    return out


@pytest.fixture(scope="module")
def ranks():
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        yield {w: pool.submit(launch.spawn, _rank_cases, w, "cpu") for w in WORLDS}


def _jax_refinement(dim, order, ndev):
    """JAX's refine_uniform tables and its serial HTransfer prolongation
    of the coarse field (jitted)."""
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.fem.transfer import HTransfer as JHTransfer
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.parallel import pfespace as jpfespace
    from cardiac_ablation_ecm2_tpu.parallel.refine import refine_uniform as jrefine

    fes = JFESpace(_mesh(jmesh, dim), order)
    pf_f, pt = jrefine(jpfespace.build(fes, ndev))
    uc = _coarse_field(fes.ndof_scalar, dim, order)
    uf = jax.jit(JHTransfer(fes, pf_f.fes).prolongate)(jnp.asarray(uc))
    return pf_f, pt, np.asarray(uf)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dim,order", CASES)
def test_refine_uniform_equals_jax(ranks, dim, order, world):
    jpf_f, jpt, juf = _jax_refinement(dim, order, world)
    fes = FESpace(_mesh(tmesh, dim), order)
    pf = pfespace.build(fes, world)
    pf_f, pt = refine_uniform(pf)
    for name in pfespace._TABLES:
        a, b = getattr(pf_f, name), getattr(jpf_f, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert a == b, name
    assert np.array_equal(pt.child_slot, np.asarray(jpt.child_slot))
    assert np.abs(pt.I - np.asarray(jpt.I)).max() <= 1e-15
    # children stay on their parent's rank
    nchild = pf_f.fes.mesh.ne // fes.mesh.ne
    assert np.array_equal(pf_f.parts, np.tile(pf.parts, nchild))
    rows = np.stack([r[(dim, order)] for r in ranks[world].result()])
    scale = np.abs(juf).max()
    assert np.abs(rows - pfespace.scatter_global(pf_f, juf)).max() <= 1e-12 * scale
    uc = _coarse_field(fes.ndof_scalar, dim, order)
    serial = HTransfer(fes, pf_f.fes, "float64", "cpu").prolongate(torch.as_tensor(uc))
    assert np.abs(serial.numpy() - juf).max() <= 1e-12 * scale
