"""The port's probe gathers (``ops/gather_probes.py``; their plain versions,
which CPU tensors take) against the numpy references of the JAX package's
Mosaic probes, at reduced shapes: ``gather_micro2.py:99`` (p1),
``gather_micro3.py:71-73`` (t1) and ``:104`` (t2), ``gather_micro4.py:58``
(u1), ``:99`` (u2), ``:140`` (u3) and ``:182`` (u5).  Gathers copy values,
so every comparison is bitwise."""

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.benchmarks import gather_micro
from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg
from cardiac_ablation_ecm2_tpu_torch.ops import gather_probes as gp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _same(out: torch.Tensor, ref: np.ndarray):
    out = out.numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert np.array_equal(out.view(np.uint8), np.ascontiguousarray(ref).view(np.uint8))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_take_flat_p1(dt):
    """p1: u padded to 128, indices padded with 0 into (nblk, 128, 128/…)."""
    rng = np.random.default_rng(0)
    ndof, nidx, blk = 1_001, 5_000, 8 * 64
    u = (np.arange(ndof) * 1e-6).astype(dt)
    flat = rng.integers(0, ndof, nidx).astype(np.int32)
    nblk = (nidx + blk - 1) // blk
    idx_pad = np.concatenate([flat, np.zeros(nblk * blk - nidx, np.int32)])
    nup = (ndof + 127) // 128 * 128
    u_pad = np.concatenate([u, np.zeros(nup - ndof, dt)])
    idx2 = idx_pad.reshape(nblk, 128, blk // 128)
    ref = u_pad[idx_pad].reshape(nblk, 128, blk // 128)
    before = (gp.take_flat.launches, bg.gather_sum.launches)
    _same(gp.take_flat(torch.from_numpy(u_pad), torch.from_numpy(idx2)), ref)
    _same(gp.take_flat_plain(torch.from_numpy(u_pad), torch.from_numpy(idx2)), ref)
    assert (gp.take_flat.launches, bg.gather_sum.launches) == before


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(71, 128, 233), (512, 128, 512), (5, 3, 17)])
def test_take_along_rows_t1_u1(dt, shape):
    """t1 (idx padded with zero rows, taken % R) and u1."""
    R, C, B = shape
    rng = np.random.default_rng(1)
    table = rng.standard_normal((R, C)).astype(dt)
    idx = rng.integers(0, R, (B, C))
    idxp = np.pad(idx, ((0, 7), (0, 0))).astype(np.int32)
    ref = np.take_along_axis(table, idxp % R, axis=0)
    _same(gp.take_along_rows(torch.from_numpy(table), torch.from_numpy(idxp)), ref)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("W,K", [(128, 128), (256, 32), (512, 64), (1024, 128), (3, 7)])
def test_take_along_lanes_t2_u2(dt, W, K):
    """t2 (K = W = 128) and u2 at every probe width W (K = W/8), and a
    narrow odd case."""
    rng = np.random.default_rng(W)
    B = 97
    mat = rng.standard_normal((B, W)).astype(dt)
    idx = rng.integers(0, W, (B, K)).astype(np.int32)
    ref = np.take_along_axis(mat, idx, axis=1)
    _same(gp.take_along_lanes(torch.from_numpy(mat), torch.from_numpy(idx)), ref)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_take_rows_u3_u5(dt):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((713, 128)).astype(dt)
    rows = np.sort(rng.integers(0, 713, 2_333)).astype(np.int32)
    _same(gp.take_rows(torch.from_numpy(table), torch.from_numpy(rows)), table[rows])


def test_cpu_takes_plain_versions_without_launch():
    t = torch.arange(12.0).view(4, 3)
    i2 = torch.tensor([[3, 0, 1]], dtype=torch.int32)
    counts = [f.launches for f in (gp.take_along_rows, gp.take_along_lanes,
                                    gp.take_rows, gp.take_flat)]
    assert gp.take_along_rows(t, i2).tolist() == [[9.0, 1.0, 5.0]]
    assert gp.take_along_lanes(t[:1], i2[:, 1:]).tolist() == [[0.0, 1.0]]
    assert gp.take_rows(t, i2[0]).tolist() == [[9.0, 10.0, 11.0], [0.0, 1.0, 2.0],
                                              [3.0, 4.0, 5.0]]
    assert gp.take_flat(t.reshape(-1), i2).tolist() == [[3.0, 0.0, 1.0]]
    assert counts == [f.launches for f in (gp.take_along_rows, gp.take_along_lanes,
                                            gp.take_rows, gp.take_flat)]


_FNS = [gp.take_along_rows, gp.take_along_lanes, gp.take_rows, gp.take_flat]
_BAD = ["int16_data", "int64_idx", "data_dim", "idx_dim", "width", "meta_device",
        "mixed_devices"]


@pytest.mark.parametrize("fn,bad", [
    (fn, bad) for fn in _FNS for bad in _BAD
    # take_flat takes indices of any shape; 1-D indices have no width to match
    if not (bad == "idx_dim" and fn is gp.take_flat)
    and not (bad == "width" and fn in (gp.take_rows, gp.take_flat))])
def test_rejects(fn, bad):
    """Bad dtypes, shapes and devices raise ``ValueError`` on every path."""
    one_d = fn in (gp.take_rows, gp.take_flat)
    data = torch.zeros(12) if fn is gp.take_flat else torch.zeros(4, 3)
    idx = torch.zeros(3 if one_d else (4, 3), dtype=torch.int32)
    if bad == "int16_data":
        data = data.to(torch.int16)
    elif bad == "int64_idx":
        idx = idx.long()
    elif bad == "data_dim":
        data = data.reshape(-1, 1, 1)
    elif bad == "idx_dim":
        idx = idx.reshape(-1, 1, 1)
    elif bad == "width":
        idx = torch.zeros((5, 2), dtype=torch.int32)
    elif bad == "meta_device":
        data, idx = data.to("meta"), idx.to("meta")
    else:
        idx = idx.to("meta")
    with pytest.raises(ValueError):
        fn(data, idx)


def test_benchmark_entry_on_cpu(capsys):
    """``python -m …benchmarks.gather_micro``'s probes on the CPU at their
    own table shapes (P0–P3 at n=3): every output equals its probe's numpy
    reference, and U6 is printed as having no counterpart."""
    rows = gather_micro.main(["--n", "3", "--device", "cpu"])
    names = [r["name"][:2] for r in rows]
    assert names == ["P0", "P1", "P2", "P3", "T1", "T2", "T3", "T4", "U1", "U2",
                     "U2", "U2", "U3", "U4", "U5"]
    assert all(r["err"] == 0.0 for r in rows if r["err"] is not None)
    assert all(r["ms"] is None for r in rows)
    assert "U6" in capsys.readouterr().out
