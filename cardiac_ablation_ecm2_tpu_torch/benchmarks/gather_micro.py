"""The Mosaic gather probes of the JAX package (``benchmarks/gather_micro2.py``,
``gather_micro3.py``, ``gather_micro4.py``) on the port's gathers:

    python -m cardiac_ablation_ecm2_tpu_torch.benchmarks.gather_micro [--n 48] [--order 2]

P0–P3 gather the L→E map of ``FESpace(make_cartesian_3d(n, n, n), order)``
(``gather_micro2.py``); T1–T4 and U1–U5 use the fixed shapes and seeds of
``gather_micro3.py`` and ``gather_micro4.py`` (``np.random.default_rng(0)``,
drawn in the same order, with the same padding).  The probes that ran a
Pallas kernel run the port's kernels (``ops/gather_probes.py``): P1
``take_flat``, T1 and U1 ``take_along_rows``, T2 and U2 ``take_along_lanes``,
U3 and U5 ``take_rows``.  The XLA-level probes (P0, P2, P3, T3, T4, U4)
become the PyTorch calls they are.  U6 (``pltpu.roll``, a TPU lane rotate)
has no counterpart.

One line per probe: the device time of one call (``cuda_ms``: calls queued
behind a sleep kernel, so the host's launch cost does not show) and the
largest difference from the probe's numpy reference.  On the CPU
(``--device cpu``) the outputs are checked but not timed.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ops import gather_probes as gp

# gather_micro3.py / gather_micro4.py shapes
R, B, C = 7136, 23328, 128
T_BLK = 512                 # gather_micro3.py's output block
U2_WIDTHS = (256, 512, 1024)


@dataclasses.dataclass(eq=False)
class Probe:
    """One probe: ``fn(*args)`` and, where it has them, the numpy reference,
    the port function's plain version and the one PyTorch call computing
    the same function (a yardstick, timed only)."""

    name: str
    fn: Callable
    args: tuple
    ref: Optional[np.ndarray] = None
    plain: Optional[Callable] = None
    library: Optional[Callable] = None
    kernel: Optional[str] = None      # the ops/gather_probes.py function


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _i(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)


def flat_probes(n: int, order: int, device) -> List[Probe]:
    """P0–P3 (``gather_micro2.py``) on the L→E map of the n³ unit cube."""
    from ..fem.fespace import FESpace
    from ..mesh.mesh import make_cartesian_3d

    fes = FESpace(make_cartesian_3d(n, n, n), order)
    gmap = fes.gather_map
    ndof, nidx = fes.ndof, gmap.size
    u = torch.arange(ndof, dtype=torch.float32, device=device) * 1e-6
    u_np = u.cpu().numpy()
    flat = gmap.reshape(-1).astype(np.int32)
    big = torch.ones(nidx, dtype=torch.float32, device=device)

    blk = 8 * 2048
    nblk = (nidx + blk - 1) // blk
    idx_pad = np.concatenate([flat, np.zeros(nblk * blk - nidx, np.int32)])
    shape = (nblk, 128, blk // 128)
    idx2 = _i(idx_pad.reshape(shape), device)
    nup = (ndof + 127) // 128 * 128
    u_pad = torch.cat([u, u.new_zeros(nup - ndof)])
    u_pad_np = u_pad.cpu().numpy()
    idx2_long = idx2.reshape(-1).long()

    nr = (ndof + 7) // 8
    u2 = torch.cat([u, u.new_zeros(nr * 8 - ndof)]).view(nr, 8)
    rows = torch.as_tensor(flat // 8, device=device).long()
    lanes = torch.as_tensor(flat % 8, device=device).long()[:, None]
    gm_t = torch.as_tensor(np.ascontiguousarray(gmap.T), device=device).long()

    return [
        Probe("P0 elementwise baseline", lambda x: x * 2.0 + 1.0, (big,)),
        Probe("P1 take_flat (u[idx])", gp.take_flat, (u_pad, idx2),
              ref=u_pad_np[idx_pad].reshape(shape), plain=gp.take_flat_plain,
              library=lambda: u_pad.index_select(0, idx2_long),
              kernel="take_flat"),
        Probe("P2 row-8 gather", lambda: torch.gather(u2[rows], 1, lanes)[:, 0], (),
              ref=u_np[flat]),
        Probe("P3 transposed gather", lambda: u[gm_t], (),
              ref=u_np[np.ascontiguousarray(gmap.T)]),
    ]


def table_probes(device) -> List[Probe]:
    """T1–T4 (``gather_micro3.py``) and U1–U5 (``gather_micro4.py``)."""
    out = []
    rng = np.random.default_rng(0)                       # gather_micro3.py
    table_np = rng.standard_normal((R, C)).astype(np.float32)
    idx0_np = rng.integers(0, R, (B, C))
    idx1_np = rng.integers(0, C, (B, C))
    mat_np = rng.standard_normal((B, C)).astype(np.float32)
    nblk = B // T_BLK + (B % T_BLK > 0)
    pad = ((0, nblk * T_BLK - B), (0, 0))
    idx0p_np, idx1p_np = np.pad(idx0_np, pad), np.pad(idx1_np, pad)
    matp_np = np.pad(mat_np, pad)
    table, mat = _t(table_np, device), _t(mat_np, device)
    idx0p, idx1p, matp = _i(idx0p_np, device), _i(idx1p_np, device), _t(matp_np, device)
    idx0p_l, idx1p_l = idx0p.long(), idx1p.long()
    idx0m, idx1 = _i(idx0_np % R, device).long(), _i(idx1_np, device).long()
    out += [
        Probe("T1 take_along_rows (axis 0)", gp.take_along_rows, (table, idx0p),
              ref=np.take_along_axis(table_np, idx0p_np % R, axis=0),
              plain=gp.take_along_rows_plain,
              library=lambda: torch.gather(table, 0, idx0p_l),
              kernel="take_along_rows"),
        Probe("T2 take_along_lanes (axis 1)", gp.take_along_lanes, (matp, idx1p),
              ref=np.take_along_axis(matp_np, idx1p_np, axis=1),
              plain=gp.take_along_lanes_plain,
              library=lambda: torch.gather(matp, 1, idx1p_l),
              kernel="take_along_lanes"),
        Probe("T3 torch.gather axis 0", lambda: torch.gather(table, 0, idx0m), (),
              ref=np.take_along_axis(table_np, idx0_np % R, axis=0)),
        Probe("T4 torch.gather axis 1", lambda: torch.gather(mat, 1, idx1), (),
              ref=np.take_along_axis(mat_np, idx1_np, axis=1)),
    ]

    rng = np.random.default_rng(0)                       # gather_micro4.py
    ta_np = rng.standard_normal((512, 128)).astype(np.float32)
    ia_np = rng.integers(0, 512, (512, 128))
    ta, ia = _t(ta_np, device), _i(ia_np, device)
    ia_l = ia.long()
    out.append(Probe("U1 take_along_rows (512, 128)", gp.take_along_rows, (ta, ia),
                     ref=np.take_along_axis(ta_np, ia_np, axis=0),
                     plain=gp.take_along_rows_plain,
                     library=lambda: torch.gather(ta, 0, ia_l),
                     kernel="take_along_rows"))
    for W in U2_WIDTHS:
        nb = (3 * 10**6) // W
        m_np = rng.standard_normal((nb, W)).astype(np.float32)
        i_np = rng.integers(0, W, (nb, W // 8))
        blk = max(8, 4096 // (W // 128))
        keep = nb // blk * blk
        m_np, i_np = m_np[:keep], i_np[:keep]
        m, i = _t(m_np, device), _i(i_np, device)
        out.append(Probe(f"U2 take_along_lanes W={W}", gp.take_along_lanes, (m, i),
                         ref=np.take_along_axis(m_np, i_np, axis=1),
                         plain=gp.take_along_lanes_plain,
                         library=(lambda m=m, il=i.long(): torch.gather(m, 1, il)),
                         kernel="take_along_lanes"))
    t2_np = rng.standard_normal((R, 128)).astype(np.float32)
    rows_np = np.sort(rng.integers(0, R, 23328))
    t2, rows = _t(t2_np, device), _i(rows_np, device)
    rows_l = rows.long()
    for name in ("U3 take_rows", "U5 take_rows (dynamic-slice loop on the TPU)"):
        out.append(Probe(name, gp.take_rows, (t2, rows), ref=t2_np[rows_np],
                         plain=gp.take_rows_plain,
                         library=lambda: t2.index_select(0, rows_l),
                         kernel="take_rows"))
    out.insert(-1, Probe("U4 torch row gather", lambda: t2[rows_l], (),
                         ref=t2_np[rows_np]))
    return out


def probes(n: int = 48, order: int = 2, device=None) -> List[Probe]:
    """Every probe, P0–P3 then T1–T4 and U1–U5, inputs on ``device``."""
    return flat_probes(n, order, device) + table_probes(device)


def cuda_ms(fn: Callable, calls: int = 20, reps: int = 5) -> float:
    """Median device time of one ``fn()`` in ms.  The probes are kernels of
    a few microseconds, less than it takes Python to launch one, so one
    call between two CUDA events would time the launch: ``calls`` calls are
    queued behind a sleep kernel of ~10 ms and timed together, the median
    of ``reps`` such runs, after three warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def run(n: int = 48, order: int = 2, device=None) -> List[dict]:
    """Every probe once: prints one line each and returns, per probe, its
    name, the time (ms, None on the CPU) and the largest difference from its
    numpy reference (None where it has none)."""
    from ..utils.config import resolve_device

    device = resolve_device(device)
    results = []
    for p in probes(n, order, device):
        y = p.fn(*p.args)
        err = None
        if p.ref is not None:
            err = float(np.abs(y.cpu().numpy() - p.ref).max())
        ms = cuda_ms(lambda: p.fn(*p.args)) if device.type == "cuda" else None
        t = f"{ms:9.4f} ms" if ms is not None else "not timed (CPU)"
        e = f"   err={err:.1e}" if err is not None else ""
        print(f"{p.name:<48s} {t}{e}")
        results.append(dict(name=p.name, ms=ms, err=err))
    print(f"{'U6 pltpu.roll (TPU lane rotate)':<48s} no counterpart on the GPU")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--order", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    return run(args.n, args.order, args.device)


if __name__ == "__main__":
    main()
