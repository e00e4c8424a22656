"""Two sparse matrices on one pattern, applied as ``y = (c0·M0 + c1·M1) x``
(counterpart of ``MultiELLPair`` in ``cardiac_ablation_ecm2_tpu/ops/ell.py``).

The bioheat stage operator (M_ρc + γ(K + M_ω)) on tets is exactly this
shape: both matrices share the FE connectivity pattern, γ changes per solve.
The contract is the JAX package's: natural row and column numbering in and
out, a sentinel column reads 0, nothing is scattered.  The layout is the
port's own, a sliced ELL that fits a GPU:

* rows are grouped by their nnz into width buckets, one per 8 entries up
  to 128 (then the widest row); a bucket keeps its rows in natural order
  and is as wide as its widest row, J_b.  On the order-2 tet stencils that
  pads the slots by 10% (JAX's edges 8, 16, 24, 32, 48, 64, 96, 128: 17%);
* bucket b holds int32 column planes (J_b, n_b) (sentinel n in the padding),
  the two aligned weight planes, and the natural row id of each of its rows,
  so the kernel writes every output row once and nothing unpermutes.

The planes of all buckets are concatenated, widest bucket first: its
blocks are scheduled first, so the long rows do not trail at the end of
the launch (PERF.md).
``meta`` (nbuckets, 5) int64 holds each bucket's row offset, rows, width,
first slot and first block.

:func:`ell_spmv` dispatches on the device of ``x``: a CUDA tensor runs the
hand-written kernel ``csrc/ell_spmv.cu`` (built with nvcc for ``sm_90a``
into ``build/cuda/`` on first use), a CPU tensor runs
:func:`ell_spmv_plain`.  Nothing falls back: a CUDA call that cannot build
or launch the kernel raises.  Both versions take the same rounded
operations in the same order, so on the card they agree bitwise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from ..utils.config import real_t, resolve_device

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "ell_spmv.cu")
_LIB = None
#: rows per CUDA block; the kernel checks it equals its own constant
ROWS_PER_BLOCK = 256
BUCKET_EDGES = tuple(range(8, 129, 8))


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is None:
        from ..utils.native import build_cuda

        lib = build_cuda(_SRC, "ell_spmv")
        ptrs = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 5
        for name, real in (("ell_spmv_f32", ctypes.c_float),
                           ("ell_spmv_f64", ctypes.c_double)):
            fn = getattr(lib, name)
            fn.argtypes = ptrs + [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                  real, real, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.ell_spmv_error_string.argtypes = [ctypes.c_int]
        lib.ell_spmv_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@dataclasses.dataclass(frozen=True, eq=False)
class MultiELLPair:
    """A pair of n×n matrices in sliced-ELL form on one device."""

    n: int
    nnz: int                  # entries of the union pattern
    cols: torch.Tensor        # (slots,) int32, plane-major per bucket
    w0: torch.Tensor          # (slots,) weights of M0
    w1: torch.Tensor          # (slots,) weights of M1
    row_ids: torch.Tensor     # (n,) int32 natural row of each bucket row
    meta: torch.Tensor        # (nbuckets, 5) int64 on the device
    buckets: Tuple[Tuple[int, int, int, int, int], ...]   # meta on the host
    nblocks: int
    diag0: torch.Tensor       # (n,) natural diagonals of each matrix
    diag1: torch.Tensor

    @staticmethod
    def from_csr_pair(M0, M1, dtype="float32", device=None) -> "MultiELLPair":
        """Pack two scipy sparse matrices on the union of their patterns,
        with explicit zeros where one of them has no entry (host, setup
        time); ``device=None`` is the card."""
        import scipy.sparse as sp

        device = resolve_device(device)
        dt = real_t(dtype)
        M0 = sp.csr_matrix(M0)
        M1 = sp.csr_matrix(M1)
        n = M0.shape[0]
        P = (abs(M0) + abs(M1)).tocsr()
        P.sort_indices()
        big = np.int64(P.shape[1] + 1)
        pkeys = np.repeat(np.arange(n, dtype=np.int64), np.diff(P.indptr)) * big \
            + P.indices

        def aligned(X):
            X = X.tocsr()
            X.sort_indices()
            rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(X.indptr))
            out = np.zeros(P.nnz, dtype=np.float64)
            out[np.searchsorted(pkeys, rows * big + X.indices)] = X.data
            return out

        d0, d1 = aligned(M0), aligned(M1)
        nnz = np.diff(P.indptr).astype(np.int64)
        top = int(nnz.max(initial=0))
        edges = np.asarray([e for e in BUCKET_EDGES if e < top] + [top])
        bidx = np.searchsorted(edges, nnz, side="left")
        cols, w0, w1, row_ids, meta = [], [], [], [], []
        row0 = slot0 = blk0 = 0
        for b in reversed(range(len(edges))):
            rows = np.nonzero(bidx == b)[0]
            nb = len(rows)
            if nb == 0:
                continue
            nnzr = nnz[rows]
            J = max(int(nnzr.max()), 1)
            rep = np.repeat(np.arange(nb), nnzr)
            slot = np.arange(int(nnzr.sum())) - np.repeat(
                np.cumsum(nnzr) - nnzr, nnzr)
            pos = np.repeat(P.indptr[rows], nnzr) + slot
            c = np.full((J, nb), n, dtype=np.int32)
            c[slot, rep] = P.indices[pos]
            cols.append(c.reshape(-1))
            for w, d in ((w0, d0), (w1, d1)):
                v = np.zeros((J, nb), dtype=np.float64)
                v[slot, rep] = d[pos]
                w.append(v.reshape(-1))
            row_ids.append(rows.astype(np.int32))
            meta.append((row0, nb, J, slot0, blk0))
            row0 += nb
            slot0 += J * nb
            blk0 += -(-nb // ROWS_PER_BLOCK)

        def dev(parts, dtype):
            a = np.concatenate(parts) if parts else np.zeros(0)
            return torch.as_tensor(a).to(device=device, dtype=dtype)

        return MultiELLPair(
            n=n, nnz=int(P.nnz), cols=dev(cols, torch.int32), w0=dev(w0, dt),
            w1=dev(w1, dt), row_ids=dev(row_ids, torch.int32),
            meta=torch.as_tensor(np.asarray(meta, np.int64).reshape(-1, 5),
                                 device=device),
            buckets=tuple(meta), nblocks=blk0,
            diag0=torch.as_tensor(M0.diagonal(), dtype=dt, device=device),
            diag1=torch.as_tensor(M1.diagonal(), dtype=dt, device=device))

    def mult_combined(self, x: torch.Tensor, c0, c1) -> torch.Tensor:
        """(c0·M0 + c1·M1) x."""
        return ell_spmv(self, x, c0, c1)

    def mult0(self, x: torch.Tensor) -> torch.Tensor:
        return self.mult_combined(x, 1.0, 0.0)

    def mult1(self, x: torch.Tensor) -> torch.Tensor:
        return self.mult_combined(x, 0.0, 1.0)


def _check(pair: MultiELLPair, x: torch.Tensor):
    if x.shape != (pair.n,):
        raise ValueError(f"x must have shape ({pair.n},), got {tuple(x.shape)}")
    if x.device != pair.w0.device or x.dtype != pair.w0.dtype:
        raise ValueError(f"x is {x.dtype} on {x.device}, the pair "
                         f"{pair.w0.dtype} on {pair.w0.device}")


def ell_spmv_plain(pair: MultiELLPair, x: torch.Tensor, c0, c1) -> torch.Tensor:
    """The plain PyTorch version, on any device: per bucket, the combined
    weights c0·w0 + c1·w1 times the gathered x (a sentinel column reads the
    zero appended to x), then the planes summed one by one in the kernel's
    order; the bucket's sums go to their natural rows."""
    _check(pair, x)
    c0 = torch.tensor(c0, dtype=x.dtype, device=x.device)
    c1 = torch.tensor(c1, dtype=x.dtype, device=x.device)
    xp = torch.cat([x, x.new_zeros(1)])
    y = torch.empty_like(x)
    for row0, nb, J, slot0, _blk0 in pair.buckets:
        s = slice(slot0, slot0 + J * nb)
        p = ((c0 * pair.w0[s] + c1 * pair.w1[s])
             * xp.index_select(0, pair.cols[s])).view(J, nb)
        acc = p[0]
        for j in range(1, J):
            acc = acc + p[j]
        y[pair.row_ids[row0:row0 + nb].long()] = acc
    return y


def ell_spmv(pair: MultiELLPair, x: torch.Tensor, c0, c1) -> torch.Tensor:
    """``(c0·M0 + c1·M1) x`` with ``c0``/``c1`` rounded to the working type.

    CUDA tensors launch the kernel (and count the launch in
    ``ell_spmv.launches``); CPU tensors take :func:`ell_spmv_plain`."""
    if x.device.type == "cpu":
        return ell_spmv_plain(pair, x, c0, c1)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(pair, x)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    fns = {torch.float32: "ell_spmv_f32", torch.float64: "ell_spmv_f64"}
    if x.dtype not in fns:
        raise ValueError(f"unsupported dtype {x.dtype}")
    y = torch.empty_like(x)
    if pair.n == 0:
        return y
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, fns[x.dtype])(
        x.data_ptr(), pair.n, pair.cols.data_ptr(), pair.w0.data_ptr(),
        pair.w1.data_ptr(), pair.row_ids.data_ptr(), pair.meta.data_ptr(),
        len(pair.buckets), pair.nblocks, ROWS_PER_BLOCK, float(c0), float(c1),
        y.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("ell_spmv kernel launch failed: "
                           + lib.ell_spmv_error_string(rc).decode())
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0
