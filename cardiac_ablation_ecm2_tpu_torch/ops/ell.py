"""Assembled sparse operators in sliced ELL (counterpart of ``ELLOperator``,
``MultiELLOperator`` and ``MultiELLPair`` in
``cardiac_ablation_ecm2_tpu/ops/ell.py``).

:class:`ELLOperator` and :class:`MultiELLOperator` apply one matrix (square
or rectangular); :class:`MultiELLPair` holds two matrices on one pattern,
applied as ``y = (c0·M0 + c1·M1) x``: the bioheat stage operator
(M_ρc + γ(K + M_ω)) on tets is exactly this shape, both matrices sharing
the FE connectivity pattern, γ changing per solve.  The contract is the JAX
package's: natural row and column numbering in and out, a sentinel column
reads 0, nothing is scattered.  The layout is the port's own, SELL-32-σ, a
sliced ELL that fits a GPU warp:

* rows are sorted by their nnz within windows of ``SIGMA`` rows (natural
  order among equal widths, so the x gathers stay local) and cut into
  slices of 32 rows; a slice is as wide as its widest row, J_s;
* slice s holds int32 column planes (J_s, 32) (sentinel m, the number of
  columns, in the padding) and the aligned weight planes, plane-major from
  ``slice_ptr[s]``, and
  ``row_ids`` the natural row of every sorted row, so the kernel writes
  every output row once and nothing unpermutes.

:meth:`MultiELLPair.combined` forms the weight plane c0·w0 + c1·w1 once
(a solve's stage operator, or one ``mult_combined`` call);
:class:`CombinedELL` applies it, streaming one weight plane per entry, as
an :class:`ELLOperator` streams its own.  Since SELL takes rows of any
width with no global padding, the single-matrix operators need none of the
JAX package's width buckets, plane chunks or unpermuting gather:
``MultiELLOperator`` is the same one-plane layout, and its ``chunk_j`` /
``bucket_edges`` are accepted and ignored.

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

import numpy as np
import torch

from ..utils.config import real_t, resolve_device
from .operators import LinearOperator

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "ell_spmv.cu")
_LIB = None
#: rows per CUDA block; the kernel checks it equals its own constant
ROWS_PER_BLOCK = 256
#: rows of one slice: a warp
SLICE = 32
#: rows of one sorting window
SIGMA = 4096


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is None:
        from ..utils.native import build_cuda

        lib = build_cuda(_SRC, "ell_spmv")
        for name in ("ell_spmv_f32", "ell_spmv_f64"):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64]
                           + [ctypes.c_void_p] * 4
                           + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.ell_spmv_error_string.argtypes = [ctypes.c_int]
        lib.ell_spmv_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def sell_layout(nnz: np.ndarray):
    """SELL-32-σ of rows with ``nnz`` entries: the sorted order of the rows
    (by width, descending, within windows of ``SIGMA`` rows; stable), the
    width of each slice of 32 sorted rows and the (nslices + 1,) slot
    offsets of the slices."""
    nnz = np.asarray(nnz, dtype=np.int64)
    n = nnz.size
    top = int(nnz.max(initial=0))
    key = (np.arange(n, dtype=np.int64) // SIGMA) * (top + 1) + (top - nnz)
    order = np.argsort(key, kind="stable")
    nslices = -(-n // SLICE)
    padded = np.zeros(nslices * SLICE, dtype=np.int64)
    padded[:n] = nnz[order]
    widths = padded.reshape(nslices, SLICE).max(axis=1)
    slice_ptr = np.zeros(nslices + 1, dtype=np.int64)
    np.cumsum(widths * SLICE, out=slice_ptr[1:])
    return order, widths, slice_ptr


def _sell_pack(indptr: np.ndarray, indices: np.ndarray, m: int):
    """SELL-32-σ packing of a CSR pattern with ``m`` columns: the int32
    column slots (sentinel m), the row order, the slice offsets, the
    widest slice and a ``plane(data)`` that lays out aligned CSR data as a
    float64 weight plane."""
    n = len(indptr) - 1
    nnz = np.diff(indptr).astype(np.int64)
    order, widths, slice_ptr = sell_layout(nnz)
    # slot of entry k of sorted row r: slice_ptr[r // 32] + 32 k + r % 32
    nnz_s = nnz[order]
    total = int(nnz.sum())
    sorted_row = np.repeat(np.arange(n, dtype=np.int64), nnz_s)
    k = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(nnz_s) - nnz_s,
                                                     nnz_s)
    slot = slice_ptr[sorted_row // SLICE] + SLICE * k + sorted_row % SLICE
    pos = np.repeat(indptr[:-1][order], nnz_s) + k
    nslots = int(slice_ptr[-1])
    cols = np.full(nslots, m, dtype=np.int32)
    cols[slot] = indices[pos]

    def plane(d):
        w = np.zeros(nslots, dtype=np.float64)
        w[slot] = d[pos]
        return w

    return cols, order, slice_ptr, int(widths.max(initial=0)), plane


@dataclasses.dataclass(frozen=True, eq=False)
class ELLOperator:
    """An n×m sparse matrix in SELL-32-σ form on one device: one weight
    plane over its own pattern, applied by :func:`ell_spmv` in natural row
    and column numbering."""

    n: int                    # rows
    m: int                    # columns, the length of x
    nnz: int
    cols: torch.Tensor        # (slots,) int32, plane-major per slice
    w: torch.Tensor           # (slots,) weights
    row_ids: torch.Tensor     # (n,) int32 natural row of each sorted row
    slice_ptr: torch.Tensor   # (nslices + 1,) int64 first slot of each slice
    max_width: int
    diag: torch.Tensor        # (min(n, m),) natural diagonal

    @property
    def shape(self):
        return (self.n, self.m)

    @property
    def pattern(self):
        return self

    @classmethod
    def from_csr(cls, A, dtype="float32", device=None):
        """Pack a scipy sparse matrix (host, setup time); ``device=None``
        is the card."""
        import scipy.sparse as sp

        device = resolve_device(device)
        dt = real_t(dtype)
        A = sp.csr_matrix(A)
        A.sort_indices()
        n, m = A.shape
        cols, order, slice_ptr, width, plane = _sell_pack(A.indptr, A.indices, m)
        return cls(
            n=n, m=m, nnz=int(A.nnz), cols=torch.as_tensor(cols, device=device),
            w=torch.as_tensor(plane(A.data)).to(device=device, dtype=dt),
            row_ids=torch.as_tensor(order.astype(np.int32), device=device),
            slice_ptr=torch.as_tensor(slice_ptr, device=device),
            max_width=width,
            diag=torch.as_tensor(A.diagonal(), dtype=dt, device=device))

    @property
    def padding(self) -> float:
        """Padding slots over the matrix's entries."""
        return self.cols.numel() / max(self.nnz, 1) - 1.0

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmv(self, x)

    def diagonal(self) -> torch.Tensor:
        return self.diag

    def operator(self) -> LinearOperator:
        return LinearOperator(self.shape, self.mult, self.diagonal)


class MultiELLOperator(ELLOperator):
    """The JAX package's width-bucketed operator for the variable row
    widths of higher-order matrices.  SELL-32-σ already takes rows of any
    width without global padding, so this is :class:`ELLOperator` itself:
    ``chunk_j`` and ``bucket_edges`` (the TPU kernel's plane chunks and
    width buckets) are accepted for the JAX signature and ignored."""

    @classmethod
    def from_csr(cls, A, dtype="float32", chunk_j: int = 8, bucket_edges=None,
                 device=None):
        return super().from_csr(A, dtype, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class MultiELLPair:
    """A pair of n×n matrices in SELL-32-σ form on one device."""

    n: int
    nnz: int                  # entries of the union pattern
    cols: torch.Tensor        # (slots,) int32, plane-major per slice
    w0: torch.Tensor          # (slots,) weights of M0
    w1: torch.Tensor          # (slots,) weights of M1
    row_ids: torch.Tensor     # (n,) int32 natural row of each sorted row
    slice_ptr: torch.Tensor   # (nslices + 1,) int64 first slot of each slice
    max_width: int
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

        cols, order, slice_ptr, width, pack = _sell_pack(P.indptr, P.indices, n)

        def plane(d):
            return torch.as_tensor(pack(d)).to(device=device, dtype=dt)

        return MultiELLPair(
            n=n, nnz=int(P.nnz), cols=torch.as_tensor(cols, device=device),
            w0=plane(aligned(M0)), w1=plane(aligned(M1)),
            row_ids=torch.as_tensor(order.astype(np.int32), device=device),
            slice_ptr=torch.as_tensor(slice_ptr, device=device),
            max_width=width,
            diag0=torch.as_tensor(M0.diagonal(), dtype=dt, device=device),
            diag1=torch.as_tensor(M1.diagonal(), dtype=dt, device=device))

    @property
    def m(self) -> int:
        return self.n

    @property
    def padding(self) -> float:
        """Padding slots over the pattern's entries."""
        return self.cols.numel() / max(self.nnz, 1) - 1.0

    def combined(self, c0, c1) -> "CombinedELL":
        """The one-plane operator c0·M0 + c1·M1, its weights formed on the
        pair's device as fl(fl(c0·w0) + fl(c1·w1)), the rounded operations
        of the JAX kernel's per-entry weights; ``c0``/``c1`` are rounded to
        the working type."""
        c0t, c1t = (torch.tensor(c, dtype=self.w0.dtype, device=self.w0.device)
                    for c in (c0, c1))
        return CombinedELL(pair=self, w=c0t * self.w0 + c1t * self.w1)

    def mult_combined(self, x: torch.Tensor, c0, c1) -> torch.Tensor:
        """(c0·M0 + c1·M1) x through a plane formed for this call."""
        return self.combined(c0, c1).mult(x)

    def mult0(self, x: torch.Tensor) -> torch.Tensor:
        return self.mult_combined(x, 1.0, 0.0)

    def mult1(self, x: torch.Tensor) -> torch.Tensor:
        return self.mult_combined(x, 0.0, 1.0)


@dataclasses.dataclass(frozen=True, eq=False)
class CombinedELL:
    """One weight plane on a pair's SELL pattern (``MultiELLPair.combined``)."""

    pair: MultiELLPair
    w: torch.Tensor           # (slots,) weights c0·w0 + c1·w1

    @property
    def pattern(self) -> MultiELLPair:
        return self.pair

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmv(self, x)


def _check(A, x: torch.Tensor):
    """The pattern and the weight plane of a one-plane holder
    (:class:`CombinedELL` or :class:`ELLOperator`)."""
    if not isinstance(A, (CombinedELL, ELLOperator)):
        raise ValueError("ell_spmv applies a weight plane (MultiELLPair.combined "
                         "or an ELLOperator), not a pair")
    pair, w = A.pattern, A.w
    if x.shape != (pair.m,):
        raise ValueError(f"x must have shape ({pair.m},), got {tuple(x.shape)}")
    if x.device != w.device or x.dtype != w.dtype:
        raise ValueError(f"x is {x.dtype} on {x.device}, the weights "
                         f"{w.dtype} on {w.device}")
    return pair, w


def ell_spmv_plain(A, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on any device.  Level j of every sorted
    row whose slice is wider than j: its weight times the gathered x (a
    sentinel column reads the zero appended to x), added in order
    j = 0, 1, ... (level 0 initialises); the row sums go to their natural
    rows."""
    pair, w = _check(A, x)
    y = x.new_empty(pair.n)
    if pair.n == 0:
        return y
    xp = torch.cat([x, x.new_zeros(1)])
    r = torch.arange(pair.n, device=x.device)
    base = pair.slice_ptr[r // SLICE] + r % SLICE
    width = (pair.slice_ptr[r // SLICE + 1] - pair.slice_ptr[r // SLICE]) // SLICE
    last = max(pair.cols.numel() - 1, 0)
    acc = x.new_zeros(pair.n)
    for j in range(pair.max_width):
        q = torch.clamp(base + SLICE * j, max=last)
        p = w[q] * xp.index_select(0, pair.cols[q])
        acc = torch.where(width > j, p if j == 0 else acc + p, acc)
    y[pair.row_ids.long()] = acc
    return y


def ell_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """``A x`` for a weight plane ``A`` (:meth:`MultiELLPair.combined`, or
    an :class:`ELLOperator`).

    CUDA tensors launch the kernel (and count the launch in
    ``ell_spmv.launches``); CPU tensors take :func:`ell_spmv_plain`."""
    if x.device.type == "cpu":
        return ell_spmv_plain(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    pair, w = _check(A, x)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    fns = {torch.float32: "ell_spmv_f32", torch.float64: "ell_spmv_f64"}
    if x.dtype not in fns:
        raise ValueError(f"unsupported dtype {x.dtype}")
    y = x.new_empty(pair.n)
    if pair.n == 0:
        return y
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, fns[x.dtype])(
        x.data_ptr(), pair.m, pair.cols.data_ptr(), w.data_ptr(),
        pair.row_ids.data_ptr(), pair.slice_ptr.data_ptr(), pair.n,
        ROWS_PER_BLOCK, y.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("ell_spmv kernel launch failed: "
                           + lib.ell_spmv_error_string(rc).decode())
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0
