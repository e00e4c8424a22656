"""The four gathers the JAX package's Mosaic probes (``benchmarks/
gather_micro2.py``, ``gather_micro3.py``, ``gather_micro4.py``) compute, each
with a kernel on the card and a plain PyTorch version:

* :func:`take_flat` ``out = u[idx]`` (probe p1) — the ``gather_sum`` kernel
  with one plane (``ops/block_gather.py``), which is exactly this gather;
* :func:`take_along_rows` ``out[b, c] = table[idx[b, c], c]`` (t1, u1);
* :func:`take_along_lanes` ``out[b, j] = mat[b, idx[b, j]]`` (t2, u2), any row
  width and any output width;
* :func:`take_rows` ``out[i, :] = table[rows[i], :]`` (u3, u5).

The last three run ``csrc/gather_probes.cu`` (built with nvcc for ``sm_90a``
into ``build/cuda/`` on first use).  Data are float32 or float64, indices
int32.  Each function dispatches on the device of its data: a CUDA tensor
launches the kernel (and counts the launch in ``<function>.launches``), a
CPU tensor takes the ``*_plain`` version.  Nothing falls back: a CUDA call
that cannot build or launch its kernel raises.  Indices must lie on the
gathered axis: for one that does not, the three ``gather_probes.cu``
kernels read 0 where the plain versions raise ``IndexError``
(``take_flat`` takes [0, len(u)], ``len(u)`` reading 0, as
``gather_sum`` does).  Gathers copy values, so kernel and plain version
agree bitwise.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .block_gather import gather_sum

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "gather_probes.cu")
_LIB = None
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is None:
        from ..utils.native import build_cuda

        lib = build_cuda(_SRC, "gather_probes")
        args = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        for kind in ("take_rows", "take_along_lanes", "take_along_rows"):
            for suffix in _DTYPES.values():
                fn = getattr(lib, f"{kind}_{suffix}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
        lib.gather_probes_error_string.argtypes = [ctypes.c_int]
        lib.gather_probes_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(data: torch.Tensor, idx: torch.Tensor, data_dim: int, idx_dim=None):
    """Raise ``ValueError`` on what neither version takes."""
    if data.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {data.dtype}")
    if idx.dtype != torch.int32:
        raise ValueError(f"indices must be int32, got {idx.dtype}")
    if data.dim() != data_dim:
        raise ValueError(f"data must be {data_dim}-D, got shape {tuple(data.shape)}")
    if idx_dim is not None and idx.dim() != idx_dim:
        raise ValueError(f"indices must be {idx_dim}-D, got shape {tuple(idx.shape)}")
    if data.device != idx.device:
        raise ValueError(f"data on {data.device}, indices on {idx.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")


def _launch(kind: str, data: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
            n1: int, n2: int, n3: int):
    """Launch ``<kind>_<f32|f64>(data, n1, n2, idx, n3, out, stream)`` on the
    current stream; raise if the launch was refused."""
    if not (data.is_contiguous() and idx.is_contiguous()):
        raise ValueError("data and indices must be contiguous")
    lib = build()
    fn = getattr(lib, f"{kind}_{_DTYPES[data.dtype]}")
    stream = torch.cuda.current_stream(data.device).cuda_stream
    rc = fn(data.data_ptr(), n1, n2, idx.data_ptr(), n3, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{kind} kernel launch failed: "
                           + lib.gather_probes_error_string(rc).decode())


# -- flat gather (p1) ------------------------------------------------------
def take_flat_plain(u: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``u[idx]`` by advanced indexing; ``idx`` of any shape."""
    _check(u, idx, 1)
    return u[idx.long()]


def take_flat(u: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out = u[idx]``, ``out`` shaped as ``idx``.  On CUDA one launch of
    the one-plane ``gather_sum`` kernel (counted in ``gather_sum.launches``
    and in ``take_flat.launches``)."""
    _check(u, idx, 1)
    if u.device.type == "cpu":
        return take_flat_plain(u, idx)
    if not (u.is_contiguous() and idx.is_contiguous()):
        raise ValueError("data and indices must be contiguous")
    out = gather_sum(u, idx.reshape(1, -1)).view(idx.shape)
    if idx.numel():
        take_flat.launches += 1
    return out


# -- per-column row gather (t1, u1) ----------------------------------------
def _check_along_rows(table, idx):
    _check(table, idx, 2, 2)
    if idx.shape[1] != table.shape[1]:
        raise ValueError(f"idx has {idx.shape[1]} columns, table {table.shape[1]}")


def take_along_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx[b, c], c]`` by advanced indexing."""
    _check_along_rows(table, idx)
    cols = torch.arange(table.shape[1], device=table.device)
    return table[idx.long(), cols]


def take_along_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, c] = table[idx[b, c], c]`` (``take_along_axis`` on axis 0):
    table (R, C), idx and out (B, C)."""
    _check_along_rows(table, idx)
    if table.device.type == "cpu":
        return take_along_rows_plain(table, idx)
    out = torch.empty(idx.shape, dtype=table.dtype, device=table.device)
    if out.numel():
        _launch("take_along_rows", table, idx, out, table.shape[0],
                table.shape[1], out.numel())
        take_along_rows.launches += 1
    return out


# -- in-row lane gather (t2, u2) -------------------------------------------
def _check_along_lanes(mat, idx):
    _check(mat, idx, 2, 2)
    if idx.shape[0] != mat.shape[0]:
        raise ValueError(f"idx has {idx.shape[0]} rows, mat {mat.shape[0]}")


def take_along_lanes_plain(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``mat[b, idx[b, j]]`` by advanced indexing."""
    _check_along_lanes(mat, idx)
    rows = torch.arange(mat.shape[0], device=mat.device)[:, None]
    return mat[rows, idx.long()]


def take_along_lanes(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, j] = mat[b, idx[b, j]]`` (``take_along_axis`` on axis 1):
    mat (B, W), idx and out (B, K), any W and K."""
    _check_along_lanes(mat, idx)
    if mat.device.type == "cpu":
        return take_along_lanes_plain(mat, idx)
    out = torch.empty(idx.shape, dtype=mat.dtype, device=mat.device)
    if out.numel():
        _launch("take_along_lanes", mat, idx, out, mat.shape[0], mat.shape[1],
                idx.shape[1])
        take_along_lanes.launches += 1
    return out


# -- row gather (u3, u5) ---------------------------------------------------
def take_rows_plain(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` by advanced indexing."""
    _check(table, rows, 2, 1)
    return table[rows.long()]


def take_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``out[i, :] = table[rows[i], :]``: table (R, C), rows (N,), out
    (N, C)."""
    _check(table, rows, 2, 1)
    if table.device.type == "cpu":
        return take_rows_plain(table, rows)
    out = torch.empty((rows.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel():
        _launch("take_rows", table, rows, out, table.shape[0], table.shape[1],
                rows.shape[0])
        take_rows.launches += 1
    return out


take_flat.launches = 0
take_along_rows.launches = 0
take_along_lanes.launches = 0
take_rows.launches = 0
