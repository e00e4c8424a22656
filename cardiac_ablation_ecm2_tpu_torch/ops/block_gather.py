"""Multi-plane gather-sum: ``out[i] = Σ_j src[idx[j, i]]``, where the
sentinel index ``nsrc = len(src)`` reads zero (counterpart of
``cardiac_ablation_ecm2_tpu/ops/block_gather.py``).

With one plane it is a plain gather (L→E); with one plane per multiplicity
level it is the deterministic E→L scatter-add (``fem/restriction.py``).  The
planes are a (J, nout) int32 tensor.

:func:`gather_sum` dispatches on the device of ``src``: a CUDA tensor runs
the hand-written kernel ``csrc/gather_sum.cu`` (built with nvcc for
``sm_90a`` into ``build/cuda/`` on first use), a CPU tensor runs
:func:`gather_sum_plain`.  Nothing falls back: a CUDA call that cannot
build or launch the kernel raises.  Both versions take the same additions
in the same order, so on the card they agree bitwise.
"""

from __future__ import annotations

import ctypes
import os

import torch

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "gather_sum.cu")
_LIB = None


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is None:
        from ..utils.native import build_cuda

        lib = build_cuda(_SRC, "gather_sum")
        args = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        for name in ("gather_sum_f32", "gather_sum_f64"):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.gather_sum_error_string.argtypes = [ctypes.c_int]
        lib.gather_sum_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(src: torch.Tensor, idx: torch.Tensor):
    if src.dim() != 1:
        raise ValueError(f"src must be 1-D, got shape {tuple(src.shape)}")
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise ValueError("idx must be a (J, nout) int32 tensor")
    if idx.shape[0] < 1:
        raise ValueError("idx needs at least one plane")
    if src.device != idx.device:
        raise ValueError(f"src on {src.device}, idx on {idx.device}")


def gather_sum_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on any device: pad ``src`` with one zero
    (the sentinel slot) and add the planes' gathers in order j = 0..J-1.
    Indices must lie in [0, len(src)]."""
    _check(src, idx)
    pad = torch.cat([src, src.new_zeros(1)])
    out = pad.index_select(0, idx[0])
    for j in range(1, idx.shape[0]):
        out = out + pad.index_select(0, idx[j])
    return out


def gather_sum(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = Σ_j src[idx[j, i]]``, index ``len(src)`` reading 0.

    CUDA tensors launch the kernel (and count the launch in
    ``gather_sum.launches``); CPU tensors take :func:`gather_sum_plain`."""
    if src.device.type == "cpu":
        return gather_sum_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    _check(src, idx)
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("src and idx must be contiguous")
    fns = {torch.float32: "gather_sum_f32", torch.float64: "gather_sum_f64"}
    if src.dtype not in fns:
        raise ValueError(f"unsupported dtype {src.dtype}")
    J, nout = idx.shape
    out = torch.empty(nout, dtype=src.dtype, device=src.device)
    if nout == 0:
        return out
    lib = build()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = getattr(lib, fns[src.dtype])(src.data_ptr(), src.shape[0], idx.data_ptr(),
                                     J, nout, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("gather_sum kernel launch failed: "
                           + lib.gather_sum_error_string(rc).decode())
    gather_sum.launches += 1
    return out


gather_sum.launches = 0
