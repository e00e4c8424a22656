"""The element restriction's gathers and sums (counterpart of
``cardiac_ablation_ecm2_tpu/ops/block_gather.py``), three ops on one CUDA
source:

* :func:`gather_sum` ``out[i] = Σ_j src[idx[j, i]]`` over (J, nout) int32
  planes, where the sentinel index ``nsrc = len(src)`` reads zero.  One
  plane is a plain gather (the element-major L→E, ``take_flat``); more
  planes a multi-plane gather-sum.
* :func:`gather_transpose` ``out[d, e] = src[g[e, d]]``: L→E from the
  element-major (ne, nd) map into the transposed (nd, ne) layout that the
  lane-major applies consume, through shared-memory tiles of elements.
* :func:`segment_sum` ``out[i] = Σ_{k=off[i]}^{off[i+1]-1} src[slots[k]]``:
  the sorted segment-sum, E→L with each dof's slots in ascending order
  (``fem/restriction.py``) and the duplicate-entry sum of FULL assembly
  (``ops/bilinearform.py``).  A segment without a slot is +0.0.

Each op dispatches on the device of ``src``: a CUDA tensor runs its
hand-written kernel in ``csrc/gather_sum.cu`` (built with nvcc for
``sm_90a`` into ``build/cuda/`` on first use) and counts the launch on the
function (``gather_sum.launches``, ...), a CPU tensor runs the plain
version (``gather_sum_plain``, ...).  Nothing falls back: a CUDA call that
cannot build or launch its kernel raises.  Kernel and plain version take
the same additions in the same order, so on the card they agree bitwise.
"""

from __future__ import annotations

import ctypes
import os

import torch

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "gather_sum.cu")
_LIB = None
_FNS = {torch.float32: "f32", torch.float64: "f64"}


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is None:
        from ..utils.native import build_cuda

        lib = build_cuda(_SRC, "gather_sum")
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        sig = {"gather_sum": [p, i64, p, ctypes.c_int, i64, p, p],
               "gather_transpose": [p, i64, p, i64, ctypes.c_int, p, p],
               "segment_sum": [p, p, p, i64, p, p]}
        for stem, args in sig.items():
            for suffix in _FNS.values():
                fn = getattr(lib, f"{stem}_{suffix}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
        lib.gather_sum_error_string.argtypes = [ctypes.c_int]
        lib.gather_sum_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(stem: str, src: torch.Tensor, *args) -> None:
    """Call ``<stem>_<f32|f64>`` on the current stream; raise on a refused
    launch."""
    lib = build()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = getattr(lib, f"{stem}_{_FNS[src.dtype]}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{stem} kernel launch failed: "
                           + lib.gather_sum_error_string(rc).decode())


def _on_card(src: torch.Tensor, *tensors) -> bool:
    """True for CUDA tensors (after checking what the kernels take), False
    for CPU tensors; raises for any other device."""
    if src.device.type == "cpu":
        return False
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    if src.dtype not in _FNS:
        raise ValueError(f"unsupported dtype {src.dtype}")
    if not all(t.is_contiguous() for t in (src, *tensors)):
        raise ValueError("the kernels take contiguous tensors")
    return True


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
    """``out[i] = Σ_j src[idx[j, i]]``, index ``len(src)`` reading 0."""
    _check(src, idx)
    if not _on_card(src, idx):
        return gather_sum_plain(src, idx)
    J, nout = idx.shape
    out = torch.empty(nout, dtype=src.dtype, device=src.device)
    if nout == 0:
        return out
    _launch("gather_sum", src, src.data_ptr(), src.shape[0], idx.data_ptr(), J,
            nout, out.data_ptr())
    gather_sum.launches += 1
    return out


def _check_transpose(src: torch.Tensor, g: torch.Tensor):
    if src.dim() != 1:
        raise ValueError(f"src must be 1-D, got shape {tuple(src.shape)}")
    if g.dim() != 2 or g.dtype != torch.int32:
        raise ValueError("g must be an (ne, nd) int32 tensor")
    if src.device != g.device:
        raise ValueError(f"src on {src.device}, g on {g.device}")


def gather_transpose_plain(src: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the element-major gather (index
    ``len(src)`` reading the appended zero), transposed to (nd, ne)."""
    _check_transpose(src, g)
    pad = torch.cat([src, src.new_zeros(1)])
    return pad.index_select(0, g.reshape(-1)).view(g.shape).T.contiguous()


def gather_transpose(src: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``out[d, e] = src[g[e, d]]``: (ndof,) through an (ne, nd) map to
    (nd, ne); index ``len(src)`` reads 0."""
    _check_transpose(src, g)
    if not _on_card(src, g):
        return gather_transpose_plain(src, g)
    ne, nd = g.shape
    out = torch.empty((nd, ne), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    _launch("gather_transpose", src, src.data_ptr(), src.shape[0], g.data_ptr(),
            ne, nd, out.data_ptr())
    gather_transpose.launches += 1
    return out


def _check_segments(src: torch.Tensor, slots: torch.Tensor, offsets: torch.Tensor):
    if src.dim() != 1:
        raise ValueError(f"src must be 1-D, got shape {tuple(src.shape)}")
    if slots.dim() != 1 or slots.dtype != torch.int32:
        raise ValueError("slots must be a 1-D int32 tensor")
    if offsets.dim() != 1 or offsets.dtype != torch.int64 or offsets.numel() < 1:
        raise ValueError("offsets must be a 1-D int64 tensor of nseg + 1 entries")
    if not src.device == slots.device == offsets.device:
        raise ValueError(f"src on {src.device}, slots on {slots.device}, "
                         f"offsets on {offsets.device}")


def segment_sum_plain(src: torch.Tensor, slots: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the values in slot order, then level k of
    every segment longer than k added in order k = 0, 1, ... (level 0
    copies, so a lone −0.0 stays −0.0); a segment's missing levels are
    skipped, not added as +0.0, and an empty segment is +0.0."""
    _check_segments(src, slots, offsets)
    counts = offsets[1:] - offsets[:-1]
    out = src.new_zeros(counts.numel())
    if slots.numel() == 0 or counts.numel() == 0:
        return out
    vals = src.index_select(0, slots)
    start, last = offsets[:-1], vals.numel() - 1
    for k in range(int(counts.max())):
        v = vals.index_select(0, torch.clamp(start + k, max=last))
        out = torch.where(counts > k, v if k == 0 else out + v, out)
    return out


def segment_sum(src: torch.Tensor, slots: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """``out[i] = Σ_{k=offsets[i]}^{offsets[i+1]-1} src[slots[k]]`` in slot
    order, no atomics; (len(offsets) − 1,) out."""
    _check_segments(src, slots, offsets)
    if not _on_card(src, slots, offsets):
        return segment_sum_plain(src, slots, offsets)
    nseg = offsets.numel() - 1
    out = torch.empty(nseg, dtype=src.dtype, device=src.device)
    if nseg == 0:
        return out
    _launch("segment_sum", src, src.data_ptr(), slots.data_ptr(),
            offsets.data_ptr(), nseg, out.data_ptr())
    segment_sum.launches += 1
    return out


gather_sum.launches = 0
gather_transpose.launches = 0
segment_sum.launches = 0
