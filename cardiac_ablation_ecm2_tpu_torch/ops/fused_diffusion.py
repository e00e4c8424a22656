"""Fused element-major diffusion apply on hexahedra (counterpart of
``diffusion_apply_pallas`` in ``cardiac_ablation_ecm2_tpu/ops/pallas_kernels.py``):

    y_e = Σ_s G_sᵀ (D_e · (G e))_s

for e (ne, nd) E-vectors and packed symmetric qdata (6, ne, nq) in the order
[D00, D11, D22, D01, D02, D12] (or (6, 1, nq): one element's qdata for all,
as the uniform collapse leaves it).  The qdata are of e's dtype, or
bfloat16 beside float32 e (the bioheat operator's ``qdata_bf16``): the
kernel widens each value as it loads it, and the plain version's products
promote the same values to float32.  G_x = B⊗B⊗G, G_y = B⊗G⊗B, G_z = G⊗B⊗B
over the basis' 1D factors ``B1``/``G1``; dofs and points lex, x fastest.

:func:`diffusion_apply` dispatches on the device of ``e``: a CUDA tensor
runs the hand-written kernel ``csrc/fused_diffusion.cu`` (built with nvcc
for ``sm_90a`` into ``build/cuda/`` on first use, one block per tile of
elements, sum-factorized through shared memory), a CPU tensor runs
:func:`diffusion_apply_plain`, the einsum chain.  Nothing falls back: a
CUDA call that cannot build or launch the kernel, or whose shape the kernel
does not take, raises.  The kernel sums in another order than the einsums,
so the two agree to rounding, not bitwise.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..fem.quadinterp import DeviceBasis, eval_grad, eval_grad_t
from .lanemajor import sym_flux

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "fused_diffusion.cu")
_LIB = None
#: (n1, nq1) pairs the kernel is compiled for: orders 1-4 at quad_extra 0, 1
SHAPES = tuple((n, q) for n in range(2, 6) for q in (n, n + 1))


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is None:
        from ..utils.native import build_cuda

        lib = build_cuda(_SRC, "fused_diffusion")
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        for name in ("fused_diffusion_f32", "fused_diffusion_f64",
                     "fused_diffusion_f32_bf16q"):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.fused_diffusion_error_string.argtypes = [ctypes.c_int]
        lib.fused_diffusion_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def apply_packed(qd: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Packed symmetric D·g; qd (3|6, ne|1, nq), g (ne, nq, 2|3)."""
    return torch.stack(sym_flux(qd, g.unbind(-1)), dim=-1)


def diffusion_apply_plain(db: DeviceBasis, qdata: torch.Tensor,
                          e: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on any device: (ne, nd) → (ne, nd) by the
    staged einsums of ``fem/quadinterp.py`` (tensor or dense basis, 2D or
    3D packed qdata)."""
    return eval_grad_t(db, apply_packed(qdata, eval_grad(db, e)))


def _check(db: DeviceBasis, qdata: torch.Tensor, e: torch.Tensor):
    """Raise ``ValueError`` naming what the kernel does not take."""
    if not db.tensor or db.dim != 3:
        raise ValueError("fused diffusion needs a 3D tensor-product basis")
    n1, nq1 = db.n1d, db.nq1d
    if (n1, nq1) not in SHAPES:
        raise ValueError(f"unsupported basis (n1, nq1) = ({n1}, {nq1}); the "
                         f"kernel takes {SHAPES}")
    if e.dim() != 2 or e.shape[1] != n1 ** 3:
        raise ValueError(f"e must be (ne, {n1 ** 3}), got {tuple(e.shape)}")
    ne = e.shape[0]
    if qdata.dim() != 3 or qdata.shape[0] != 6 or qdata.shape[2] != nq1 ** 3 \
            or qdata.shape[1] not in (ne, 1):
        raise ValueError(f"qdata must be (6, {ne} or 1, {nq1 ** 3}), got "
                         f"{tuple(qdata.shape)}")
    if e.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {e.dtype}")
    if qdata.dtype != e.dtype and not (qdata.dtype == torch.bfloat16
                                       and e.dtype == torch.float32):
        raise ValueError(f"qdata is {qdata.dtype}, e is {e.dtype}: the kernel "
                         f"takes qdata of e's dtype, or bfloat16 with float32")
    for name, t in (("qdata", qdata), ("B1", db.B1), ("G1", db.G1)):
        if name != "qdata" and t.dtype != e.dtype:
            raise ValueError(f"{name} is {t.dtype}, e is {e.dtype}")
        if t.device != e.device:
            raise ValueError(f"{name} on {t.device}, e on {e.device}")


def diffusion_apply(db: DeviceBasis, qdata: torch.Tensor,
                    e: torch.Tensor) -> torch.Tensor:
    """Gᵀ (D · (G e)) per element, (ne, nd) → (ne, nd).

    CUDA tensors launch the kernel (and count the launch in
    ``diffusion_apply.launches``); CPU tensors take
    :func:`diffusion_apply_plain`."""
    if e.device.type == "cpu":
        return diffusion_apply_plain(db, qdata, e)
    if e.device.type != "cuda":
        raise ValueError(f"unsupported device {e.device}")
    _check(db, qdata, e)
    e, qdata = e.contiguous(), qdata.contiguous()
    B1, G1 = db.B1.contiguous(), db.G1.contiguous()
    ne = e.shape[0]
    out = torch.empty_like(e)
    if ne == 0:
        return out
    lib = build()
    if e.dtype == torch.float64:
        fn = lib.fused_diffusion_f64
    elif qdata.dtype == torch.bfloat16:
        fn = lib.fused_diffusion_f32_bf16q
    else:
        fn = lib.fused_diffusion_f32
    nq = qdata.shape[2]
    q_plane = qdata.shape[1] * nq
    q_elem = nq if qdata.shape[1] == ne else 0
    stream = torch.cuda.current_stream(e.device).cuda_stream
    rc = fn(e.data_ptr(), qdata.data_ptr(), q_plane, q_elem, B1.data_ptr(),
            G1.data_ptr(), db.n1d, db.nq1d, ne, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("fused diffusion kernel launch failed: "
                           + lib.fused_diffusion_error_string(rc).decode())
    diffusion_apply.launches += 1
    return out


diffusion_apply.launches = 0
