"""Runtime configuration (counterpart of ``cardiac_ablation_ecm2_tpu/utils/config.py``).

* ``dtype``: the working real type name ("float64" / "float32").
* ``quad_extra``: extra 1D quadrature points beyond p+1
  (nq1d = p + 1 + quad_extra); the default 1 matches the JAX package.
* ``affine_collapse``: "auto" detects W⊗d-separable qdata and applies it
  through reference matrices (``ops/lanemajor.py``); "off" keeps the
  per-quadrature-point path.
* ``f64_reductions``: accumulate solver inner products in float64 when the
  arrays are float32.

Importing this module turns TF32 off for CUDA matmuls and cuDNN: the JAX
reference runs its contractions at full float32 precision
(``ops/lanemajor.py`` uses ``Precision.HIGHEST``), and TF32 keeps only about
three decimal digits.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

_DTYPES = {"float64": torch.float64, "float32": torch.float32}

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Config:
    """Global knobs; mutate through :func:`configure`."""

    dtype: str = "float64"
    quad_extra: int = 1
    f64_reductions: bool = True
    affine_collapse: str = "auto"


config = Config()


def configure(**kw) -> Config:
    """Update config fields; returns the config."""
    for k, v in kw.items():
        if not hasattr(config, k):
            raise ValueError(f"unknown config field {k!r}")
        setattr(config, k, v)
    return config


def real_t(dtype: Optional[object] = None) -> torch.dtype:
    """Resolve a dtype name / torch dtype (None → the configured dtype)."""
    if dtype is None:
        dtype = config.dtype
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


def require_cuda() -> torch.device:
    """The first CUDA device; raises when no GPU is visible (no CPU
    continuation for code that is meant to run on the card)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another (``device="cpu"``); ``None`` raises without a GPU."""
    return require_cuda() if device is None else torch.device(device)


def elapsed(t0: float, device) -> float:
    """Seconds since ``t0`` (``time.perf_counter``), after the work queued
    on ``device`` has finished."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0
