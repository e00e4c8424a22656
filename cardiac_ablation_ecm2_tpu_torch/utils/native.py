"""ctypes loader for the host setup library built from ``csrc/hostkernels.cpp``,
and the build helper of the port's CUDA kernels.

Counterpart of ``cardiac_ablation_ecm2_tpu/utils/native.py``, with one
difference: there is no numpy fallback.  The dof numbering must equal the
JAX package's (first-occurrence ids from the native hash table), and the
fallback numbers dofs in another order, so a missing library is an error.

Libraries are built on first use into ``build/`` at the repository root
(listed in ``.gitignore``): the host library with g++ into ``build/host/``,
each CUDA kernel with nvcc for ``sm_90a`` into ``build/cuda/``.  Neither
package directory is written.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "csrc", "hostkernels.cpp")
_LIB = None


def compile_once(cmd_prefix, src: str, kind: str, stem: str) -> str:
    """Compile ``src`` into ``build/<kind>/<stem>-<hash>.so`` unless that file
    exists; the name carries the source's hash so an edited source
    rebuilds.  Concurrent compilations (parallel test workers) each write
    a private temporary file and rename it into place; the compiler's
    output goes to ``<stem>-<hash>.log`` beside the library.  Returns the
    library path; raises
    ``subprocess.CalledProcessError`` with the compiler's output on failure."""
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    out_dir = os.path.join(_REPO, "build", kind)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{stem}-{digest}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([*cmd_prefix, src, "-o", tmp], check=True,
                              capture_output=True, text=True, timeout=600)
        with open(f"{out}.{os.getpid()}.log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(f"{out}.{os.getpid()}.log", out[:-3] + ".log")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_cuda(src: str, stem: str) -> ctypes.CDLL:
    """Compile one CUDA source with nvcc for Hopper (``sm_90a``) into a
    shared library with a plain C interface, and load it with ctypes; the
    library's ``build_log`` holds ptxas' report of each kernel (registers,
    spills, shared memory).  Raises when nvcc is missing: there is no CPU
    continuation."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: {os.path.basename(src)} cannot be built")
    path = compile_once(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"], src, "cuda", stem)
    lib = ctypes.CDLL(path)
    log = path[:-3] + ".log"
    lib.build_log = open(log).read() if os.path.exists(log) else ""
    return lib


def lib() -> ctypes.CDLL:
    """The loaded host library (built on first call)."""
    global _LIB
    if _LIB is None:
        path = compile_once(["g++", "-O3", "-shared", "-fPIC", "-std=c++17"],
                            _SRC, "host", "hostkernels")
        L = ctypes.CDLL(path)
        L.encode_rows.restype = ctypes.c_int64
        L.encode_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        L.stable_counting_argsort.restype = None
        L.stable_counting_argsort.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        _LIB = L
    return _LIB


def encode_rows(
    main: np.ndarray, query: Optional[np.ndarray] = None
) -> Tuple[int, np.ndarray, Optional[np.ndarray]]:
    """Hash-unique rows of ``main`` (ids in first-seen order) and look up
    the rows of ``query`` (-1 where absent).

    Returns (n_unique, main_ids, query_ids or None)."""
    main = np.ascontiguousarray(main, dtype=np.int64)
    n, w = main.shape
    if query is not None:
        query = np.ascontiguousarray(query, dtype=np.int64)
        if query.shape[1] != w:
            raise ValueError(f"query rows have width {query.shape[1]}, "
                             f"main rows {w}")
    nq = 0 if query is None else len(query)
    main_ids = np.empty(n, dtype=np.int64)
    query_ids = np.empty(max(nq, 1), dtype=np.int64)
    count = lib().encode_rows(
        main.ctypes.data, n,
        query.ctypes.data if query is not None else main.ctypes.data,
        nq, w, main_ids.ctypes.data, query_ids.ctypes.data,
    )
    return int(count), main_ids, (query_ids[:nq] if query is not None else None)


def counting_argsort(keys: np.ndarray, nbins: int) -> np.ndarray:
    """Stable argsort of integer keys in [0, nbins)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if len(keys) and (keys.min() < 0 or keys.max() >= nbins):
        raise ValueError(f"keys must lie in [0, {nbins})")
    perm = np.empty(len(keys), dtype=np.int64)
    lib().stable_counting_argsort(keys.ctypes.data, len(keys), int(nbins),
                                  perm.ctypes.data)
    return perm
