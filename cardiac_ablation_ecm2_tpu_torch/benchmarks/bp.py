"""CEED BP-style benchmarks on the port: BP1 (mass) and BP3 (diffusion)
Jacobi-PCG throughput (counterpart of the root ``benchmarks/bp.py``; MFEM's
``tests/benchmarks/bench_assembly_levels.cpp``):

    python -m cardiac_ablation_ecm2_tpu_torch.benchmarks.bp [--orders 1,2,3,4]
        [--n 32] [--dtype float32] [--iters 100] [--cpu] [--structured]
        [--simplex] [--ell]

MDof/s = dofs × CG iterations / solve seconds, per (bp, order), with n =
max(2, N // order) elements a side so the dof count stays about the same
across orders.  The mesh is the unit cube of hexes (``--structured``: the
gather-free ``CartesianFESpace``; ``--simplex``: six tets a hex); the
operator is partially assembled, or with ``--ell`` the FULL-assembled
matrix in the SELL kernel's layout (``assemble_ell`` at order 1,
``MultiELLOperator.from_csr(assemble_matrix())`` above).  BP3 constrains
the whole boundary.  Each solve runs exactly ``--iters`` iterations
(``check_convergence=False``) from b = 1; one warm-up solve, then one
solve timed with CUDA events (the host clock on the CPU).  Prints one JSON
line per (bp, order), as the root script does, with ``device`` the card's
name.  Runs on the first CUDA device unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Sequence

import torch

from ..fem.cartesian import CartesianFESpace
from ..fem.fespace import FESpace
from ..linalg.smoothers import jacobi
from ..linalg.solvers import cg
from ..mesh.mesh import make_cartesian_3d, make_cartesian_3d_tet
from ..ops import block_gather, ell as ell_ops, fused_diffusion
from ..ops.bilinearform import BilinearForm
from ..ops.operators import ConstrainedOperator
from ..utils.config import real_t, resolve_device

_BPS = (("BP1", "mass"), ("BP3", "diffusion"))


def launch_counts() -> dict:
    """The kernel wrappers' launch counters, by kernel name."""
    out = {k: getattr(block_gather, k).launches
           for k in ("gather_sum", "gather_transpose", "segment_sum")}
    out["ell_spmv"] = ell_ops.ell_spmv.launches
    out["fused_diffusion"] = fused_diffusion.diffusion_apply.launches
    return out


def space(order: int, n: int, structured=False, simplex=False):
    """The BP space of one order: n = max(2, N // order) elements a side."""
    n = max(2, n // order)
    if simplex:
        return FESpace(make_cartesian_3d_tet(n, n, n), order)
    mesh = make_cartesian_3d(n, n, n)
    if structured:
        return CartesianFESpace(mesh, order, (n, n, n))
    return FESpace(mesh, order)


def operator(fes, kind: str, dtype, device, ell=False):
    """The unconstrained operator of one BP: partially assembled, or the
    FULL-assembled matrix as an ELL operator (``assemble_ell`` at order 1,
    ``MultiELLOperator`` above, as the root script); with it the scipy
    matrix where the caller has one to keep (``None`` otherwise)."""
    a = BilinearForm(fes, device).add_domain_integrator(kind)
    if ell and fes.order > 1:
        A = a.assemble_matrix(dtype)
        return ell_ops.MultiELLOperator.from_csr(A, dtype, device=device), A
    if ell:
        return a.assemble_ell(dtype), None
    return a.assemble(dtype), None


def run(orders: Sequence[int] = (1, 2, 3, 4), n: int = 32, dtype="float32",
        iters: int = 100, structured=False, simplex=False, ell=False,
        device=None) -> List[dict]:
    """Every (bp, order) once; prints its JSON line and returns, per run,
    that line's fields and ``setup_s`` (space and operator, host clock
    after the device finished), ``peak_bytes`` (CUDA peak memory, None on
    the CPU), ``launches`` (the kernels launched during setup and both
    solves), ``padding`` (SELL padding, ELL runs), ``fes``, ``op`` (the
    unconstrained operator), ``matrix`` (its scipy CSR, ``--ell`` above
    order 1) and ``x`` (the timed solve's iterate)."""
    device = resolve_device(device)
    dt = real_t(dtype)
    cuda = device.type == "cuda"

    def now():
        if cuda:
            torch.cuda.synchronize(device)
        return time.perf_counter()

    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    results = []
    for order in orders:
        t0 = now()
        fes = space(order, n, structured, simplex)
        fes_s = now() - t0
        for bp, kind in _BPS:
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            before = launch_counts()
            t0 = now()
            op, matrix = operator(fes, kind, dt, device, ell)
            ess = fes.essential_dofs() if kind == "diffusion" else []
            A = ConstrainedOperator.wrap(op.operator(), ess, dt, device)
            M = jacobi(A.diagonal())
            b = torch.ones(fes.ndof, dtype=dt, device=device)
            setup_s = now() - t0 + fes_s

            def solve():
                return cg(A.mult, b, M=M, rel_tol=0.0, max_iter=iters,
                          check_convergence=False)

            solve()
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                x, info = solve()
                ev[1].record()
                ev[1].synchronize()
                secs = ev[0].elapsed_time(ev[1]) / 1e3
            else:
                t0 = time.perf_counter()
                x, info = solve()
                secs = time.perf_counter() - t0
            line = {"bench": bp, "order": order, "ndof": fes.ndof,
                    "cg_iters": info.iterations, "seconds": round(secs, 4),
                    "MDof_per_s": round(fes.ndof * info.iterations / secs / 1e6, 2),
                    "dtype": str(dtype), "device": name,
                    "structured": structured, "simplex": simplex, "ell": ell}
            print(json.dumps(line), flush=True)
            after = launch_counts()
            results.append(dict(
                line, seconds_exact=secs, setup_s=setup_s,
                peak_bytes=torch.cuda.max_memory_allocated(device) if cuda else None,
                launches={k: after[k] - before[k] for k in after},
                padding=getattr(op, "padding", None), fes=fes, op=op,
                matrix=matrix, x=x))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--orders", default="1,2,3,4")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--structured", action="store_true",
                    help="the Cartesian gather-free restriction")
    ap.add_argument("--simplex", action="store_true",
                    help="tet mesh (dense basis, lane-major apply)")
    ap.add_argument("--ell", action="store_true",
                    help="FULL-assembled matrix on the SELL SpMV kernel")
    args = ap.parse_args(argv)
    run([int(o) for o in args.orders.split(",")], args.n, args.dtype,
        args.iters, args.structured, args.simplex, args.ell,
        "cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
