#!/usr/bin/env python3
"""Trace one implicit SDIRK33 step of the port's main paths on the GPU and
print where the device time goes.

    python3 profile_step.py [hex126] [masked126] [lattice48] [tet66] [tetpa66]
                            [par126] [poisson126] [chebyshev126] [ex2]

Each path is set up as ``chip_smoke.py`` sets it up (float32, order 2,
quad_extra 0, θ form, rel_tol 1e-5): ``hex126`` the generic cardiac-hex
path [4], ``masked126`` the masked cardiac-hex lattice [10], ``lattice48``
bench.py's default 48³ lattice [9], ``tet66`` the assembled-ELL cardiac
tet path [7], ``tetpa66`` the partial-assembly tet path [16] (the affine
apply), ``par126`` the sharded step of ``parallel/bioheat`` at world size 1
over NCCL on the [4] mesh ([22b]: T form, Jacobi; its ranges are the mass
einsums and the restriction in both directions, and the NCCL kernels of
its ``all_reduce``d dots are summed beside the port's).  After one warm-up step, the
profiler runs through one more step (its own warm-up, not recorded, so the
tracer is steady before the traced step's first launch) and then traces
one step, with a ``record_function`` range around each layer (the
lane-major or affine stage apply, the residual (K + M_ω)T and, inside it
on the element-major path, the mass einsums, the restriction in both
directions, the ELL stage plane formed once per solve).  Printed per path: the
step's wall time, the device time and call count of each range (ranges
nest: the residual includes its restriction and mass parts), the device
time and launches of each of the port's own kernels (launched through
ctypes, which the profiler ties to no range, so the ranges leave them out;
the traced launches must equal the wrappers' own counts of the step) and
the restriction kernels' sum, the rest of the device time (CG vector updates, dots, masks, stage
combinations), the ten kernels with the most device time, and the
device's busy time over the step's wall time (idle share).

``poisson126`` traces one ``"lor"`` PCG solve of ``chip_smoke.py`` [13]'s
problem instead (the [4] mesh, order 2, float32, κ 0.54, u = 0 on
attributes 2 and 3, rel_tol 1e-5), after an untraced solve and the
profiler's warm-up solve.  Its layers are timed by CUDA-event pairs
recorded around each call on the card's stream (no host sync; a pair
spans the call's kernels, the ctypes ones included, and any wait for the
host between them): the high-order apply, the V-cycle, the fine LOR
apply, the transfers, the coarse CG, the order-1 apply and the Chebyshev
smoothers, each with its time inclusive and without its nested layers;
the profiler gives the wall time, the device's busy time and the port's
kernels by name.  Then one coarse solve is timed as the V-cycle runs it
(CG reading the host every iteration) against the same 32 iterations
without host reads (the same operations, equal bit for bit): their
difference is what the coarse CG's host syncs cost.  The layers' wrappers
are removed again before any other path runs.

``chebyshev126`` traces nothing: it measures why ``"chebyshev"`` PCG on
[13]'s problem in float64 reports convergence early (``chebyshev_bound``):
the 20-step eigenvalue estimate against longer power and Lanczos runs, the
sign of the smoother's polynomial at the spectrum's top, and (r, z) of the
PCG by iteration, with the estimate and with the Lanczos bound.

``ex2`` traces [20]'s elasticity apply instead: the PA operator of the
128x16x16 beam (order 2, vdim 3, float64) as ``models/elasticity.solve``'s
Jacobi-PCG calls it, timed by CUDA events (median of 20 calls after
warm-up) and traced once after a profiler warm-up call: its device time by
kernel (the ten largest, with launches), the port's restriction kernels
(three gathers and three segment-sums a call, one per component) and the
device's idle share of the traced call.

Needs a CUDA device.
"""

from __future__ import annotations

import functools
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function, schedule

import chip_smoke as cs

LAYERS = {}      # range name -> patched (owner, attribute)
STAGE = "stage apply"                 # one CG apply: restriction + lane-major
RESIDUAL = "residual (K + M_w)T"      # restriction, diffusion kernel, mass
PLANE = "ELL stage plane"             # c0·w0 + c1·w1, once per solve
MASS = "mass apply (einsum)"          # ops/mass.apply


def _wrap(owner, attr, name):
    fn = getattr(owner, attr)

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with record_function(name):
            return fn(*args, **kw)

    setattr(owner, attr, wrapped)
    LAYERS[name] = (owner, attr)


def instrument():
    from cardiac_ablation_ecm2_tpu_torch.fem.cartesian import StructuredRestriction
    from cardiac_ablation_ecm2_tpu_torch.fem.restriction import ElementRestriction
    from cardiac_ablation_ecm2_tpu_torch.models.bioheat import BioheatOperator
    from cardiac_ablation_ecm2_tpu_torch.ops import lanemajor, mass
    from cardiac_ablation_ecm2_tpu_torch.ops.ell import MultiELLPair

    stage_apply = BioheatOperator._stage_apply

    def staged(self, gamma):
        apply = stage_apply(self, gamma)

        def ranged(v):
            with record_function(STAGE):
                return apply(v)

        return ranged

    BioheatOperator._stage_apply = staged
    _wrap(BioheatOperator, "_A_apply", RESIDUAL)
    _wrap(lanemajor, "mass_diffusion_apply", "lane-major apply")
    _wrap(lanemajor, "affine_mass_diffusion_apply", "affine apply")
    _wrap(mass, "apply", MASS)
    _wrap(MultiELLPair, "combined", PLANE)
    for cls in (StructuredRestriction, ElementRestriction):
        for attr in ("mult", "mult_t"):
            _wrap(cls, attr, "restriction L->E")
        for attr in ("mult_transpose", "mult_transpose_t"):
            _wrap(cls, attr, "restriction E->L")


def _device_us(evt):
    if hasattr(evt, "device_time_total"):
        return evt.device_time_total
    return evt.cuda_time_total


def _on_device(e):
    """A kernel, copy or fill on the card (not the annotation a range
    leaves on the device's timeline)."""
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key not in LAYERS and e.key not in ("step", STAGE, PLANE))


def _port_kernel(key):
    """Which of the port's kernels a device event is, or None.  They are
    launched through ctypes, outside any PyTorch operator, so the profiler
    ties them to no range: they are summed by name instead."""
    if "anonymous namespace" not in key and "_GLOBAL__N_" not in key:
        return None
    for name, stem in (("fused_diffusion", "diffusion_kernel"),
                       ("gather_transpose", "gather_transpose_kernel"),
                       ("segment_sum", "segment_sum_kernel"),
                       ("gather_sum", "gather"), ("ell_spmv", "sell_spmv")):
        if stem in key:
            return name
    return None


def _busy_us(prof):
    """Union of the device's kernel, copy and fill intervals, in µs."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if _on_device(e))
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


@functools.lru_cache(maxsize=1)
def _tet_space(n):
    """``chip_smoke.tet_space``, built once for ``tet66`` and ``tetpa66``."""
    return cs.tet_space(n)


def build(path, dev):
    from cardiac_ablation_ecm2_tpu_torch.fem.cartesian import CartesianFESpace
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.models.bioheat import BioheatOperator

    if path == "hex126":
        fes = FESpace(make_cardiac_hex_mesh(126, lengths=(cs.L, cs.L, cs.L / 2),
                                            electrode_radius=0.004), 2)
        return BioheatOperator(fes, q_met=cs.source, dtype="float32",
                               device=dev, **cs.SETTINGS)
    if path == "masked126":
        _, fes, kw, _, _ = cs.masked_space(126)
        return BioheatOperator(fes, q_met=cs.source, dtype="float32",
                               device=dev, **dict(cs.SETTINGS, **kw))
    if path in ("tet66", "tetpa66"):
        _, fes, _ = _tet_space(66)
        ell = dict(assembled_apply="ell") if path == "tet66" else {}
        return BioheatOperator(fes, q_met=cs.source, dtype="float32",
                               device=dev, **ell, **cs.SETTINGS)
    if path == "lattice48":
        fes = CartesianFESpace(make_cartesian_3d(48, 48, 48, cs.L, cs.L, cs.L),
                               2, (48, 48, 48), (cs.L,) * 3)
        return BioheatOperator(fes, q_met=cs.lattice_source, dtype="float32",
                               device=dev, collapse_uniform_qdata=True,
                               **cs.SETTINGS)
    raise ValueError(f"unknown path {path!r}")


def trace(path, dev):
    from cardiac_ablation_ecm2_tpu_torch.linalg import ode
    from cardiac_ablation_ecm2_tpu_torch.models import bioheat

    if path == "par126":
        return trace_par(dev)
    op = build(path, dev)
    step = bioheat.make_stepper(op, ode.select("sdirk33"))
    T = torch.zeros(op.fes.ndof, dtype=op.dtype, device=dev)
    trace_step(path, step, T, op.fes.ndof, op.cg_iterations,
               (STAGE, RESIDUAL, PLANE))
    del op, T
    torch.cuda.empty_cache()


def trace_par(dev):
    """``par126``: the sharded step ([22b]) at world size 1 over NCCL."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
    from cardiac_ablation_ecm2_tpu_torch.parallel import bioheat as pbio
    from cardiac_ablation_ecm2_tpu_torch.parallel import launch

    fes = FESpace(make_cardiac_hex_mesh(126, lengths=(cs.L, cs.L, cs.L / 2),
                                        electrode_radius=0.004), 2)

    def body(rank, world, d):
        sim = pbio.setup(fes.mesh, order=2, q_src=cs.dress_source,
                         dtype="float32", device=d, fes=fes, **cs.PAR)
        trace_step("par126", sim.step, sim.T0, fes.ndof, sim.cg_iterations,
                   (MASS,))

    launch.run_single(body, dev)
    torch.cuda.empty_cache()


def trace_step(label, step, T, ndof, cg_iterations, top):
    """One warm-up step, one the profiler warms up on, one traced step
    ``step(T, t, dt)``; prints its device time by layer and kernel.  ``top``
    names the ranges that nest in no other range and hold none of the
    port's kernels: the rest of the device time is what they, the port's
    kernels and the NCCL kernels leave."""
    t = 0.0
    T, t = step(T, t, 0.25)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        T, t = step(T, t, 0.25)              # the profiler's warm-up
        n_its = len(cg_iterations)
        cs.start_main_path()
        prof.step()
        h0 = time.perf_counter()
        with record_function("step"):
            T, t = step(T, t, 0.25)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - h0) * 1e6
        launches = cs.main_path_launches()
        prof.step()
    its = cg_iterations[n_its:]
    names = list(dict.fromkeys(("step", STAGE, RESIDUAL, PLANE, *LAYERS)))
    ranges = {n: [0.0, 0] for n in names}      # device µs, calls
    ported = {}                                # port kernel -> [µs, launches]
    nccl = [0.0, 0]                            # NCCL kernels: µs, launches
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.key in ranges:
            ranges[e.key][0] += _device_us(e)
            ranges[e.key][1] += 1
        elif _on_device(e) and _port_kernel(e.key):
            k = ported.setdefault(_port_kernel(e.key), [0.0, 0])
            k[0] += e.time_range.end - e.time_range.start
            k[1] += 1
        elif _on_device(e) and "nccl" in e.key.lower():
            nccl[0] += e.time_range.end - e.time_range.start
            nccl[1] += 1
    for name, n in launches.items():
        traced = ported.get(name, [0.0, 0])[1]
        cs.check(traced == n, f"{label}: the trace holds {traced} of the step's "
                 f"{n} {name} launches")
    busy = _busy_us(prof)
    total = max(busy, 1e-9)
    print(f"== {label}: {ndof} dofs, CG iterations {its}; step wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms (idle "
          f"share {1 - busy / wall_us:.1%}); PyTorch operators in the step "
          f"range {ranges['step'][0] / 1e3:.3f} ms, the port's kernels "
          f"{sum(k[0] for k in ported.values()) / 1e3:.3f} ms; shares of "
          f"busy time:")
    rest = total - nccl[0]
    for name in names[1:]:
        us, calls = ranges[name]
        if name in top:
            rest -= us
        print(f"  {name:28s} {us / 1e3:9.3f} ms  {us / total:6.1%}  "
              f"{calls:4d} calls")
    for name, (us, n) in sorted(ported.items()):
        rest -= us
        print(f"  kernel {name:21s} {us / 1e3:9.3f} ms  {us / total:6.1%}  "
              f"{n:4d} launches")
    print(f"  {'NCCL kernels (all_reduce)':28s} {nccl[0] / 1e3:9.3f} ms  "
          f"{nccl[0] / total:6.1%}  {nccl[1]:4d} launches")
    print(f"  {'other (CG vectors, dots)':28s} {rest / 1e3:9.3f} ms  "
          f"{rest / total:6.1%}")
    restr = [ported.get(k, [0.0, 0]) for k in cs.RESTRICTION_KERNELS]
    print(f"  restriction kernels in the step: {sum(k[0] for k in restr) / 1e3:.3f} "
          f"ms, {sum(k[1] for k in restr)} launches")
    kernels = sorted((e for e in prof.key_averages() if _on_device(e)),
                     key=_device_us, reverse=True)
    print("  top kernels (device ms, calls):")
    for e in kernels[:10]:
        print(f"    {_device_us(e) / 1e3:9.3f}  {e.count:5d}  {e.key[:90]}")


class Spans:
    """Device time of nested layers from CUDA-event pairs recorded on the
    current stream around each call while ``on``; read after a sync."""

    def __init__(self):
        self.on = False
        self.stack = []
        self.records = []            # [name, parent index, start, end]

    def wrap(self, fn, name):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            if not self.on:
                return fn(*args, **kw)
            n = name(*args) if callable(name) else name
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            self.records.append([n, self.stack[-1] if self.stack else None,
                                 start, end])
            self.stack.append(len(self.records) - 1)
            start.record()
            try:
                return fn(*args, **kw)
            finally:
                end.record()
                self.stack.pop()

        return wrapped

    def totals(self):
        """{name: [inclusive ms, ms without nested layers, calls]}."""
        torch.cuda.synchronize()
        out = {}
        for name, parent, start, end in self.records:
            ms = start.elapsed_time(end)
            row = out.setdefault(name, [0.0, 0.0, 0])
            row[0] += ms
            row[1] += ms
            row[2] += 1
            if parent is not None:
                out[self.records[parent][0]][1] -= ms
        return out


def cg_without_reads(A, b, M, iters):
    """``linalg.solvers.cg`` from x0 = 0 for exactly ``iters`` iterations,
    its operations in its order, without reading the host."""
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import default_dot as dot

    x = torch.zeros_like(b)
    r = b - A(x)
    d = M(r)
    nom = dot(d, r)
    for _ in range(iters):
        Ad = A(d)
        alpha = nom / dot(d, Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        z = M(r)
        betanom = dot(r, z)
        d = z + (betanom / nom) * d
        nom = betanom
    return x


def trace_poisson(dev):
    """``poisson126``: one traced LOR-PCG solve, its layers, and the cost
    of the coarse CG's host reads."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.fem.transfer import PTransfer
    from cardiac_ablation_ecm2_tpu_torch.linalg import multigrid, smoothers
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
    from cardiac_ablation_ecm2_tpu_torch.ops import lor_device
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import PAOperator
    from cardiac_ablation_ecm2_tpu_torch.ops.operators import ConstrainedOperator

    P = cs.POISSON
    fes = FESpace(make_cardiac_hex_mesh(126, lengths=(cs.L, cs.L, cs.L / 2),
                                        electrode_radius=0.004), P["order"])
    spans = Spans()
    fine = fes.ndof
    chebyshev = smoothers.chebyshev

    def ranged_chebyshev(A, diag, *args, **kw):
        level = "LOR level" if diag.shape[0] == fine else "order-1 level"
        return spans.wrap(chebyshev(A, diag, *args, **kw), f"Chebyshev ({level})")

    patches = [
        (ConstrainedOperator, "mult", "high-order apply"),
        (PAOperator, "mult",
         lambda op, x: f"PA apply ({'order 2' if op.ndof == fine else 'order 1'})"),
        (lor_device.DeviceLOROperator, "mult", "LOR apply"),
        (PTransfer, "prolongate", "transfers"),
        (PTransfer, "restrict_t", "transfers"),
        (multigrid.Multigrid, "_coarse_solve", "coarse CG"),
    ]
    originals = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    originals.append((smoothers, "chebyshev", chebyshev))
    for owner, attr, name in patches:
        setattr(owner, attr, spans.wrap(getattr(owner, attr), name))
    smoothers.chebyshev = ranged_chebyshev
    try:
        _trace_poisson(dev, fes, spans)
    finally:
        # the other paths run the unpatched code
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)


def _trace_poisson(dev, fes, spans):
    """The body of ``trace_poisson``, run while the layers are wrapped."""
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.ops import lor_device
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf
    from cardiac_ablation_ecm2_tpu_torch.ops.operators import form_linear_system

    P = cs.POISSON
    A = BilinearForm(fes, dev).add_domain_integrator(
        "diffusion", P["kappa"]).assemble("float32").operator()
    b = domain_lf(fes, P["rhs"], dtype="float32", device=dev)
    x0 = torch.zeros(fes.ndof, dtype=torch.float32, device=dev)
    Ac, B = form_linear_system(A, fes.essential_dofs(P["ess_bdr"]), x0, b)
    mg = lor_device.make_lor_multigrid(fes, P["kappa"], ess_bdr=P["ess_bdr"],
                                       dtype="float32", device=dev)
    M = spans.wrap(mg.preconditioner(), "V-cycle")

    def solve():
        return cg(Ac.mult, B, x0=x0, M=M, rel_tol=P["rel_tol"],
                  max_iter=P["max_iter"])

    solve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        solve()                              # the profiler's warm-up
        cs.start_main_path()
        prof.step()
        spans.on = True
        h0 = time.perf_counter()
        with record_function("step"):
            x, info = spans.wrap(solve, "PCG solve")()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - h0) * 1e6
        spans.on = False
        launches = cs.main_path_launches()
        prof.step()
    ported = {}
    for e in prof.events():
        if _on_device(e) and _port_kernel(e.key):
            k = ported.setdefault(_port_kernel(e.key), [0.0, 0])
            k[0] += e.time_range.end - e.time_range.start
            k[1] += 1
    for name, n in launches.items():
        traced = ported.get(name, [0.0, 0])[1]
        cs.check(traced == n, f"poisson126: the trace holds {traced} of the "
                 f"solve's {n} {name} launches")
    busy = _busy_us(prof)
    rows = spans.totals()
    solve_ms = rows["PCG solve"][0]
    print(f"== poisson126 (lor): {fes.ndof} dofs, {info.iterations} PCG iterations, "
          f"converged {info.converged}; solve wall {wall_us / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms (idle share {1 - busy / wall_us:.1%}); layers "
          f"by CUDA-event spans (inclusive ms, ms without nested layers, calls, "
          f"share of the solve's span {solve_ms:.3f} ms):")
    for name, (inc, own, calls) in rows.items():
        print(f"  {name:28s} {inc:10.3f} {own:10.3f} {calls:6d}  {inc / solve_ms:6.1%}")
    for name, (us, n) in sorted(ported.items()):
        print(f"  kernel {name:21s} {us / 1e3:9.3f} ms  {us / busy:6.1%} of busy  "
              f"{n:5d} launches")
    kernels = sorted((e for e in prof.key_averages() if _on_device(e)),
                     key=_device_us, reverse=True)
    print("  top kernels (device ms, calls):")
    for e in kernels[:10]:
        print(f"    {_device_us(e) / 1e3:9.3f}  {e.count:5d}  {e.key[:90]}")

    # the coarse CG's host reads: one coarse solve as the V-cycle runs it
    # against the same iterations without reads
    coarse = mg.levels[0]
    gen = torch.Generator(device=dev).manual_seed(13)
    rc = mg.levels[1].restrict_t(torch.randn(fes.ndof, generator=gen, device=dev))
    rc = rc.index_fill(0, coarse.ess, 0.0)
    _, cinfo = cg(coarse.A, rc, M=coarse.smoother, rel_tol=1e-8,
                  max_iter=mg.coarse_iters)
    read = cs.time_ms(lambda: mg._coarse_solve(rc), reps=5)
    free = cs.time_ms(lambda: cg_without_reads(coarse.A, rc, coarse.smoother,
                                               cinfo.iterations), reps=5)
    same = torch.equal(mg._coarse_solve(rc),
                       cg_without_reads(coarse.A, rc, coarse.smoother,
                                        cinfo.iterations))
    print(f"  coarse solve ({cinfo.iterations} CG iterations, {rc.numel()} dofs): "
          f"{read:.3f} ms with a host read an iteration, {free:.3f} ms without "
          f"(equal bit for bit: {same}); the reads cost {read - free:.3f} ms a "
          f"V-cycle, {(read - free) / max(cinfo.iterations, 1) * 1e3:.1f} us an "
          f"iteration, {(read - free) * rows['V-cycle'][2]:.1f} ms of this solve")
    cs.check(same, "poisson126: the read-free coarse CG equals the coarse solve")
    del mg, Ac, A
    torch.cuda.empty_cache()


def lanczos_max(A, dinv, v, steps):
    """Largest Ritz value of D^{-1/2} A D^{-1/2} (the spectrum of D⁻¹A)
    after ``steps`` Lanczos steps from ``v``.  Without reorthogonalisation
    the largest Ritz value still rises monotonically to λ_max from below,
    so it is a lower bound of λ_max."""
    s = dinv.sqrt()
    q = v / v.norm()
    q_prev, beta = torch.zeros_like(q), 0.0
    alphas, betas = [], []
    for _ in range(steps):
        w = s * A(s * q) - beta * q_prev
        alpha = float(torch.dot(w, q))
        w = w - alpha * q
        beta = float(w.norm())
        alphas.append(alpha)
        betas.append(beta)
        q_prev, q = q, w / beta
    T = np.diag(alphas) + np.diag(betas[:-1], 1) + np.diag(betas[:-1], -1)
    return float(np.linalg.eigvalsh(T)[-1])


def chebyshev_bound(dev, n=126, rel_tol=1e-9):
    """``chebyshev126``: [13]'s problem in float64 with ``"chebyshev"``
    (order 4 on [λ/30, 1.1·λ], λ the 20-step power estimate of D⁻¹A, as
    ``models/poisson.solve`` builds it).  Prints the 20-step estimate, a
    1,000-step power run and a 300-step Lanczos bound of λ_max(D⁻¹A) from
    the same seeded start, and, for the 20-step and the Lanczos bound,
    the least value of the smoother's polynomial p(λ) up to the Lanczos
    bound (≤ 0: the preconditioner is singular or indefinite there); then PCG at ``rel_tol`` with the 20-step bound and
    with the Lanczos one: iterations, the converged flag, the true relative
    residual, the iteration of the first (r, z) < 0, (r, z) at the stop
    against the stopping target, and (r, Mr)/(r, r) of the true
    residual."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.smoothers import chebyshev
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import (
        cg, default_dot, power_method)
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf
    from cardiac_ablation_ecm2_tpu_torch.ops.operators import form_linear_system

    P = cs.POISSON
    f64 = torch.float64
    fes = FESpace(make_cardiac_hex_mesh(n, lengths=(cs.L, cs.L, cs.L / 2),
                                        electrode_radius=0.004), P["order"])
    A = BilinearForm(fes, dev).add_domain_integrator(
        "diffusion", P["kappa"]).assemble("float64").operator()
    b = domain_lf(fes, P["rhs"], dtype="float64", device=dev)
    Ac, B = form_linear_system(A, fes.essential_dofs(P["ess_bdr"]),
                               torch.zeros_like(b), b)
    diag = Ac.diagonal()
    dinv = 1.0 / diag

    def DinvA(v):
        return dinv * Ac.mult(v)

    start = torch.rand(fes.ndof, generator=torch.Generator().manual_seed(7),
                       dtype=f64).to(dev)                 # power_method's start
    t0 = time.perf_counter()
    est = float(power_method(DinvA, iters=20, v0=start))
    long = float(power_method(DinvA, iters=1000, v0=start))
    lmax = lanczos_max(Ac.mult, dinv, start, 300)
    est_s = time.perf_counter() - t0
    check_est = float(power_method(DinvA, fes.ndof, iters=20, dtype=f64,
                                   device=dev))
    cs.check(check_est == est, "chebyshev126: the seeded start is power_method's")

    grid = torch.linspace(0.0, lmax, 4001, dtype=f64)[1:]

    def poly(eig_max):
        """p(λ) on the grid, p the order-4 smoother's polynomial on
        [eig_max/30, 1.1·eig_max]: the preconditioner scales an
        eigenvector of D⁻¹A of eigenvalue λ by p(λ) (after D⁻¹)."""
        one = torch.ones_like(grid)
        return chebyshev(lambda v: grid * v, one, eig_max=eig_max)(one)

    print(f"== chebyshev126: [13]'s problem in float64, {fes.ndof} dofs; "
          f"lambda_max(D^-1 A): 20-step power estimate {est:.9f}, 1,000-step "
          f"power run {long:.9f}, 300-step Lanczos {lmax:.9f} ({est_s:.2f} s); "
          f"Lanczos / estimate {lmax / est:.6f}")
    for label, eig_max in (("20-step", est), ("Lanczos", lmax)):
        p = poly(eig_max)
        i = int(p.argmin())
        print(f"  p(lambda) with the {label} bound on (0, {lmax:.6f}]: least "
              f"{float(p[i]):.6e} at lambda {float(grid[i]):.6f}, at the top "
              f"{float(p[-1]):.6e} (<= 0: the preconditioner is singular or "
              f"indefinite there)")
    sols = {}
    for label, eig_max in (("20-step", None), ("Lanczos", lmax)):
        noms = []

        def dot(x, y):
            v = default_dot(x, y)
            noms.append(v)
            return v

        M = chebyshev(Ac.mult, diag, eig_max=eig_max)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = cg(Ac.mult, B, M=M, rel_tol=rel_tol, max_iter=P["max_iter"],
                     dot=dot)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        rz = torch.stack(noms[:1] + noms[2::2]).cpu().numpy()   # (r, z) by iteration
        neg = np.flatnonzero(rz < 0)
        r = B - Ac.mult(x)
        res = float(r.norm() / B.norm())
        ratio = float(torch.dot(r, M(r)) / torch.dot(r, r))
        sols[label] = x
        print(f"  PCG with the {label} bound: {info.iterations} iterations in "
              f"{solve_s:.3f} s, converged {info.converged}, true relative "
              f"residual {res:.3e}; (r, z) at the start {rz[0]:.6e}, at the stop "
              f"{rz[-1]:.6e} against the target {rel_tol ** 2 * rz[0]:.6e}; first "
              f"(r, z) < 0 at iteration "
              f"{int(neg[0]) if len(neg) else None} ({len(neg)} negative); the "
              f"true residual's (r, Mr)/(r, r) {ratio:.6e}")
    u, ref = sols.values()                     # 20-step, Lanczos
    print(f"  max|u - u_Lanczos| / max|u_Lanczos| "
          f"{float((u - ref).abs().max() / ref.abs().max()):.3e}")
    del A, Ac, sols, u, ref
    torch.cuda.empty_cache()


def trace_ex2(dev):
    """[20]'s elasticity apply on the 128x16x16 beam: time, device time by
    kernel, the restriction kernels and the idle share."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm

    fes = FESpace(make_cartesian_3d(128, 16, 16, sx=8.0), 2, vdim=3)
    A = BilinearForm(fes, dev).add_domain_integrator(
        "elasticity", (1.0, 1.0)).assemble("float64")
    gen = torch.Generator(device=dev).manual_seed(20)
    x = torch.randn(fes.ndof, generator=gen, device=dev, dtype=torch.float64)
    ms = cs.time_ms(lambda: A.mult(x))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        A.mult(x)                              # the profiler's warm-up
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        A.mult(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    rows = {}
    for e in prof.events():
        if _on_device(e):
            row = rows.setdefault(e.key, [0.0, 0])
            row[0] += e.time_range.end - e.time_range.start
            row[1] += 1
    device_us = sum(r[0] for r in rows.values())
    busy = _busy_us(prof)
    print(f"== ex2: elasticity PA apply, 128x16x16 beam order 2 vdim 3 f64, "
          f"{fes.ndof} dofs, {fes.mesh.ne} hexes")
    print(f"  {ms:.3f} ms a call (CUDA events, median of 20); traced call: "
          f"wall {wall_us / 1e3:.3f} ms, device {device_us / 1e3:.3f} ms in "
          f"{sum(r[1] for r in rows.values())} launches, busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.1%}")
    port = {}
    for key, (us, n) in rows.items():
        name = _port_kernel(key)
        if name:
            port[name] = [port.get(name, [0.0, 0])[0] + us,
                          port.get(name, [0.0, 0])[1] + n]
    print("  port kernels: " + ", ".join(f"{k} {v[0] / 1e3:.3f} ms ({v[1]})"
                                         for k, v in sorted(port.items())))
    for key, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {us / 1e3:8.3f} ms {us / device_us:6.1%} {n:4d}x  {key[:110]}")


def main():
    paths = sys.argv[1:] or ["hex126", "masked126", "lattice48", "tet66"]
    dev = cs.phase_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"clocks.sm, power.draw: {smi}")
    from cardiac_ablation_ecm2_tpu_torch.utils.config import configure

    configure(quad_extra=0)
    cs.phase_build()
    if "poisson126" in paths:
        trace_poisson(dev)
    if "chebyshev126" in paths:
        chebyshev_bound(dev)
    if "ex2" in paths:
        trace_ex2(dev)
    rest = [p for p in paths if p not in ("poisson126", "chebyshev126", "ex2")]
    if rest:
        instrument()
    for path in rest:
        trace(path, dev)


if __name__ == "__main__":
    main()
