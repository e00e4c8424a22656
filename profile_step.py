#!/usr/bin/env python3
"""Trace one implicit SDIRK33 step of the port's main paths on the GPU and
print where the device time goes.

    python3 profile_step.py [hex126] [masked126] [lattice48] [tet66]

Each path is set up as ``chip_smoke.py`` sets it up (float32, order 2,
quad_extra 0, θ form, rel_tol 1e-5): ``hex126`` the generic cardiac-hex
path [4], ``masked126`` the masked cardiac-hex lattice [10], ``lattice48``
bench.py's default 48³ lattice [9], ``tet66`` the assembled-ELL cardiac
tet path [7].  After one warm-up step, the
profiler runs through one more step (its own warm-up, not recorded, so the
tracer is steady before the traced step's first launch) and then traces
one step, with a ``record_function`` range around each layer (the
lane-major stage apply, the element-major residual and, inside it, the
mass einsums, the restriction in both directions, the ELL stage plane
formed once per solve).  Printed per path: the
step's wall time, the device time and call count of each range (ranges
nest: the residual includes its restriction and mass parts), the device
time and launches of each of the port's own kernels (launched through
ctypes, which the profiler ties to no range, so the ranges leave them out;
the traced launches must equal the wrappers' own counts of the step) and
the restriction kernels' sum, the rest of the device time (CG vector updates, dots, masks, stage
combinations), the ten kernels with the most device time, and the
device's busy time over the step's wall time (idle share).  Needs a CUDA
device.
"""

from __future__ import annotations

import functools
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function, schedule

import chip_smoke as cs

LAYERS = {}      # range name -> patched (owner, attribute)
STAGE = "stage apply"                 # one CG apply: restriction + lane-major
RESIDUAL = "residual (element-major)"  # restriction, diffusion kernel, mass
PLANE = "ELL stage plane"             # c0·w0 + c1·w1, once per solve


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
    _wrap(BioheatOperator, "_apply", RESIDUAL)
    _wrap(lanemajor, "mass_diffusion_apply", "lane-major apply")
    _wrap(mass, "apply", "mass apply (einsum)")
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
    if path == "tet66":
        _, fes, _ = cs.tet_space(66)
        return BioheatOperator(fes, q_met=cs.source, dtype="float32",
                               device=dev, assembled_apply="ell", **cs.SETTINGS)
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

    op = build(path, dev)
    step = bioheat.make_stepper(op, ode.select("sdirk33"))
    T, t = torch.zeros(op.fes.ndof, dtype=op.dtype, device=dev), 0.0
    T, t = step(T, t, 0.25)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        T, t = step(T, t, 0.25)              # the profiler's warm-up
        n_its = len(op.cg_iterations)
        cs.start_main_path()
        prof.step()
        h0 = time.perf_counter()
        with record_function("step"):
            T, t = step(T, t, 0.25)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - h0) * 1e6
        launches = cs.main_path_launches()
        prof.step()
    its = op.cg_iterations[n_its:]
    names = list(dict.fromkeys(("step", STAGE, RESIDUAL, PLANE, *LAYERS)))
    ranges = {n: [0.0, 0] for n in names}      # device µs, calls
    ported = {}                                # port kernel -> [µs, launches]
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.key in ranges:
            ranges[e.key][0] += _device_us(e)
            ranges[e.key][1] += 1
        elif _on_device(e) and _port_kernel(e.key):
            k = ported.setdefault(_port_kernel(e.key), [0.0, 0])
            k[0] += e.time_range.end - e.time_range.start
            k[1] += 1
    for name, n in launches.items():
        traced = ported.get(name, [0.0, 0])[1]
        cs.check(traced == n, f"{path}: the trace holds {traced} of the step's "
                 f"{n} {name} launches")
    busy = _busy_us(prof)
    total = max(busy, 1e-9)
    print(f"== {path}: {op.fes.ndof} dofs, CG iterations {its}; step wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms (idle "
          f"share {1 - busy / wall_us:.1%}); PyTorch operators in the step "
          f"range {ranges['step'][0] / 1e3:.3f} ms, the port's kernels "
          f"{sum(k[0] for k in ported.values()) / 1e3:.3f} ms; shares of "
          f"busy time:")
    rest = total
    for name in names[1:]:
        us, calls = ranges[name]
        if name in (STAGE, RESIDUAL, PLANE):
            rest -= us
        print(f"  {name:28s} {us / 1e3:9.3f} ms  {us / total:6.1%}  "
              f"{calls:4d} calls")
    for name, (us, n) in sorted(ported.items()):
        rest -= us
        print(f"  kernel {name:21s} {us / 1e3:9.3f} ms  {us / total:6.1%}  "
              f"{n:4d} launches")
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
    del op, T
    torch.cuda.empty_cache()


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
    instrument()
    for path in paths:
        trace(path, dev)


if __name__ == "__main__":
    main()
