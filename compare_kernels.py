#!/usr/bin/env python3
"""Time the restriction and SpMV kernels of this checkout against those of
another checkout of the port (a parent commit), in one process on one GPU,
at the main-path shapes, in turns (other, this, this, other per round).

    python3 compare_kernels.py OTHER_DIR [--rounds 3] [--json PATH]
    python3 compare_kernels.py OTHER_DIR --probes [--rounds 3] [--json PATH]
    python3 compare_kernels.py --variants [--rounds 3] [--json PATH]

``--probes`` times the two redesigned probe gathers instead, each side's
``take_along_rows`` at t1 and u1 and ``take_along_lanes`` at t2 and u2
(three widths), on the probes' own inputs
(``benchmarks/gather_micro.table_probes``), each reading the device time
of one of 20 calls queued behind a sleep kernel (``gather_micro.cuda_ms``).
``--variants`` times the same probes on variants of this checkout's
``csrc/gather_probes.cu``, each with the constants of one item of
``VARIANTS`` changed (built into ``build/variants/``), in turns against the
source as it stands: the readings behind those constants.  A variant of
``kStripMinRatio`` is also timed at the ``CROSSOVER`` shapes, between u1's
and t1's, where the strip branch's threshold falls.

OTHER_DIR is the root of the other checkout; its
``cardiac_ablation_ecm2_tpu_torch`` package is loaded under another module
name and builds its kernels into its own ``build/``.  Both sides get the
same inputs, through the calls their main paths make:

* cardiac hex n=126 (995,336 hexes, order 2, float32): one CG apply's
  restriction, ``mult_t`` (L→E into (nd, ne)) and ``mult_transpose_t``
  (E→L from it), and the residual's element-major ``mult`` and
  ``mult_transpose``;
* cardiac tet n=66 (956,820 tets, order 2, float32): the stage operator's
  SpMV M_ρc + γ(K + M_ω) as each side's ``BioheatOperator`` runs it (the
  other side through its ``mult_combined``, this side through the plane
  formed once per solve),
  the residual's (K + M_ω), and the E→L of setup.

Gathers must agree bitwise; sums and products in value (an exact-zero sum
may differ in sign where one side adds padding +0.0).  Each reading is the
median CUDA-event time of one batch of calls; prints, per side, the median
of its readings with their least and greatest and, with ``--json PATH``,
writes every reading there as JSON; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

ALIAS = "other_port"


def load_other(root):
    """The other checkout's port package, imported as ``ALIAS``."""
    pkg = os.path.join(os.path.abspath(root), "cardiac_ablation_ecm2_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        ALIAS, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[ALIAS] = mod
    spec.loader.exec_module(mod)
    return lambda name: importlib.import_module(f"{ALIAS}.{name}")


def in_turns(label, other, this, rounds, results, timer=cs.time_ms):
    """Readings of ``other`` and ``this`` in the order other, this, this,
    other per round, each reading one ``timer`` (by default the median of
    one ``cs.time_ms``); prints and records the median of each side's
    readings, with their least and greatest."""
    t = {"other": [], "this": []}
    for _ in range(rounds):
        for side in ("other", "this", "this", "other"):
            t[side].append(timer(other if side == "other" else this))
    o, n = float(np.median(t["other"])), float(np.median(t["this"]))
    print(f"{label}: other {o:.4f} ms (min {min(t['other']):.4f}, max "
          f"{max(t['other']):.4f}), this {n:.4f} ms (min {min(t['this']):.4f}, "
          f"max {max(t['this']):.4f}); this/other {n / o:.3f}")
    results[label] = dict(other_ms=o, this_ms=n, other=t["other"], this=t["this"])


def agree(label, a, b, bitwise):
    ok = torch.equal(cs.bits(a), cs.bits(b)) if bitwise else torch.equal(a, b)
    cs.check(ok, f"{label}: both sides agree {'bitwise' if bitwise else 'in value'}")


def hex_restriction(mod, dev, rounds, results):
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.fem.restriction import ElementRestriction
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh

    fes = FESpace(make_cardiac_hex_mesh(126, lengths=(cs.L, cs.L, cs.L / 2),
                                        electrode_radius=0.004), 2)
    ro = mod("fem.restriction").ElementRestriction(fes.gather_map, fes.ndof, dev)
    rn = ElementRestriction(fes.gather_map, fes.ndof, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    u = torch.randn(fes.ndof, generator=gen, device=dev)
    ue = torch.randn(rn.ne, rn.nd, generator=gen, device=dev)
    ueT = ue.T.contiguous()
    agree("hex mult_t", ro.mult_t(u), rn.mult_t(u), True)
    agree("hex mult_transpose_t", ro.mult_transpose_t(ueT),
          rn.mult_transpose_t(ueT), False)
    agree("hex mult", ro.mult(u), rn.mult(u), True)
    agree("hex mult_transpose", ro.mult_transpose(ue), rn.mult_transpose(ue), False)
    print(f"hex n=126: {rn.ne} hexes, {fes.ndof} dofs")
    for label, fo, fn in (
            ("hex L->E (nd,ne) mult_t", lambda: ro.mult_t(u), lambda: rn.mult_t(u)),
            ("hex E->L (nd,ne) mult_transpose_t",
             lambda: ro.mult_transpose_t(ueT), lambda: rn.mult_transpose_t(ueT)),
            ("hex round trip mult_t + mult_transpose_t",
             lambda: ro.mult_transpose_t(ro.mult_t(u)),
             lambda: rn.mult_transpose_t(rn.mult_t(u))),
            ("hex L->E (ne,nd) mult", lambda: ro.mult(u), lambda: rn.mult(u)),
            ("hex E->L (ne,nd) mult_transpose",
             lambda: ro.mult_transpose(ue), lambda: rn.mult_transpose(ue))):
        in_turns(label, fo, fn, rounds, results)


def tet_spmv(mod, dev, rounds, results):
    from cardiac_ablation_ecm2_tpu_torch.fem.restriction import ElementRestriction
    from cardiac_ablation_ecm2_tpu_torch.ops import ell

    _, fes, _ = cs.tet_space(66)
    M, K, Mw = cs.assemble_pair(fes, dev)
    A = K + Mw
    t0 = time.perf_counter()
    po = mod("ops.ell").MultiELLPair.from_csr_pair(M, A, "float32", dev)
    t1 = time.perf_counter()
    pn = ell.MultiELLPair.from_csr_pair(M, A, "float32", dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"tet n=66: {fes.ndof} dofs, {pn.nnz} nnz; host packing other "
          f"{t1 - t0:.2f} s, this {t2 - t1:.2f} s; slots other {po.cols.numel()}, "
          f"this {pn.cols.numel()}")
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(fes.ndof),
                        dtype=torch.float32, device=dev)
    stage, resid = pn.combined(1.0, cs.GAMMA), pn.combined(0.0, 1.0)
    form = cs.time_ms(lambda: pn.combined(1.0, cs.GAMMA))
    print(f"tet: forming the stage plane, once per solve: {form:.4f} ms")
    results["tet stage plane formed once per solve"] = dict(this_ms=form)
    fn_stage, fn_resid = stage.mult, resid.mult
    agree("tet stage SpMV", po.mult_combined(x, 1.0, cs.GAMMA), fn_stage(x), False)
    agree("tet residual SpMV", po.mult1(x), fn_resid(x), False)
    in_turns("tet stage SpMV", lambda: po.mult_combined(x, 1.0, cs.GAMMA),
             lambda: fn_stage(x), rounds, results)
    in_turns("tet residual SpMV", lambda: po.mult1(x), lambda: fn_resid(x),
             rounds, results)
    del po, pn
    ro = mod("fem.restriction").ElementRestriction(fes.gather_map, fes.ndof, dev)
    rn = ElementRestriction(fes.gather_map, fes.ndof, dev)
    ue = torch.randn(rn.ne, rn.nd, device=dev)
    agree("tet mult_transpose", ro.mult_transpose(ue), rn.mult_transpose(ue), False)
    in_turns("tet E->L (ne,nd) mult_transpose", lambda: ro.mult_transpose(ue),
             lambda: rn.mult_transpose(ue), rounds, results)


#: the probes each redesigned gather is timed at (``gather_micro`` names)
PROBES = {"take_along_rows": ("T1", "U1"), "take_along_lanes": ("T2", "U2")}
#: variants of csrc/gather_probes.cu: (the kernel whose probes they are
#: timed at, the constants changed).  kStripMinRatio 0 takes the strip
#: branch wherever a strip fits, 1 << 30 never; kDenseNum 0 stages every
#: lane gather whose rows fit, 1 << 20 none.
VARIANTS = (
    ("take_along_rows", {"kStripMinRatio": "0"}),
    ("take_along_rows", {"kStripMinRatio": "1 << 30"}),
    ("take_along_rows", {"kStageRatio": "2"}), ("take_along_rows", {"kStageRatio": "16"}),
    ("take_along_rows", {"kStripUnroll": "4"}), ("take_along_rows", {"kStripUnroll": "10"}),
    ("take_along_rows", {"kStripUnroll": "12"}),
    ("take_along_rows", {"kStripUnroll": "12", "kStageRatio": "2"}),
    ("take_along_rows", {"kStripThreads": "512"}),
    ("take_along_lanes", {"kDenseNum": "0"}), ("take_along_lanes", {"kDenseNum": "1 << 20"}),
    ("take_along_lanes", {"kTileBytes": "8192"}), ("take_along_lanes", {"kTileBytes": "32768"}),
    ("take_along_lanes", {"kTileBytes": "49152"}),
    ("take_along_lanes", {"kLanesUnroll": "1"}), ("take_along_lanes", {"kLanesLoads": "4"}))
#: take_along_rows (R, C, B) between u1 (B / R = 1) and t1 (3.3): t1's and
#: u1's tables at outputs of 0.5 to 8 MiB, B / R from 0.14 to 16 (float32,
#: seeded indices)
CROSSOVER = ((7_136, 128, 1_024), (7_136, 128, 2_048), (7_136, 128, 4_096),
             (7_136, 128, 8_192), (7_136, 128, 16_384), (512, 128, 1_024),
             (512, 128, 2_048), (512, 128, 8_192))


def probe_cases(dev):
    """(kernel, probe, data, idx) of every probe ``PROBES`` names."""
    from cardiac_ablation_ecm2_tpu_torch.benchmarks import gather_micro

    return [(p.kernel, p.name, *p.args) for p in gather_micro.table_probes(dev)
            if p.kernel in PROBES and p.name[:2] in PROBES[p.kernel]]


def probes_against(mod, dev, rounds, results):
    """This checkout's probe gathers against the other checkout's."""
    from cardiac_ablation_ecm2_tpu_torch.benchmarks import gather_micro
    from cardiac_ablation_ecm2_tpu_torch.ops import gather_probes as gp

    ogp = mod("ops.gather_probes")
    floor = gather_micro.cuda_ms(lambda: torch.cuda._sleep(0))
    print(f"launch floor (torch.cuda._sleep(0), 20 queued): {floor:.4f} ms")
    results["launch floor"] = dict(this_ms=floor)
    for kind, name, data, idx in probe_cases(dev):
        fo, fn = getattr(ogp, kind), getattr(gp, kind)
        label = f"{name} {tuple(data.shape)}<-{tuple(idx.shape)}"
        agree(label, fo(data, idx), fn(data, idx), True)
        in_turns(label, lambda: fo(data, idx), lambda: fn(data, idx), rounds,
                 results, timer=gather_micro.cuda_ms)


def variant_source(consts):
    """This checkout's gather_probes.cu with ``constexpr ... name = value;``
    for each item of ``consts``; returns its tag and its path."""
    import re

    from cardiac_ablation_ecm2_tpu_torch.ops import gather_probes as gp

    src = open(gp._SRC).read()
    for const, value in consts.items():
        pat = re.compile(rf"(constexpr\s+(?:int|int64_t)\s+{const}\s*=\s*)[^;]+;")
        cs.check(len(pat.findall(src)) == 1, f"one definition of {const}")
        src = pat.sub(lambda m: m.group(1) + value + ";", src)
    tag = ",".join(f"{c}={v.replace(' ', '')}" for c, v in consts.items())
    out_dir = os.path.join(os.path.dirname(os.path.abspath(cs.__file__)), "build",
                           "variants")
    os.makedirs(out_dir, exist_ok=True)
    name = "gather_probes_" + re.sub(r"\W", "_", tag)
    path = os.path.join(out_dir, name + ".cu")
    with open(path, "w") as f:
        f.write(src)
    return tag, path


def variant_lib(path):
    """Build a variant source and declare the two redesigned entry points'
    C signatures, as ``ops/gather_probes.build`` does for the source."""
    import ctypes

    from cardiac_ablation_ecm2_tpu_torch.utils.native import build_cuda

    lib = build_cuda(path, os.path.basename(path)[:-3])
    for kind in PROBES:
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{kind}_{suffix}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def variant_call(lib, kind):
    """``kind`` of a variant library, with the arguments and the stream
    ``ops/gather_probes.py`` gives the source's."""
    def call(data, idx):
        out = torch.empty(idx.shape, dtype=data.dtype, device=data.device)
        n3 = out.numel() if kind == "take_along_rows" else idx.shape[1]
        fn = getattr(lib, f"{kind}_{'f32' if data.dtype == torch.float32 else 'f64'}")
        rc = fn(data.data_ptr(), data.shape[0], data.shape[1], idx.data_ptr(), n3,
                out.data_ptr(), torch.cuda.current_stream(data.device).cuda_stream)
        cs.check(rc == 0, f"variant {kind} launched")
        return out
    return call


def crossover_cases(dev):
    """(kind, name, table, idx) of every ``CROSSOVER`` shape."""
    rng = np.random.default_rng(17)
    cases = []
    for R, C, B in CROSSOVER:
        table = torch.as_tensor(rng.standard_normal((R, C)), dtype=torch.float32,
                                device=dev)
        idx = torch.as_tensor(rng.integers(0, R, (B, C)), dtype=torch.int32, device=dev)
        cases.append(("take_along_rows", f"X ({R}, {C})<-({B}, {C})", table, idx))
    return cases


def variants(dev, rounds, results):
    """Every variant of ``VARIANTS`` against this checkout's source, in
    turns, at the probes of its kernel (and, for kStripMinRatio, at the
    ``CROSSOVER`` shapes)."""
    from concurrent.futures import ThreadPoolExecutor

    from cardiac_ablation_ecm2_tpu_torch.benchmarks import gather_micro
    from cardiac_ablation_ecm2_tpu_torch.ops import gather_probes as gp

    todo = [(kind, consts, *variant_source(consts)) for kind, consts in VARIANTS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        libs = list(pool.map(lambda t: variant_lib(t[3]), todo))
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    cases, extra = probe_cases(dev), crossover_cases(dev)
    for (kind, consts, tag, _), lib in zip(todo, libs):
        report = [ln.split("ptxas info    : ", 1)[-1] for ln in
                  lib.build_log.splitlines() if "spill" in ln and "bytes" in ln]
        spills = sorted({r for r in report if not r.startswith("0 bytes stack")})
        print(f"{tag}: ptxas {'; '.join(spills) if spills else 'no spills'}")
        fv, fn = variant_call(lib, kind), getattr(gp, kind)
        for k, name, data, idx in cases + (extra if "kStripMinRatio" in consts else []):
            if k != kind:
                continue
            label = f"{tag} {name}"
            agree(label, fn(data, idx), fv(data, idx), True)
            in_turns(label, lambda: fn(data, idx), lambda: fv(data, idx), rounds,
                     results, timer=gather_micro.cuda_ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="root of the other checkout")
    ap.add_argument("--probes", action="store_true",
                    help="the probe gathers instead of the restriction and SpMV")
    ap.add_argument("--variants", action="store_true",
                    help="variants of this checkout's probe gathers ('other' "
                         "is then the source as it stands)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", help="file to write the readings to")
    a = ap.parse_args()
    if a.other is None and not a.variants:
        ap.error("OTHER_DIR is needed unless --variants")
    dev = cs.phase_device()
    from cardiac_ablation_ecm2_tpu_torch.utils.config import configure

    configure(quad_extra=0)
    results = {"device": torch.cuda.get_device_name(0)}
    cs.phase_build()
    if a.variants:
        variants(dev, a.rounds, results)
    else:
        mod = load_other(a.other)
        mod("utils.config").configure(quad_extra=0)
        if a.probes:
            mod("ops.gather_probes").build()
            probes_against(mod, dev, a.rounds, results)
        else:
            for name in ("ops.block_gather", "ops.ell"):
                mod(name).build()
            hex_restriction(mod, dev, a.rounds, results)
            torch.cuda.empty_cache()
            tet_spmv(mod, dev, a.rounds, results)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
