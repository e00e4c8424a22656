#!/usr/bin/env python3
"""Time the restriction and SpMV kernels of this checkout against those of
another checkout of the port (a parent commit), in one process on one GPU,
at the main-path shapes, in turns (other, this, this, other per round).

    python3 compare_kernels.py OTHER_DIR [--rounds 3] [--json PATH]

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


def in_turns(label, other, this, rounds, results):
    """Readings of ``other`` and ``this`` in the order other, this, this,
    other per round, each reading the median of one ``cs.time_ms``; prints
    and records the median of each side's readings, with their least and
    greatest."""
    t = {"other": [], "this": []}
    for _ in range(rounds):
        for side in ("other", "this", "this", "other"):
            t[side].append(cs.time_ms(other if side == "other" else this))
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", help="file to write the readings to")
    a = ap.parse_args()
    dev = cs.phase_device()
    from cardiac_ablation_ecm2_tpu_torch.utils.config import configure

    configure(quad_extra=0)
    mod = load_other(a.other)
    mod("utils.config").configure(quad_extra=0)
    cs.phase_build()
    for name in ("ops.block_gather", "ops.ell"):
        mod(name).build()
    results = {"device": torch.cuda.get_device_name(0)}
    hex_restriction(mod, dev, a.rounds, results)
    torch.cuda.empty_cache()
    tet_spmv(mod, dev, a.rounds, results)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
