"""Shared example-program utilities (counterpart of the root
``examples/common.py``; MFEM's ``OptionsParser`` and the ``-m/-o/-r`` flag
conventions): argparse with the same spellings, and the ``inline-*`` mesh
specs.

``--cpu`` runs on the CPU; without it the examples run on the card (and
raise where none is visible).  ``--x64`` selects float64, else float32, as
the JAX examples' ``jax_enable_x64``.  Reading ``.mesh`` files and
``--vtu`` output wait for the I/O item of the port (ROADMAP Queue 1 item
7) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os

#: what the examples do not have yet
NO_IO = ("reading mesh files and --vtu output wait for the port's I/O "
         "(ROADMAP Queue 1 item 7)")


def standard_parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("-m", "--mesh", default=None,
                    help="inline spec: inline-{quad,tri,hex,tet,pyramid,wedge}-N "
                         "(inline-wedge lists only the four quad side walls)")
    ap.add_argument("-o", "--order", type=int, default=2)
    ap.add_argument("-r", "--refine", type=int, default=0,
                    help="uniform refinement levels")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--x64", action="store_true", help="float64 (else float32)")
    ap.add_argument("--vtu", default=None, help="write VTU output file")
    return ap


def setup(args) -> dict:
    """The ``device`` and ``dtype`` keywords of the port's entry points."""
    from ..utils.config import resolve_device

    return dict(device=resolve_device("cpu" if args.cpu else None),
                dtype="float64" if args.x64 else "float32")


def make_inline(spec: str):
    """The mesh of an ``inline-{quad,tri,hex,tet,pyramid,wedge}[-N]`` spec
    (N = 8 when left out)."""
    from ..mesh.mesh import (
        make_cartesian_2d,
        make_cartesian_2d_tri,
        make_cartesian_3d,
        make_cartesian_3d_prism,
        make_cartesian_3d_pyramid,
        make_cartesian_3d_tet,
    )

    parts = spec.split("-")
    kind = parts[1]
    n = int(parts[2]) if len(parts) > 2 else 8
    makers = {
        "quad": lambda: make_cartesian_2d(n, n),
        "tri": lambda: make_cartesian_2d_tri(n, n),
        "hex": lambda: make_cartesian_3d(n, n, n),
        "tet": lambda: make_cartesian_3d_tet(n, n, n),
        "pyramid": lambda: make_cartesian_3d_pyramid(n, n, n),
        "wedge": lambda: make_cartesian_3d_prism(n, n, n),
    }
    if kind not in makers:
        raise SystemExit(f"unknown inline mesh kind {kind!r}: {sorted(makers)}")
    return makers[kind]()


def load_mesh(args, default="inline-quad-8"):
    spec = args.mesh or default
    if spec.startswith("inline-"):
        mesh = make_inline(spec)
    elif os.path.exists(spec) or spec.endswith(".mesh"):
        raise NotImplementedError(f"{spec}: {NO_IO}")
    else:
        raise SystemExit(f"mesh not found: {spec}")
    if args.refine:
        mesh = mesh.uniform_refinement(args.refine)
    return mesh


def maybe_vtu(args, mesh, fes, u, name="u"):
    if args.vtu:
        raise NotImplementedError(f"--vtu {args.vtu}: {NO_IO}")
