"""The port's example programs (``cardiac_ablation_ecm2_tpu_torch/examples``)
run through ``main`` with ``--cpu --x64`` on tiny meshes, their printed
lines held to the JAX package's numbers for the same runs: ex1's CG
count, converged flag and ‖r‖; ex16's ‖u‖_L2 after each step; ex2's CG
count and tip deflection (JAX's ``models/elasticity.solve`` on the same
beam); ex26's and the ablation demo's lines equal to those of the root
``examples/`` programs run with the same arguments.  The JAX runs of ex1
and ex16 are ``test_torch_forms2d``'s, shared through its caches.  Mesh
files and ``--vtu`` raise ``NotImplementedError``."""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.examples import (
    ablation_demo,
    common,
    ex1_poisson,
    ex2_elasticity,
    ex16_heat,
    ex26_multigrid,
)
from test_torch_forms2d import _config, jax_heat, jax_poisson  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = ["--cpu", "--x64"]
JAX_EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", JAX_EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_lines(name, argv, capsys, monkeypatch):
    """The printed lines of the root ``examples/<name>.py`` run with
    ``argv`` (its ``from common import ...`` resolved to the root
    ``examples/common.py``; no persistent compilation cache)."""
    monkeypatch.setenv("CAX_COMPILE_CACHE", "0")
    monkeypatch.setitem(sys.modules, "common", _load("common"))
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    _load(name).main()
    return capsys.readouterr().out.strip().splitlines()


def test_ex1_prints_jax_counts(capsys):
    _, its, norm = jax_poisson("quad")
    ex1_poisson.main(["-m", "inline-quad-8"] + CPU)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == (f"ndof=289  CG iters={its}  converged=True  "
                    f"|r|={norm:.3e}"), line


def test_ex16_prints_jax_norms(capsys):
    _, states, _ = jax_heat("quad")
    ex16_heat.main(["-m", "inline-quad-4", "--t-final", "0.03"] + CPU)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"t={0.01 * (k + 1):.4f}  |u|_L2={n:.6f}"
                     for k, (_, n) in enumerate(states)], lines


def test_ex2_prints_jax_counts(capsys):
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.models import elasticity as jelasticity

    m = jmesh.make_cartesian_2d(8, 1, 8.0, 1.0)
    m.bdr_attributes = np.array([0, 3, 2, 3, 1])[m.bdr_attributes]
    ref = jelasticity.solve(m, order=2)
    tip = abs(ref.displacement()[:, 1]).max()
    beam = ex2_elasticity.beam_quad()
    assert np.array_equal(beam.bdr_attributes, m.bdr_attributes)
    res = ex2_elasticity.main(CPU)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == (f"ndof={ref.fes.ndof}  CG iters={int(ref.iterations)}  "
                    f"max |u_y| = {tip:.4e}"), line
    assert np.abs(res.u.numpy() - np.asarray(ref.u)).max() <= 1e-10 * np.abs(
        np.asarray(ref.u)).max()


def test_ex26_prints_jacobi_count(capsys, monkeypatch):
    """Both counts (Jacobi- and multigrid-PCG) and the agreement line are
    the root ex26's."""
    argv = ["-m", "inline-quad-8", "-o", "2"] + CPU
    ref = _jax_lines("ex26_multigrid", argv, capsys, monkeypatch)
    ex26_multigrid.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ref and lines[0] == "ndof=289  order=2  levels=[1, 2]", (
        lines, ref)
    assert lines[2] == "solutions agree: True"


def test_ablation_demo_prints_the_library_run(capsys, monkeypatch):
    """Every line is the JAX package's run of the same demo."""
    argv = ["--n", "2", "--t-final", "1.0", "--dt", "0.5"] + CPU
    ref = _jax_lines("ablation_demo", argv, capsys, monkeypatch)
    ablation_demo.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ref and len(lines) == 3, (lines, ref)
    assert lines[0].startswith("RF solve: ") and "Tmax=37.93C" in lines[-1]


def test_unported_inputs_raise():
    with pytest.raises(NotImplementedError, match="item 7"):
        ex1_poisson.main(["-m", "star.mesh"] + CPU)
    with pytest.raises(NotImplementedError, match="item 7"):
        ex1_poisson.main(["-m", "inline-quad-2", "--vtu", "u.vtu"] + CPU)
    with pytest.raises(NotImplementedError, match="item 6"):
        common.make_inline("inline-wedge-2")
    args = common.standard_parser("x").parse_args(["-m", "inline-tri-2", "-r", "1"])
    assert common.load_mesh(args).ne == 32
    assert common.setup(common.standard_parser("x").parse_args(["--cpu"])) == dict(
        device=torch.device("cpu"), dtype="float32")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            common.setup(args)


def test_ex3_prints_jax_lines(capsys, monkeypatch):
    """ex3 on ND₂ over 2³: the Jacobi-PCG count and the L2 error line equal
    the root driver's (the ``--ams`` path's counts are held to JAX's by
    ``test_torch_ams``; JAX's AMS driver run compiles for ~20 s)."""
    from cardiac_ablation_ecm2_tpu_torch.examples import ex3_maxwell

    argv = ["-n", "2", "-o", "2"] + CPU
    ex3_maxwell.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == _jax_lines("ex3_maxwell", argv, capsys, monkeypatch), lines
    assert lines[0] == "ND_2 on 8 hexes: 300 dofs"


def test_ex15_prints_jax_lines(capsys, monkeypatch):
    """ex15's dynamic refine/derefine loop: every line (elements, conforming
    dofs, hanging entities, max u) equals the root driver's."""
    from cardiac_ablation_ecm2_tpu_torch.examples import ex15_dynamic_amr

    argv = ["-s", "3"] + CPU
    lines = ex15_dynamic_amr.main(argv)
    assert capsys.readouterr().out.strip().splitlines() == lines
    assert lines == _jax_lines("ex15_dynamic_amr", argv, capsys, monkeypatch), lines
    assert len(lines) == 3 and all("hanging=" in ln for ln in lines)


def test_boundary_layer_amr_prints_jax_lines(capsys, monkeypatch):
    """The boundary-layer driver on 3³ with one Z-split round: its lines equal
    the root driver's but for the CG count, held within 2 (the solve stops
    at rel_tol 1e-10 with the sums in another order: at 4³ and two rounds
    the counts read 69 against JAX's 68)."""
    import re

    from cardiac_ablation_ecm2_tpu_torch.examples import boundary_layer_amr

    argv = ["-n", "3", "-s", "1"] + CPU
    lines = boundary_layer_amr.main(argv)
    capsys.readouterr()
    ref = _jax_lines("boundary_layer_amr", argv, capsys, monkeypatch)
    assert len(lines) == len(ref) == 2
    pat = re.compile(r"cg_iters=(\d+)")
    for got, want in zip(lines, ref):
        assert pat.sub("", got) == pat.sub("", want), (got, want)
        assert abs(int(pat.search(got)[1]) - int(pat.search(want)[1])) <= 2
