"""The port's adaptive-refinement example programs (``ex15_dynamic_amr``,
``boundary_layer_amr``) run through ``main`` with ``--cpu --x64`` on tiny
meshes, their printed lines held to those of the root ``examples/``
programs run with the same arguments (``test_torch_examples``' helpers
and settings)."""

from test_torch_examples import CPU, _jax_lines
from test_torch_forms2d import _config  # noqa: F401 (an autouse fixture)


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
