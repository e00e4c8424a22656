"""The PyTorch port never imports JAX: importing every one of its modules
(the example programs of ``cardiac_ablation_ecm2_tpu_torch/examples``
included) in a fresh interpreter leaves ``jax`` out of ``sys.modules``.
Each check is one such interpreter; the module starts them all together,
and each test reads its own."""

import os
import subprocess
import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PROBE = """
import importlib, pkgutil, sys
import cardiac_ablation_ecm2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
assert "cardiac_ablation_ecm2_tpu_torch.examples.ex1_poisson" in names, names
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m.startswith("cardiac_ablation_ecm2_tpu."))
print("LEAKED", bad)
"""


def _module_probe(modules):
    """A probe importing the port's ``modules`` alone: each is among those
    the package walk reaches."""
    return ("import importlib, pkgutil, sys\n"
            "import cardiac_ablation_ecm2_tpu_torch as pkg\n"
            "names = {m.name for m in pkgutil.walk_packages(pkg.__path__, "
            "pkg.__name__ + '.')}\n"
            f"mods = ['cardiac_ablation_ecm2_tpu_torch.' + m for m in {modules!r}]\n"
            "assert set(mods) <= names, set(mods) - names\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "print('LEAKED', sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'cardiac_ablation_ecm2_tpu.'))))\n")


_RUNS = {}


@pytest.fixture(autouse=True, scope="module")
def _probes():
    """Every probe's interpreter, started together with the module."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    for name, code in (("all", _PROBE), ("vector_fe", _module_probe(VECTOR_FE)),
                       ("slice_16", _module_probe(SLICE_16))):
        _RUNS[name] = subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    yield
    for proc in _RUNS.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _result(name):
    out, err = _RUNS[name].communicate(timeout=120)
    return _RUNS[name].returncode, out, err


def test_port_imports_no_jax():
    rc, out, err = _result("all")
    assert rc == 0, err
    assert "LEAKED []" in out, out


VECTOR_FE = ("fem.fe_vector", "fem.fe_vector_ho", "fem.fe_vector_simplex", "ops.vecfe",
             "ops.mixed_vecfe", "ops.block", "linalg.ams", "examples.ex3_maxwell",
             "models.magnetic_diffusion", "models.darcy", "linalg.maxwell_eigen",
             "ops.hybridization", "ops.complex_fem", "ops.vecfe_r", "parallel.pvecfe")


def test_vector_fe_modules_import_no_jax():
    """The vector-FE slice's modules are among those the walk reaches, and
    importing them alone leaves JAX out too."""
    rc, out, err = _result("vector_fe")
    assert rc == 0, err
    assert "LEAKED []" in out, out


SLICE_16 = ("mesh.submesh", "mesh.trim", "mesh.particles", "ops.linearform",
            "parallel.psubmesh", "parallel.pointeval", "examples.multidomain_heat",
            "fem.geometry", "fem.basis", "fem.fespace", "fem.pyramid2", "fem.pyramid3",
            "fem.pyramid_p", "fem.mixed", "mesh.mesh")


def test_multidomain_and_prism_pyramid_modules_import_no_jax():
    """The multi-domain and prism/pyramid modules are among those the walk
    reaches, and importing them alone leaves JAX out too."""
    rc, out, err = _result("slice_16")
    assert rc == 0, err
    assert "LEAKED []" in out, out
