"""The PyTorch port never imports JAX: importing every one of its modules
(the example programs of ``cardiac_ablation_ecm2_tpu_torch/examples``
included) in a fresh interpreter leaves ``jax`` out of ``sys.modules``."""

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


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


VECTOR_FE = ("fem.fe_vector", "fem.fe_vector_ho", "fem.fe_vector_simplex", "ops.vecfe",
             "ops.mixed_vecfe", "ops.block", "linalg.ams", "examples.ex3_maxwell",
             "models.magnetic_diffusion", "models.darcy", "linalg.maxwell_eigen",
             "ops.hybridization", "ops.complex_fem", "ops.vecfe_r", "parallel.pvecfe")


def test_vector_fe_modules_import_no_jax():
    """The vector-FE slice's modules are among those the walk reaches, and
    importing them alone leaves JAX out too."""
    probe = ("import importlib, pkgutil, sys\n"
             "import cardiac_ablation_ecm2_tpu_torch as pkg\n"
             "names = {m.name for m in pkgutil.walk_packages(pkg.__path__, "
             "pkg.__name__ + '.')}\n"
             f"mods = ['cardiac_ablation_ecm2_tpu_torch.' + m for m in {VECTOR_FE!r}]\n"
             "assert set(mods) <= names, set(mods) - names\n"
             "for m in mods:\n"
             "    importlib.import_module(m)\n"
             "print('LEAKED', sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib', 'cardiac_ablation_ecm2_tpu.'))))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
