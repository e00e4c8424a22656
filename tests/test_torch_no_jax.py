"""The PyTorch port never imports JAX: importing every one of its modules
(the example programs of ``cardiac_ablation_ecm2_tpu_torch/examples``
included) in a fresh interpreter leaves ``jax`` out of ``sys.modules``."""

import os
import subprocess
import sys

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
