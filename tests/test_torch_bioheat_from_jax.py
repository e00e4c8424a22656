"""The port's bioheat operator built from a JAX operator's arrays
(``models/bioheat.from_jax_arrays``) against the JAX package, float64 on
the CPU, with ``test_torch_bioheat``'s settings and helpers: one SDIRK33
step from a random θ with equal CG counts and θ to 1e-10; a gather map in
another numbering raises."""

import numpy as np
import pytest

from cardiac_ablation_ecm2_tpu.models import bioheat as jbio
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
from cardiac_ablation_ecm2_tpu_torch.models import bioheat as tbio
from test_torch_bioheat import (  # noqa: F401 (_bench_config: an autouse fixture)
    PARAMS,
    _bench_config,
    _jax_op,
    _meshes,
    _run_jax,
    _run_port,
    close,
)


@pytest.mark.parametrize("kind", ["cardiac", "cartesian"])
def test_from_jax_arrays_step_matches_jax(kind):
    _, tm = _meshes(kind)
    jop = _jax_op(kind)
    jfes = jop.fes
    arrays = {k: np.asarray(v) for k, v in jbio.big_arrays(jop).items()
              if k != "restr"}
    arrays["gather_map"] = np.asarray(jfes.gather_map)
    params = {k: v for k, v in PARAMS.items()
              if k in ("rel_tol", "max_iter", "dtype", "theta_form")}
    top = tbio.from_jax_arrays(FESpace(tm, 2), arrays, device="cpu", **params)
    theta = np.random.default_rng(2).uniform(0.0, 0.5, jfes.ndof)
    theta *= np.asarray(jop.ess_mask)
    jT, jit = _run_jax(jop, theta, 1)
    tT, tit = _run_port(top, theta, 1)
    assert tit == jit
    close(tT, jT, 1e-10)


def test_from_jax_arrays_rejects_other_numbering():
    tm = make_cartesian_3d(2, 2, 2)
    fes = FESpace(tm, 2)
    arrays = {"gather_map": fes.gather_map[::-1].copy()}
    with pytest.raises(ValueError):
        tbio.from_jax_arrays(fes, arrays, device="cpu")
