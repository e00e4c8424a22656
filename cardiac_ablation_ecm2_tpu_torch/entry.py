"""Entry point (counterpart of ``entry`` in the JAX package's
``__graft_entry__.py``).

``entry(device=None)`` returns ``(fn, example_args)``: ``fn(T, t, dt)`` is
one implicit SDIRK33 Pennes-bioheat step (three Jacobi-PCG stage solves,
rel_tol 1e-8, max_iter 200) on the 4³ hex mesh of a 2 cm cube, order 2,
with a Gaussian volumetric source and every face at 37 °C.  The example
arguments are a float32 T₀ = 37 °C and float32 0-d tensors t = 0 and
dt = 0.5, as the JAX entry's ``jnp.float32`` scalars; ``fn`` takes T₀ to
the operator's dtype (the configured one) as JAX's type promotion does.
``device=None`` is the card.

``dryrun_multichip(n, device=None)`` runs one sharded SDIRK33 step of the
4×4×2 hex mesh of a 2 cm box, order 2, over n ranks (``parallel/``): n
cards over NCCL (``device=None``; fewer cards raise) or n gloo processes on
the CPU (``device="cpu"``), and checks that the gathered result is finite.
"""

from __future__ import annotations

import numpy as np
import torch

from .fem.fespace import FESpace
from .linalg import ode
from .mesh.mesh import make_cartesian_3d
from .models import bioheat
from .parallel import bioheat as par_bio
from .parallel import launch
from .utils.config import resolve_device


def _small_problem(order=2, n=4, L=0.02, device=None):
    mesh = make_cartesian_3d(n, n, n, L, L, L)
    fes = FESpace(mesh, order)

    def src(x):
        r2 = sum((x[..., i] - L / 2) ** 2 for i in range(3))
        return 5e5 * torch.exp(-r2 / (L / 4) ** 2)

    op = bioheat.BioheatOperator(
        fes, rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0, q_met=src,
        ess_bdr=[1, 2, 3, 4, 5, 6], rel_tol=1e-8, max_iter=200, device=device)
    solver = ode.select("sdirk33")

    def step(T, t, dt):
        return solver.step(op, T.to(op.dtype), t, dt)

    return fes, step


def entry(device=None):
    """(fn, example_args): one bioheat step on ``device`` and its inputs."""
    device = resolve_device(device)
    fes, step = _small_problem(device=device)
    f32 = dict(dtype=torch.float32, device=device)
    T0 = torch.full((fes.ndof,), 37.0, **f32)
    return step, (T0, torch.tensor(0.0, **f32), torch.tensor(0.5, **f32))


def _dryrun_rank(rank, world, device):
    L = 0.02
    mesh = make_cartesian_3d(4, 4, 2, L, L, L)

    def src(x):
        r2 = sum((x[..., i] - L / 2) ** 2 for i in range(3))
        return 5e5 * torch.exp(-r2 / (L / 4) ** 2)

    sim = par_bio.setup(mesh, order=2, q_src=src, ess_bdr=[1, 2, 3, 4, 5, 6],
                        solver="sdirk33", rel_tol=1e-8, max_iter=100,
                        device=device)
    T, _ = sim.step(sim.T0, 0.0, 0.5)
    return sim.gather(T)


def dryrun_multichip(n_devices: int, device=None) -> np.ndarray:
    """One full sharded bioheat step over ``n_devices`` ranks (the bioheat
    part of the JAX package's ``dryrun_multichip``; its NC, DG and vector-FE
    sharded parts wait for ``parallel/pnc``, ``dg`` and ``pvecfe``).
    Returns the gathered global temperature."""
    if device is None and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                           f"cards; {torch.cuda.device_count()} are visible")
    out = launch.spawn(_dryrun_rank, n_devices, device)[0]
    if not np.isfinite(out).all():
        raise RuntimeError("sharded step produced non-finite values")
    return out
