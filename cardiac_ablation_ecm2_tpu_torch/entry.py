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
"""

from __future__ import annotations

import torch

from .fem.fespace import FESpace
from .linalg import ode
from .mesh.mesh import make_cartesian_3d
from .models import bioheat
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
