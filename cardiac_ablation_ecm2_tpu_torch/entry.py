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

``dryrun_multichip(n, device=None)`` runs, over n ranks (``parallel/``),
one sharded SDIRK33 step of the 4×4×2 hex mesh of a 2 cm box, order 2,
and the JAX package's three wider parts: (a) a sharded nonconforming
Poisson solve with its ghost-master layer (``parallel/pnc``) on the 4×4
quad mesh with one corner refined, order 2; (b) one sharded DG advection
apply with its ghost-face exchange (``parallel/dg``) on the 4×4 quad mesh,
order 1; (c) a sharded ND solve with the in-shard AMS.  It runs on n cards
over NCCL (``device=None``; fewer cards raise) or in n gloo processes on
the CPU (``device="cpu"``), and checks that every gathered result is
finite.
"""

from __future__ import annotations

import numpy as np
import torch

from .fem.fespace import FESpace, L2FESpace
from .linalg import ode
from .mesh.mesh import make_cartesian_2d, make_cartesian_3d
from .models import bioheat
from .ops.dg_advection import project_l2
from .parallel import bioheat as par_bio
from .parallel import dg as par_dg
from .parallel import launch
from .parallel import pvecfe
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
    return (sim.gather(T), _dryrun_nc(device), _dryrun_dg(device),
            _dryrun_vecfe(device))


def _dryrun_nc(device):
    """The JAX dryrun's part (a): a sharded NC Poisson solve with a
    ghost-master layer on make_cartesian_2d(4, 4), one corner refined."""
    from .fem.ncfespace import NCFESpace
    from .mesh.ncmesh import make_nc, refine_quads
    from .parallel import pnc

    nc = make_nc(make_cartesian_2d(4, 4))
    cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
    nc, _ = refine_quads(nc, (cent[:, 0] < 0.5) & (cent[:, 1] < 0.5))
    u, _, _ = pnc.setup(NCFESpace(nc, 2, device=device), rel_tol=1e-8,
                        device=device).solve()
    return u


def _dryrun_dg(device):
    """The JAX dryrun's part (b): one sharded DG advection apply."""
    dfes = L2FESpace(make_cartesian_2d(4, 4), 1)

    def vel(x):
        v = torch.zeros_like(x)
        v[..., 0], v[..., 1] = 0.6, 0.4
        return v

    par = par_dg.setup(dfes, vel, inflow=lambda x: torch.zeros(x.shape[:-1],
                                                               dtype=x.dtype),
                       device=device)
    u0 = par.scatter(project_l2(dfes, lambda X: torch.exp(
        -40 * ((X[..., 0] - 0.4) ** 2 + (X[..., 1] - 0.5) ** 2)), device="cpu"))
    return par.gather(par.mult(0.0, u0))


def _dryrun_vecfe(device):
    """The JAX dryrun's part (c): a sharded ND curl-curl + mass solve with
    the in-shard AMS on make_cartesian_3d(4, 4, 4)."""
    from .fem.fe_vector import NDSpace

    vmesh = make_cartesian_3d(4, 4, 4)
    pv = pvecfe.setup(
        NDSpace(vmesh), mass_coeff=1.0, curlcurl_coeff=1.0,
        rhs_fn=lambda x: np.stack([np.ones_like(x[..., 0]), x[..., 1], x[..., 0]],
                                  axis=-1),
        ess_bdr=sorted(set(vmesh.bdr_attributes.tolist())), rel_tol=1e-8,
        precond="ams", device=device)
    return pv.solve()[0]


def dryrun_multichip(n_devices: int, device=None) -> np.ndarray:
    """One full sharded bioheat step, one sharded NC Poisson solve, one
    sharded DG advection apply and one sharded ND solve with the in-shard
    AMS over ``n_devices`` ranks (the JAX package's ``dryrun_multichip``
    and its parts (a)–(c)).  Returns the gathered global temperature."""
    if device is None and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                           f"cards; {torch.cuda.device_count()} are visible")
    out, u_nc, du, u_nd = launch.spawn(_dryrun_rank, n_devices, device)[0]
    if not np.isfinite(out).all():
        raise RuntimeError("sharded step produced non-finite values")
    if not np.isfinite(u_nc).all():
        raise RuntimeError("sharded NC Poisson solve produced non-finite values")
    if not np.isfinite(du).all():
        raise RuntimeError("sharded DG apply produced non-finite values")
    if not np.isfinite(u_nd).all():
        raise RuntimeError("sharded ND solve produced non-finite values")
    return out
