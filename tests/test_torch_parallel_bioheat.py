"""The port's sharded bioheat steppers (``parallel/bioheat``,
``parallel/cartesian_bioheat``) against the JAX package's, float64 on the
CPU: the port's ranks are gloo processes (one spawn per world size,
started in a background thread when the first test asks), JAX runs on the
conftest's virtual devices in this process.  This module imports JAX only
inside the tests, so that no rank loads it.

Cases: Jacobi over 2 and 4 ranks, three SDIRK33 steps on the cardiac hex
mesh n=4; Chebyshev and p-multigrid over 2 ranks, three backward-Euler
steps (one stage solve a step: JAX compiles its sharded V-cycle once per
stage, and three stages take it past half a minute); the cardiac tet mesh
n=8 over 4 ranks, two SDIRK33 steps; the structured z-slab lattice over 2
ranks, three SDIRK33 steps.  T is held to JAX's sharded result to 1e-10
(T ≈ 37; the two sum in other orders), and with Jacobi the CG count of
every stage solve to the port's serial ``BioheatOperator`` in T form (JAX's
sharded step reports none).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import ode
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import (
    make_cardiac_hex_mesh,
    make_cardiac_tet_mesh,
)
from cardiac_ablation_ecm2_tpu_torch.models import bioheat as tbio
from cardiac_ablation_ecm2_tpu_torch.parallel import bioheat as pbio
from cardiac_ablation_ecm2_tpu_torch.parallel import cartesian_bioheat as pcb
from cardiac_ablation_ecm2_tpu_torch.parallel import launch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L = 0.04
MESH_KW = dict(lengths=(L, L, L / 2), electrode_radius=0.004)
PHYS = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0)
ESS = [1, 2, 3, 4, 5, 6]
DT = 0.5
# (name, mesh kind, precond, solver, steps, world sizes)
CASES = (("jacobi", "hex", "jacobi", "sdirk33", 3, (2, 4)),
         ("chebyshev", "hex", "chebyshev", "backward_euler", 3, (2,)),
         ("pmg", "hex", "pmg", "backward_euler", 3, (2,)),
         ("tet", "tet", "jacobi", "sdirk33", 2, (4,)))
LATTICE = (3, 3, 4)


def source(exp):
    """The electrode-tip source of the JAX package's tests, for jnp or
    torch."""
    ctr = (L / 2, L / 2, L / 4)

    def src(x):
        r2 = sum((x[..., i] - ctr[i]) ** 2 for i in range(3))
        return 2e7 * exp(-r2 / (2 * 0.003 ** 2))

    return src


def lattice_source(exp):
    def src(x):
        r2 = sum((x[..., i] - L / 2) ** 2 for i in range(3))
        return 1e6 * exp(-r2 / (L / 8) ** 2)

    return src


def _mesh(pkg, kind):
    if pkg == "jax":
        from cardiac_ablation_ecm2_tpu.mesh import cardiac as jcardiac

        make = dict(hex=jcardiac.make_cardiac_hex_mesh,
                    tet=jcardiac.make_cardiac_tet_mesh)[kind]
    else:
        make = dict(hex=make_cardiac_hex_mesh, tet=make_cardiac_tet_mesh)[kind]
    return make(4 if kind == "hex" else 8, **MESH_KW)


# ----------------------------------------------------------------------------
# rank bodies (run in the spawned gloo ranks)
# ----------------------------------------------------------------------------


def _run(sim, steps):
    T, t = sim.T0, 0.0
    for _ in range(steps):
        T, t = sim.step(T, t, DT)
    return sim.gather(T), list(sim.cg_iterations)


def _rank_cases(rank, world, dev):
    out = {}
    meshes = {}
    for name, kind, precond, solver, steps, worlds in CASES:
        if world not in worlds:
            continue
        mesh = meshes.setdefault(kind, _mesh("torch", kind))
        sim = pbio.setup(mesh, order=2, q_src=source(torch.exp), ess_bdr=ESS,
                         solver=solver, rel_tol=1e-10, max_iter=300,
                         precond=precond, dtype="float64", device=dev, **PHYS)
        out[name] = _run(sim, steps)
    if world == 2:
        sim = pcb.setup(*LATTICE, order=2, lengths=(L, L, L),
                        q_src=lattice_source(torch.exp), rel_tol=1e-10,
                        dtype="float64", device=dev, **PHYS)
        out["lattice"] = _run(sim, 3)
    return out


@pytest.fixture(scope="module")
def ranks():
    """The spawned runs' futures by world size, started together."""
    with ThreadPoolExecutor(2) as pool:
        yield {w: pool.submit(launch.spawn, _rank_cases, w, "cpu")
               for w in (2, 4)}


def _jax_run(name, kind, precond, solver, steps, ndev):
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.parallel import bioheat as jpbio

    sim = jpbio.setup(_mesh("jax", kind), order=2, ndev=ndev,
                      q_src=source(jnp.exp), ess_bdr=ESS, solver=solver,
                      rel_tol=1e-10, max_iter=300, precond=precond, **PHYS)
    T, t = sim.T0, 0.0
    for _ in range(steps):
        T, t = sim.step(T, t, DT)
    return sim.gather(T)


@functools.lru_cache(maxsize=None)
def _serial_counts(kind, solver, steps):
    """The port's serial T-form operator's CG count of every stage solve."""
    fes = FESpace(_mesh("torch", kind), 2)
    op = tbio.BioheatOperator(fes, q_met=source(torch.exp), ess_bdr=ESS,
                              rel_tol=1e-10, max_iter=300, dtype="float64",
                              device="cpu", **PHYS)
    step = tbio.make_stepper(op, ode.select(solver))
    T, t = torch.full((fes.ndof,), 37.0, dtype=torch.float64), 0.0
    for _ in range(steps):
        T, t = step(T, t, DT)
    return op.cg_iterations


def _jax_lattice():
    """JAX's z-slab lattice run at ndev 2."""
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.parallel import cartesian_bioheat as jcb

    sim = jcb.setup(*LATTICE, order=2, ndev=2, lengths=(L, L, L),
                    q_src=lattice_source(jnp.exp), rel_tol=1e-10, **PHYS)
    T, t = sim.T0, 0.0
    for _ in range(3):
        T, t = sim.step(T, t, DT)
    return sim.gather(T)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's sharded runs of every case and of the lattice, two at a time in
    background threads from the first case on (JAX compiles outside the
    GIL, so the cases' compiles overlap each other and the port's serial
    counts)."""
    with ThreadPoolExecutor(2) as pool:
        runs = {(c[0], w): pool.submit(_jax_run, *c[:5], w) for c in CASES for w in c[5]}
        runs["lattice"] = pool.submit(_jax_lattice)
        yield runs


@pytest.mark.parametrize("name,kind,precond,solver,steps,ndev", [
    (c[0], c[1], c[2], c[3], c[4], w) for c in CASES for w in c[5]])
def test_sharded_step_matches_jax(ranks, jax_runs, name, kind, precond, solver,
                                  steps, ndev):
    serial = _serial_counts(kind, solver, steps) if precond == "jacobi" else None
    Tj = jax_runs[(name, ndev)].result()
    T, its = ranks[ndev].result()[0][name]
    assert np.abs(T - Tj).max() <= 1e-10
    assert T.max() > 37.5                        # the source heats
    if precond == "jacobi":
        assert its == serial
    else:
        assert len(its) == steps and min(its) > 0


def test_lattice_matches_jax(ranks, jax_runs):
    """The z-slab lattice over 2 ranks against JAX's at ndev 2."""
    Tj = jax_runs["lattice"].result()
    Tt, its = ranks[2].result()[0]["lattice"]
    assert Tt.shape == Tj.shape and np.abs(Tt - Tj).max() <= 1e-10
    assert Tt.max() > 37.05 and len(its) == 9


def _short_bound_witness(n, preconds, power, steps, dtype):
    """Both packages' sharded step at world size 1 on the cardiac hex mesh
    n (order 2, T form, the dress rehearsal's source, SDIRK33 steps of
    0.25 s at rel_tol 1e-5): each preconditioner's CG count of every stage
    solve and its T against its own package's Jacobi T.  JAX's step reports
    no CG counts, so its ``cg`` is wrapped here with a host callback that
    records them."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.parallel import bioheat as jpbio

    kw = dict(order=2, ess_bdr=ESS, solver="sdirk33", rel_tol=1e-5,
              max_iter=300, dtype=dtype, cheb_power_iters=power, **PHYS)
    ctr = (L / 2, L / 2, L / 4)

    def dress(exp):
        return lambda x: 1e6 * exp(-sum((x[..., i] - ctr[i]) ** 2
                                        for i in range(3)) / (L / 8) ** 2)

    jax_cg, traced, jax_its = jpbio.cg, [], {}

    def recorded_cg(*a, **k):
        """JAX's cg, and its iteration count into ``jax_its`` by the stage
        solve's place in the traced step."""
        x, info = jax_cg(*a, **k)
        index = len(traced)
        traced.append(index)
        jax.debug.callback(lambda i: jax_its.__setitem__(index, int(i)),
                           info.iterations)
        return x, info

    def run_jax(precond):
        jpbio.cg = recorded_cg
        try:
            sim = jpbio.setup(jcardiac.make_cardiac_hex_mesh(n, **MESH_KW),
                              ndev=1, q_src=dress(jnp.exp), precond=precond,
                              **kw)
            T, t, its = sim.T0, 0.0, []
            for _ in range(steps):
                jax_its.clear()
                T, t = sim.step(T, t, 0.25)
                jax.block_until_ready(T)
                jax.effects_barrier()
                its += [jax_its[i] for i in sorted(jax_its)]
            return sim.gather(T), its
        finally:
            jpbio.cg = jax_cg
            del traced[:]

    def run_port(precond):
        def body(rank, world, dev):
            sim = pbio.setup(make_cardiac_hex_mesh(n, **MESH_KW), device=dev,
                             q_src=dress(torch.exp), precond=precond, **kw)
            T, t = sim.T0, 0.0
            for _ in range(steps):
                T, t = sim.step(T, t, 0.25)
            return sim.gather(T), list(sim.cg_iterations)

        return launch.run_single(body, "cpu")

    from cardiac_ablation_ecm2_tpu.mesh import cardiac as jcardiac

    print(f"cardiac hex n={n}, order 2, {dtype}, world 1, {steps} SDIRK33 "
          f"steps, {power} power steps")
    ref = {}
    for precond in ("jacobi",) + tuple(preconds):
        for pkg, run in (("JAX", run_jax), ("port", run_port)):
            T, its = run(precond)
            if precond == "jacobi":
                ref[pkg] = T
            rise = float(ref[pkg].max()) - 37.0
            off = float(np.abs(T - ref[pkg]).max()) / rise
            print(f"{pkg:4s} {precond:9s} CG per stage {its}; T_max "
                  f"{float(T.max()):.10f}; max|T - T_jacobi| {off:.3e} of "
                  f"the rise {rise:.6f}", flush=True)
            if pkg == "JAX":
                Tj = T
        print(f"     {precond:9s} max|T_port - T_JAX| "
              f"{float(np.abs(T - Tj).max()):.3e}", flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=_short_bound_witness.__doc__)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--precond", nargs="+", default=["chebyshev"])
    ap.add_argument("--power", type=int, default=12)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtype", default="float64")
    a = ap.parse_args()
    _short_bound_witness(a.n, a.precond, a.power, a.steps, a.dtype)
