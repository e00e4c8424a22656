"""The port's AMS and ADS preconditioners (``linalg/ams``) against the JAX
package's, float64 on the CPU: PCG on the definite Maxwell (curl-curl +
mass, ND₁) and grad-div (div-div + mass, RT₁) problems over the
``make_cartesian_3d(2, 2, 2)`` hierarchy refined twice (8³ = 512 hexes),
essential BCs on every boundary attribute.

The two packages' h-multigrid smoothers share the port's Chebyshev bounds
(JAX's ``chebyshev`` is wrapped to receive them, as ``test_torch_refine``
does): their power methods draw different starts.  With shared bounds the
CG counts are equal and the iterates agree within 1e-10 of max|x|.  JAX's
PCG is its ``cg`` recurrence written out over its jitted operator and
preconditioner (``jax_pcg``).  The
transfers G, Π and C and their adjoints are checked against JAX's on
their own: forward bitwise, adjoints against ``jax.linear_transpose``
within 1e-13.
"""

import functools

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector as tv
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import ams as tams
from cardiac_ablation_ecm2_tpu_torch.linalg import smoothers
from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.ops import vecfe as to
from torch_threads import beside

F64 = dict(dtype="float64", device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def hierarchy(levels=3):
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh

    jm, tm = [jmesh.make_cartesian_3d(2, 2, 2)], [tmesh.make_cartesian_3d(2, 2, 2)]
    for _ in range(levels - 1):
        jm.append(jm[-1].uniform_refinement())
        tm.append(tm[-1].uniform_refinement())
    return jm, tm


def masked(op, ess, n, lib):
    m = np.ones(n)
    m[ess] = 0.0
    if lib == "jax":
        import jax.numpy as jnp

        m = jnp.asarray(m)
    else:
        m = torch.as_tensor(m)
    d = op.diagonal() * m + (1 - m)
    return (lambda v: op.mult(v * m) * m + v * (1 - m)), d, m


def shared_bounds(monkeypatch):
    """Record the port's power bounds; JAX's h-MG Chebyshev pops them."""
    from cardiac_ablation_ecm2_tpu.linalg import multigrid as jmg
    from cardiac_ablation_ecm2_tpu.linalg import smoothers as jsm

    bounds = []
    power = smoothers.power_method

    def recorded(*args, **kw):
        lam = power(*args, **kw)
        bounds.append(float(lam))
        return lam

    monkeypatch.setattr(smoothers, "power_method", recorded)

    def share():
        queue = list(bounds)
        monkeypatch.setattr(jmg, "chebyshev", lambda A, diag, order: (
            jsm.chebyshev(A, diag, order=order, eig_max=queue.pop(0))))
        return queue

    return bounds, share


def test_transfers_and_adjoints():
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.fem import fe_vector as jv
    from cardiac_ablation_ecm2_tpu.linalg import ams as jams

    jm, tm = hierarchy(2)
    jm, tm = jm[-1], tm[-1]
    jh1, th1 = JFESpace(jm, 1), FESpace(tm, 1)
    rng = np.random.default_rng(4)
    w = rng.standard_normal(th1.ndof_scalar)
    tr = tams.EdgeTransfer(tv.NDSpace(tm), th1, torch.float64, "cpu")
    ft = tams.FaceTransfer(tm, th1, torch.float64, "cpu")
    jpi = jams._nd_pi(jm, jh1, jnp.float64)
    jrpi = jams._rt_pi(jm, jv.RTSpace(jm), jh1, jnp.float64)
    for d in range(3):
        for t, jf in ((tr, jpi), (ft, jrpi)):
            f = functools.partial(jf, d=d)
            assert np.array_equal(np.asarray(f(jnp.asarray(w))), t.pi(torch.as_tensor(w), d).numpy())
            y = rng.standard_normal(t.restr.ne)
            (want,) = jax.linear_transpose(f, jnp.zeros(th1.ndof_scalar))(jnp.asarray(y))
            got = t.pi_t(torch.as_tensor(y), d).numpy()
            assert np.abs(np.asarray(want) - got).max() <= 1e-13 * np.abs(want).max()


def jax_pcg(A, b, M, rel_tol, max_iter):
    """JAX's ``cg`` recurrence written out over its jitted A and M (its own
    ``lax.while_loop`` compiles the preconditioner into the loop for ~7 s
    a solve; the two jitted calls compile for ~3 s): (x, count)."""
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.linalg.solvers import default_dot

    A, M = jax.jit(A), jax.jit(M)
    x = jnp.zeros_like(b)
    r = b - A(x)
    d = M(r)
    nom = default_dot(d, r)
    target = rel_tol * rel_tol * nom
    k, done = 0, bool(nom <= target)
    while k < max_iter and not done:
        Ad = A(d)
        alpha = nom / default_dot(d, Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        z = M(r)
        betanom = default_dot(r, z)
        done = bool(betanom <= target)
        d = z + (betanom / nom) * d
        nom = betanom
        k += 1
    return x, k


@pytest.mark.parametrize("kind", ["ams", "ads"])
def test_pcg_equals_jax(kind, monkeypatch):
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.fem import fe_vector as jv
    from cardiac_ablation_ecm2_tpu.linalg import ams as jams
    from cardiac_ablation_ecm2_tpu.ops import vecfe as jo

    jms, tms = hierarchy(3)
    jm, tm = jms[-1], tms[-1]
    jh1, th1 = JFESpace(jm, 1), FESpace(tm, 1)
    bdr = sorted(set(tm.bdr_attributes.tolist()))
    bounds, share = shared_bounds(monkeypatch)
    if kind == "ams":
        jsp, tsp = jv.NDSpace(jm), tv.NDSpace(tm)
        top = to.build_nd_operator(tsp, 1.0, 1.0, **F64)
    else:
        jsp, tsp = jv.RTSpace(jm), tv.RTSpace(tm)
        top = to.build_rt_operator(tsp, 1.0, 1.0, **F64)
    ess = tsp.essential_dofs(bdr)
    tA, td, tmask = masked(top, ess, tsp.ndof, "torch")
    b = np.random.default_rng(1).standard_normal(tsp.ndof)
    if kind == "ams":
        tM = tams.make_ams(tsp, th1, tA, td, ess_bdr=bdr, meshes=tms, **F64)
    else:
        tM = tams.make_ads(tsp, tv.NDSpace(tm), th1, tA, td, ess_bdr=bdr, meshes=tms, **F64)
    queue = share()

    def jax_side():
        if kind == "ams":
            jop = jo.build_nd_operator(jsp, 1.0, 1.0)
            jA, jd, jmask = masked(jop, ess, tsp.ndof, "jax")
            jM = jams.make_ams(jsp, jh1, jA, jd, ess_bdr=bdr, meshes=jms)
        else:
            jop = jo.build_rt_operator(jsp, 1.0, 1.0)
            jA, jd, jmask = masked(jop, ess, tsp.ndof, "jax")
            jM = jams.make_ads(jsp, jv.NDSpace(jm), jh1, jA, jd, ess_bdr=bdr, meshes=jms)
        return jax_pcg(jA, jnp.asarray(b) * jmask, jM, rel_tol=1e-10, max_iter=500)

    # JAX's set-up and PCG beside the port's solves
    jax_run = beside(jax_side)
    x, info = cg(tA, torch.as_tensor(b) * tmask, M=tM, rel_tol=1e-10, max_iter=500)
    # and the preconditioner earns its keep against Jacobi
    _, ij = cg(tA, torch.as_tensor(b) * tmask, M=lambda r: r / td, rel_tol=1e-10,
               max_iter=2000)
    jx, jits = jax_run.result()
    assert not queue and len(bounds) == (6 if kind == "ams" else 9)
    assert info.converged and info.iterations == jits
    assert np.abs(np.asarray(jx) - x.numpy()).max() <= 1e-10 * np.abs(np.asarray(jx)).max()
    assert info.iterations < ij.iterations
