"""The port's vector-FE models and solvers against the JAX package's,
float64 on the CPU: Darcy (``models/darcy``, its MINRES count), magnetic
diffusion (``models/magnetic_diffusion``, three SDIRK33 steps and each
stage's CG count), the Maxwell eigenvalues (``linalg/maxwell_eigen``,
JAX's start block passed as ``X0``), hybridization (``ops/hybridization``,
the interface CG count) and the complex ND cases (ex22 problem 1 with
JAX's GMRES count, the ex25 PML beam through the assembled matrices).

Solutions within 1e-10 of max|u| (eigenvalues within 1e-10 relative);
Krylov counts equal.  JAX's magnetic-diffusion stage solves run eagerly
with a wrapper around its ``cg`` that records the counts its operator
drops.
"""

import functools

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector_ho as tho
from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector_simplex as ts
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.linalg import ode
from cardiac_ablation_ecm2_tpu_torch.linalg.maxwell_eigen import maxwell_eigenvalues
from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import gmres
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.models import darcy
from cardiac_ablation_ecm2_tpu_torch.models.magnetic_diffusion import MagneticDiffusionOperator
from cardiac_ablation_ecm2_tpu_torch.ops import complex_fem as tcf
from cardiac_ablation_ecm2_tpu_torch.ops import vecfe as to
from cardiac_ablation_ecm2_tpu_torch.ops.hybridization import hybridize_hdiv
from cardiac_ablation_ecm2_tpu_torch.fem.geometry import Geometry

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


def close(a, b, tol=1e-10):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-300)


def port_mesh(jm):
    """The port's Mesh with the JAX mesh's arrays."""
    return tmesh.Mesh(geom=Geometry(int(jm.geom)), vertices=jm.vertices,
                      elements=jm.elements, attributes=jm.attributes,
                      boundary=jm.boundary, bdr_attributes=jm.bdr_attributes)


def sine_field(x):
    s = np.sin(np.pi * x)
    return np.stack([s[..., 1] * s[..., 2], s[..., 2] * s[..., 0],
                     s[..., 0] * s[..., 1]], axis=-1)


def test_darcy_minres():
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.models import darcy as jdarcy

    def g(x):
        return 2 * np.pi ** 2 * np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])

    def f(x):
        return np.stack([x[..., 1], 1 - x[..., 0]], -1)

    jr = jdarcy.solve(jmesh.make_cartesian_2d(6, 6), f_vec=f, g_fn=g, rel_tol=1e-11)
    tr = darcy.solve(tmesh.make_cartesian_2d(6, 6), f_vec=f, g_fn=g, rel_tol=1e-11, **F64)
    assert tr.converged and tr.iterations == jr.iterations
    close(jr.u, tr.u)
    close(jr.p, tr.p)


def test_magnetic_diffusion_steps(monkeypatch):
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem.fe_vector import NDSpace as JND
    from cardiac_ablation_ecm2_tpu.linalg import ode as jode
    from cardiac_ablation_ecm2_tpu.linalg import solvers as jsolvers
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.models import magnetic_diffusion as jmd
    from cardiac_ablation_ecm2_tpu_torch.fem.fe_vector import NDSpace

    counts = []

    def recorded(*args, **kw):
        x, info = jsolvers.cg(*args, **kw)
        counts.append(int(info.iterations))
        return x, info

    monkeypatch.setattr(jmd, "cg", recorded)

    def J(x):
        return np.stack([np.sin(np.pi * x[..., 1]), x[..., 2], 1 + 0 * x[..., 0]], -1)

    jm, tm = jmesh.make_cartesian_3d(3, 3, 2), tmesh.make_cartesian_3d(3, 3, 2)
    bdr = sorted(set(tm.bdr_attributes.tolist()))
    kw = dict(sigma=2.0, nu=0.7, source=J, ess_bdr=bdr, rel_tol=1e-12)
    jop = jmd.MagneticDiffusionOperator(JND(jm), **kw)
    top = MagneticDiffusionOperator(NDSpace(tm), **kw, **F64)
    A0 = np.random.default_rng(3).standard_normal(top.M.ndof) * top.mask.numpy()
    jA, tA, t = jnp.asarray(A0), torch.as_tensor(A0), 0.0
    js, tsol = jode.select("sdirk33"), ode.select("sdirk33")
    from torch_threads import beside

    def jax_side(jA, t):
        for _ in range(3):
            jA, _ = js.step(jop, jA, jnp.asarray(t), jnp.asarray(0.05))
            t += 0.05
        return jA

    jax_run = beside(lambda: jax_side(jA, t))
    for _ in range(3):
        tA, _ = tsol.step(top, tA, t, 0.05)
        t += 0.05
    jA = jax_run.result()
    assert top.cg_iterations == counts and len(counts) == 9
    close(jA, tA)


def test_maxwell_eigenvalues():
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.fem.fe_vector_ho import NDSpaceHO as JNDHO
    from cardiac_ablation_ecm2_tpu.linalg import maxwell_eigen as jme
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh

    jm, tm = jmesh.make_cartesian_2d(4, 4), tmesh.make_cartesian_2d(4, 4)
    from torch_threads import beside

    jnd, tnd = JNDHO(jm, 2), tho.NDSpaceHO(tm, 2)
    jax_run = beside(lambda: jme.maxwell_eigenvalues(jnd, JFESpace(jm, 2), k=3, iters=20))
    X0 = jax.random.normal(jax.random.PRNGKey(0), (tnd.ndof, 3), dtype=jnp.float64)
    tr = maxwell_eigenvalues(tnd, FESpace(tm, 2), k=3, iters=20,
                             X0=torch.as_tensor(np.asarray(X0)), **F64)
    close(jax_run.result().eigenvalues, tr.eigenvalues)
    # the lowest PEC modes of the unit square: π², π², 2π²
    assert np.allclose(tr.eigenvalues, np.pi ** 2 * np.array([1, 1, 2]), rtol=2e-2)


def _f(x):
    comps = [np.sin(x[..., 0]) + x[..., 1], np.cos(x[..., 1]) - 0.5 * x[..., 0]]
    if x.shape[-1] == 3:
        comps.append(x[..., 2] ** 2)
    return np.stack(comps, axis=-1)


@functools.lru_cache(maxsize=None)
def _hyb_spaces(case):
    from cardiac_ablation_ecm2_tpu.fem import fe_vector_ho as jho
    from cardiac_ablation_ecm2_tpu.fem import fe_vector_simplex as js
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh
    from test_fespace import permute_vertices

    if case == "tri-rt2":
        jm = permute_vertices(jmesh.make_cartesian_2d_tri(4, 4), 3)
        return js.RTSimplexSpace(jm, 2), ts.RTSimplexSpace(port_mesh(jm), 2), 4
    if case == "tet-rt1":
        jm = permute_vertices(jmesh.make_cartesian_3d_tet(2, 2, 2), 5)
        return js.RTSimplexSpace(jm, 1), ts.RTSimplexSpace(port_mesh(jm), 1), 3
    jm = jmesh.make_cartesian_2d(4, 4)
    return jho.RTSpaceHO(jm, 2), tho.RTSpaceHO(port_mesh(jm), 2), 4


@pytest.mark.parametrize("case", ["tri-rt2", "tet-rt1", "quad-rt2"])
def test_hybridization(case):
    from cardiac_ablation_ecm2_tpu.ops import hybridization as jh
    from cardiac_ablation_ecm2_tpu.ops import vecfe as jo

    from torch_threads import beside

    jsp, tsp, nq1d = _hyb_spaces(case)
    kw = {}
    if case == "tri-rt2":        # nonzero essential normal-trace values
        ess = tsp.essential_dofs(None)
        bc = np.random.default_rng(2).standard_normal(tsp.ndof)
        kw = dict(ess=ess, bc_vals=bc)

    def jax_side():
        jop = jo.build_rt_operator(jsp, mass_coeff=1.0, divdiv_coeff=0.8, nq1d=nq1d)
        jhy = jh.hybridize_hdiv(jsp, jop, **kw)
        return (jhy,) + tuple(jhy.solve(_f, rel_tol=1e-13))

    jax_run = beside(jax_side)
    top = to.build_rt_operator(tsp, mass_coeff=1.0, divdiv_coeff=0.8, nq1d=nq1d, **F64)
    thy = hybridize_hdiv(tsp, top, **kw)
    tu, tlam, tinfo = thy.solve(_f, rel_tol=1e-13)
    jhy, ju, jlam, jinfo = jax_run.result()
    assert thy.nlam == jhy.nlam
    assert np.array_equal(thy.lam.gm.numpy(), np.asarray(jhy.lam_elem))
    assert tinfo.converged and tinfo.iterations == int(jinfo.iterations)
    close(ju, tu)
    close(jlam, tlam)


def test_ex22_nd_damped():
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem.fe_vector_ho import NDSpaceHO as JNDHO
    from cardiac_ablation_ecm2_tpu.linalg.solvers import gmres as jgmres
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.ops import complex_fem as jcf
    from cardiac_ablation_ecm2_tpu.ops import vecfe as jo

    omega, sigma = 1.5, 0.8
    jsp = JNDHO(jmesh.make_cartesian_3d(2, 2, 2), 2)
    tsp = tho.NDSpaceHO(tmesh.make_cartesian_3d(2, 2, 2), 2)
    cr = 2 * np.pi ** 2 - omega ** 2
    ess = tsp.essential_dofs(None)
    mask = np.zeros(tsp.ndof)
    mask[ess] = 1.0
    out = {}
    for lib, o, cf, mk in (("jax", jo, jcf, jnp.asarray), ("torch", to, tcf, torch.as_tensor)):
        sp, kw = (jsp, {}) if lib == "jax" else (tsp, F64)
        op_r = o.build_nd_operator(sp, -omega ** 2, 1.0, nq1d=4, **kw)
        op_i = o.build_nd_operator(sp, omega * sigma, None, nq1d=4, **kw)
        A = cf.ComplexOperator(op_r, op_i, sp.ndof)
        b = cf.cstack(o.vecfe_linear_form(op_r, lambda x: cr * sine_field(x)),
                      o.vecfe_linear_form(op_r, lambda x: omega * sigma * sine_field(x)))
        Ac, B = cf.form_complex_linear_system(A, ess, mk(np.zeros(2 * sp.ndof)), b)
        M = cf.complex_jacobi(A, ess_mask=mk(mask))
        solve = jgmres if lib == "jax" else gmres
        out[lib] = solve(Ac.mult, B, M=M, rel_tol=1e-11, max_iter=4000, restart=250)
    (jz, ji), (tz, ti) = out["jax"], out["torch"]
    assert ti.converged and ti.iterations == int(ji.iterations)
    close(jz, tz)


def test_ex25_pml_beam():
    """The ex25 beam's PML operators (complex callable coefficients split
    into real and imaginary matrix callables) through the assembled
    complex system, as the JAX package's test solves it."""
    from cardiac_ablation_ecm2_tpu.fem.fe_vector_ho import NDSpaceHO as JNDHO
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh
    from cardiac_ablation_ecm2_tpu.ops import vecfe as jo

    k, Lx, pml_x = np.pi, 4.0, 3.0
    coeff = 2.0 * 5.0 / (k * (Lx - pml_x) ** 2)

    def d0(x):
        return 1.0 + 1j * coeff * np.maximum(np.asarray(x)[..., 0] - pml_x, 0.0)

    def mass_c(x):
        d = d0(x)
        z = np.zeros_like(d)
        return -k ** 2 * np.stack([np.stack([1.0 / d, z], -1), np.stack([z, d], -1)], -2)

    jsp = JNDHO(jmesh.make_cartesian_2d(8, 2, Lx, 1.0), 2)
    tsp = tho.NDSpaceHO(tmesh.make_cartesian_2d(8, 2, Lx, 1.0), 2)
    mats = {}
    for lib, o, sp, kw in (("jax", jo, jsp, {}), ("torch", to, tsp, F64)):
        parts = [o.build_nd_operator(sp, lambda x, f=f: f(mass_c(x)),
                                     lambda x, f=f: f(1.0 / d0(x)), nq1d=4, **kw)
                 for f in (np.real, np.imag)]
        mats[lib] = parts[0].assemble_matrix() + 1j * parts[1].assemble_matrix()
    A_j, A_t = mats["jax"].toarray(), mats["torch"].toarray()
    assert np.abs(A_j - A_t).max() <= 1e-12 * np.abs(A_j).max()
