"""The port's conforming space on NC meshes (``fem/ncfespace``) against the
JAX package, float64 on the CPU: the prolongation tables (``slave_idx``,
``slave_masters``, ``slave_w``, ``L_of_conf``, ``conf_of_L``) bitwise; P
and Pᵀ within 1e-14·max|·| of JAX's (the weighted sums run in another
order: a sum over the row in the element layout and a sorted segment-sum
where JAX sums with XLA and scatter-adds); Pᵀ the exact adjoint of P; and
the constrained Poisson solves of the JAX tests' meshes (quads, hexes
and tets at p = 1–3, typed quads and hexes at p = 2) within 1e-10·max|u| of JAX's
with equal CG counts.

JAX's side of a solve is its own tables and its FULL assembly
(``assemble_matrix``: cheap where its eager PA set-up compiles for
seconds a space), PᵀAP formed in scipy, and its ``cg`` recurrence written
out in numpy."""

import functools

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem.ncfespace import NCFESpace
from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf
from test_torch_ncmesh import both, corner2d, corner3d, electrode

F64 = dict(dtype=torch.float64, device="cpu")


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
def nc_case(name):
    """(JAX NC mesh, port NC mesh) of the JAX tests' refinements, held
    bitwise by ``test_torch_ncmesh.both``."""
    from cardiac_ablation_ecm2_tpu.mesh import ncmesh as jnc
    from cardiac_ablation_ecm2_tpu.mesh import nctet as jnt
    from cardiac_ablation_ecm2_tpu_torch.mesh import ncmesh as tnc

    X, Y, ISO = tnc.X, tnc.Y, tnc.ISO

    def quad_types(nc, r):
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        if r == 0:
            t = np.where(cent[:, 0] < 1 / 3, X, 0)
            t = np.where(cent[:, 1] > 2 / 3, Y, t)
            t[0] = ISO
            return t
        return np.where((cent[:, 0] < 1 / 6) & (cent[:, 1] < 1 / 3), Y, 0)

    def hex_types(nc, r):
        t = np.zeros(nc.mesh.ne, dtype=np.int64)
        t[0], t[3] = tnc.Z3, tnc.X3 | tnc.Z3
        return t

    def tet_marks(nc, r):
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        return np.linalg.norm(cent, axis=1) < 0.6 / (r + 1)

    args = {
        "quad": (jnc, (4, 4), "refine_quads", corner2d, 2, ("mesh", "make_cartesian_2d")),
        "quad_aniso": (jnc, (3, 3), "refine_quads_aniso", quad_types, 2,
                       ("mesh", "make_cartesian_2d")),
        "hex": (jnc, (2, 2, 2), "refine_hexes", corner3d, 1, ("mesh", "make_cartesian_3d")),
        "hex2": (jnc, (2, 2, 2), "refine_hexes", corner3d, 2, ("mesh", "make_cartesian_3d")),
        "hex_aniso": (jnc, (2, 2, 2), "refine_hexes_aniso", hex_types, 1,
                      ("mesh", "make_cartesian_3d")),
        "cardiac": (jnc, (6,), "refine_hexes", electrode, 2,
                    ("cardiac", "make_cardiac_hex_mesh")),
    }
    if name == "tet":
        js, ts = both(jnt, (2, 2, 2), "refine_tets_nc", tet_marks, 1,
                      ("mesh", "make_cartesian_3d_tet"), make_nc="make_nc_tet")
    else:
        js, ts = both(*args[name])
    return js[-1][0], ts[-1][0]


@functools.lru_cache(maxsize=None)
def spaces(name, p):
    from cardiac_ablation_ecm2_tpu.fem.ncfespace import NCFESpace as JNCFESpace

    jnc, tnc = nc_case(name)
    return JNCFESpace(jnc, p), NCFESpace(tnc, p, device="cpu")


TABLE_CASES = ([(c, p) for c in ("quad", "quad_aniso", "hex", "hex2", "hex_aniso")
                for p in (1, 2, 3)]
               + [("cardiac", 2), ("tet", 1), ("tet", 2), ("tet", 3), ("tet", 4)])


@pytest.mark.parametrize("case,p", TABLE_CASES)
def test_tables_bitwise(case, p):
    js, ts = spaces(case, p)
    assert ts.n_slaves == js.n_slaves > 0 and ts.ndof_conf == js.ndof_conf
    assert np.array_equal(ts.slave_idx, np.asarray(js._slave_idx))
    assert np.array_equal(ts.slave_masters, np.asarray(js._slave_masters))
    sw = np.asarray(js._slave_w)
    assert sw.dtype == np.float64 and np.array_equal(ts.slave_w.view(np.int64),
                                                     sw.view(np.int64))
    assert np.array_equal(ts.L_of_conf, js.L_of_conf)
    assert np.array_equal(ts.conf_of_L, js._conf_of_L)
    assert np.array_equal(ts.essential_dofs(), js.essential_dofs())
    assert np.array_equal(ts.dof_coords.view(np.int64),
                          np.asarray(js.dof_coords).view(np.int64))


@pytest.mark.parametrize("case,p", [(c, 2) for c in ("quad", "quad_aniso", "hex2",
                                                    "hex_aniso", "cardiac", "tet")]
                         + [("tet", 3)])
def test_p_pt_within_jax(case, p):
    """JAX's eager P and Pᵀ compile for ~1.4 s a space, so they run at the
    orders where every constraint kind is present."""
    import jax.numpy as jnp

    js, ts = spaces(case, p)
    rng = np.random.default_rng(p)
    uc = rng.standard_normal(ts.ndof_conf)
    vL = rng.standard_normal(ts.fes.ndof_scalar)
    for got, ref in (
        (ts.prolongate(torch.as_tensor(uc)), js.prolongate(jnp.asarray(uc))),
        (ts.restrict_t(torch.as_tensor(vL)), js.restrict_t(jnp.asarray(vL))),
    ):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-14 * np.abs(ref).max()


@pytest.mark.parametrize("case", ["quad", "hex_aniso", "cardiac", "tet"])
def test_restrict_t_is_the_adjoint(case):
    """⟨Pᵀv, u⟩ = ⟨v, Pu⟩, and the autograd Functions give Pᵀ as P's
    vector-Jacobian product (and P as Pᵀ's)."""
    _, ts = spaces(case, 2)
    rng = np.random.default_rng(7)
    u = torch.as_tensor(rng.standard_normal(ts.ndof_conf))
    v = torch.as_tensor(rng.standard_normal(ts.fes.ndof_scalar))
    lhs = float(ts.restrict_t(v) @ u)
    rhs = float(v @ ts.prolongate(u))
    assert abs(lhs - rhs) <= 1e-13 * abs(rhs)
    u.requires_grad_(True)
    (g,) = torch.autograd.grad(ts.prolongate(u), u, v)
    assert torch.equal(g, ts.restrict_t(v))
    v.requires_grad_(True)
    (h,) = torch.autograd.grad(ts.restrict_t(v), v, u.detach())
    assert torch.allclose(h, ts.prolongate(u.detach()), rtol=0, atol=1e-15)


def np_cg(A, b, rel_tol, max_iter):
    """The JAX package's ``cg`` recurrence (M the identity) in numpy."""
    x = np.zeros_like(b)
    r = b - A(x)
    d = r.copy()
    nom = d @ r
    target = rel_tol * rel_tol * nom
    k, done = 0, nom <= target
    while k < max_iter and not done:
        Ad = A(d)
        alpha = nom / (d @ Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        betanom = r @ r
        done = betanom <= target
        d = r + (betanom / nom) * d
        nom = betanom
        k += 1
    return x, k


def rhs_np(x):
    x = np.asarray(x)
    return 1.0 + x[..., 0] * x[..., 1] - 0.5 * x[..., -1]


def jax_solve(js, rel_tol):
    """JAX's masked PᵀAP solve of −Δu = f, u = 0 on the boundary: its
    tables, FULL assembly and linear form, its cg recurrence."""
    import scipy.sparse as sps

    from cardiac_ablation_ecm2_tpu.ops import BilinearForm as JBilinearForm
    from cardiac_ablation_ecm2_tpu.ops.linearform import domain_lf as jdomain_lf

    fes = js.fes
    A = JBilinearForm(fes).add_domain_integrator("diffusion").assemble_matrix()
    nL, nC = fes.ndof_scalar, js.ndof_conf
    si = np.asarray(js._slave_idx)
    sm = np.asarray(js._slave_masters)
    sw = np.asarray(js._slave_w)
    rows = np.concatenate([js.L_of_conf, np.repeat(si, sm.shape[1])])
    cols = np.concatenate([np.arange(nC), sm.reshape(-1)])
    vals = np.concatenate([np.ones(nC), sw.reshape(-1)])
    P = sps.csr_matrix((vals, (rows, cols)), shape=(nL, nC))
    AC = (P.T @ A @ P).tocsr()
    m = np.ones(nC)
    m[js.essential_dofs()] = 0.0
    b = (P.T @ np.asarray(jdomain_lf(fes, rhs_np))) * m
    return np_cg(lambda x: AC @ (x * m) * m + x * (1 - m), b, rel_tol, 4000)


def port_solve(ts, rel_tol):
    A = BilinearForm(ts.fes, "cpu").add_domain_integrator("diffusion").assemble(
        dtype=torch.float64)
    AC = ts.constrained_operator(A.mult)
    m = torch.ones(ts.ndof_conf, **F64)
    m[torch.as_tensor(ts.essential_dofs(), dtype=torch.long)] = 0.0
    b = ts.restrict_t(domain_lf(ts.fes, lambda x: 1.0 + x[..., 0] * x[..., 1]
                                - 0.5 * x[..., -1], **F64)) * m
    x, info = cg(lambda v: AC(v * m) * m + v * (1 - m), b, rel_tol=rel_tol,
                 max_iter=4000)
    assert info.converged
    return x.numpy(), info.iterations


# p = 1–3 where the JAX tests solve or project at those orders; the typed
# meshes at p = 2 (test_nc_aniso's and test_nchex_aniso's PᵀAP checks)
SOLVE_CASES = ([(c, p) for c in ("quad", "hex", "tet") for p in (1, 2, 3)]
               + [("quad_aniso", 2), ("hex_aniso", 2)])


@pytest.mark.parametrize("case,p", SOLVE_CASES)
def test_constrained_solve_equals_jax(case, p):
    js, ts = spaces(case, p)
    u_ref, it_ref = jax_solve(js, 1e-12)
    u, its = port_solve(ts, 1e-12)
    assert its == it_ref
    assert np.abs(u - u_ref).max() <= 1e-10 * np.abs(u_ref).max()
