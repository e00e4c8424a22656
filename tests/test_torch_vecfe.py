"""The port's vector-FE operators (``ops/vecfe``, ``ops/mixed_vecfe``,
``ops/vecfe_r``, ``ops/block.mixed_divergence``) against the JAX package's,
float64 on the CPU.

Tolerances: ``mult``, ``diagonal``, the linear forms and the mixed applies
within 1e-12 of JAX's largest entry (~1e-15 apart, measured); assembled
matrices within 1e-12 of their largest entry; the discrete gradient and
curl on integer-valued inputs bitwise, and C∘G = 0, D∘C = 0 exactly there
(every partial sum is an integer).  JAX's applies run under ``jax.jit``, the pair an operator is checked on
in one call.
"""

import functools

import numpy as np
import pytest
import torch

from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector as tv
from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector_ho as tho
from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector_simplex as ts
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace, L2FESpace
from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as tmesh
from cardiac_ablation_ecm2_tpu_torch.ops import mixed_vecfe as tmx
from cardiac_ablation_ecm2_tpu_torch.ops import vecfe as to
from cardiac_ablation_ecm2_tpu_torch.ops import vecfe_r as tr
from cardiac_ablation_ecm2_tpu_torch.ops.block import mixed_divergence

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
MAKERS = {
    "hex": lambda m: m.make_cartesian_3d(2, 2, 2),
    "quad": lambda m: m.make_cartesian_2d(3, 2),
    "tet": lambda m: m.make_cartesian_3d_tet(2, 2, 1),
    "tri": lambda m: m.make_cartesian_2d_tri(3, 2),
}


def rel(a, b):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def warp(x):
    """A smooth bijection of the unit cube / square (curved elements)."""
    y = x.copy()
    y[:, 0] = x[:, 0] + 0.08 * np.sin(np.pi * x[:, 1])
    y[:, 1] = x[:, 1] + 0.06 * np.sin(np.pi * x[:, 0])
    return y


@functools.lru_cache(maxsize=None)
def meshes(kind, warped=False):
    from cardiac_ablation_ecm2_tpu.mesh import mesh as jmesh

    jm, tm = MAKERS[kind](jmesh), MAKERS[kind](tmesh)
    if warped:
        jm.vertices, tm.vertices = warp(jm.vertices), warp(tm.vertices)
    return jm, tm


SPACES = {
    "nd0": ("NDSpace", "nd", None), "rt0": ("RTSpace", "rt", None),
    "ndho": ("NDSpaceHO", "nd", 2), "rtho": ("RTSpaceHO", "rt", 2),
    "ndsx": ("NDSimplexSpace", "nd", 2), "rtsx": ("RTSimplexSpace", "rt", 2),
}


@functools.lru_cache(maxsize=None)
def spaces(kind, name, warped=False):
    from cardiac_ablation_ecm2_tpu.fem import fe_vector as jv
    from cardiac_ablation_ecm2_tpu.fem import fe_vector_ho as jho
    from cardiac_ablation_ecm2_tpu.fem import fe_vector_simplex as js

    jm, tm = meshes(kind, warped)
    cls, _, p = SPACES[name]
    jmod, tmod = {"NDSpace": (jv, tv), "RTSpace": (jv, tv), "NDSpaceHO": (jho, tho),
                  "RTSpaceHO": (jho, tho), "NDSimplexSpace": (js, ts),
                  "RTSimplexSpace": (js, ts)}[cls]
    args = () if p is None else (p,)
    return getattr(jmod, cls)(jm, *args), getattr(tmod, cls)(tm, *args)


def operators(kind, name, c0=1.3, c1=0.7, nq1d=4, warped=False):
    from cardiac_ablation_ecm2_tpu.ops import vecfe as jo

    js, tsp = spaces(kind, name, warped)
    build = "build_nd_operator" if SPACES[name][1] == "nd" else "build_rt_operator"
    return (getattr(jo, build)(js, c0, c1, nq1d=nq1d),
            getattr(to, build)(tsp, c0, c1, nq1d=nq1d, **F64))


def check_apply(jop, top, n, seed=0, matrix=True):
    """``mult`` and ``diagonal`` against JAX's (one jitted call), and with
    ``matrix`` the assembled matrices."""
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(seed).standard_normal(n)
    jy, jd = jax.jit(lambda v: (jop.mult(v), jop.diagonal()))(jnp.asarray(x))
    assert rel(jy, top.mult(torch.as_tensor(x))) <= 1e-12
    assert rel(jd, top.diagonal()) <= 1e-12
    if matrix:
        J, T = jop.assemble_matrix().toarray(), top.assemble_matrix().toarray()
        assert rel(J, T) <= 1e-12


CASES = [(k, s) for k in ("hex", "quad") for s in ("nd0", "rt0", "ndho", "rtho")] + \
        [(k, s) for k in ("tet", "tri") for s in ("nd0", "rt0", "ndsx", "rtsx")]


@pytest.mark.parametrize("kind,name", CASES)
def test_operator_apply_diagonal_matrix(kind, name):
    jop, top = operators(kind, name, warped=kind in ("quad", "hex"))
    # the assembled matrices of one space a geometry (JAX assembles on the
    # host, the slowest part of a case)
    check_apply(jop, top, top.ndof, matrix=name in ("nd0", "rtho", "rtsx"))
    field = lambda x: np.stack([np.sin(x[..., i] + i) for i in range(x.shape[-1])], -1)  # noqa: E731
    from cardiac_ablation_ecm2_tpu.ops import vecfe as jo

    assert rel(jo.vecfe_linear_form(jop, field), to.vecfe_linear_form(top, field)) <= 1e-12
    if SPACES[name][1] == "rt":
        g = lambda x: np.cos(x[..., 0]) * (1 + x[..., 1])      # noqa: E731
        assert rel(jo.vecfe_linear_form_div(jop, g), to.vecfe_linear_form_div(top, g)) <= 1e-12
    else:
        c = field if kind in ("hex", "tet") else (lambda x: np.cos(x[..., 0] * x[..., 1]))
        assert rel(jo.vecfe_linear_form_curl(jop, c), to.vecfe_linear_form_curl(top, c)) <= 1e-12


@pytest.mark.parametrize("kind", ["hex", "quad"])
def test_matrix_and_callable_coefficients(kind):
    from cardiac_ablation_ecm2_tpu.ops import vecfe as jo

    js, tsp = spaces(kind, "ndho")
    d = 3 if kind == "hex" else 2
    S = np.eye(d) * 1.5 + 0.2

    def field(x):        # (ne, nq, d, d) from either package's points
        x = np.asarray(x)
        return np.eye(d) * (1.0 + x[..., :1, None] ** 2) + 0.1

    def scal(x):
        return 1.0 + np.asarray(x)[..., 0]

    cc = field if kind == "hex" else scal
    for mass, curl in ((S, scal), (field, cc)):
        jop = jo.build_nd_operator(js, mass, curl, nq1d=4)
        top = to.build_nd_operator(tsp, mass, curl, nq1d=4, **F64)
        check_apply(jop, top, tsp.ndof, seed=3)


@pytest.mark.parametrize("kind", ["hex", "tet"])
def test_discrete_de_rham(kind):
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.ops import vecfe as jo

    jm, tm = meshes(kind, warped=True)
    jnd, tnd = spaces(kind, "nd0", True)
    jrt, trt = spaces(kind, "rt0", True)
    jh1, th1 = JFESpace(jm, 1), FESpace(tm, 1)
    assert np.array_equal(jo._vertex_dof_map(jh1), to._vertex_dof_map(th1))
    assert np.array_equal(jo.vertex_dof_positions(jm), to.vertex_dof_positions(tm))
    rng = np.random.default_rng(5)
    u = rng.integers(-50, 50, th1.ndof_scalar).astype(np.float64)
    E = rng.integers(-50, 50, tnd.ndof).astype(np.float64)
    G, C = to.discrete_gradient(th1, tnd, **F64), to.discrete_curl(tnd, trt, **F64)
    D = to.discrete_divergence(trt, **F64)
    Gj, Cj, Dj = (jo.discrete_gradient(jh1, jnd), jo.discrete_curl(jnd, jrt),
                  jo.discrete_divergence(jrt))
    tu, tE = torch.as_tensor(u), torch.as_tensor(E)
    assert np.array_equal(np.asarray(Gj(jnp.asarray(u))), G(tu).numpy())
    assert np.array_equal(np.asarray(Cj(jnp.asarray(E))), C(tE).numpy())
    F = rng.standard_normal(trt.ndof)
    assert rel(Dj(jnp.asarray(F)), D(torch.as_tensor(F))) <= 1e-12
    assert not C(G(tu)).any() and not D(C(tE)).any()
    # the adjoints are the maps' transposes
    y = torch.as_tensor(rng.standard_normal(tnd.ndof))
    assert abs(float(G.t(y) @ tu - y @ G(tu))) <= 1e-10 * float(y.abs().sum() * 100)
    z = torch.as_tensor(rng.standard_normal(trt.ndof))
    assert abs(float(C.t(z) @ tE - z @ C(tE))) <= 1e-10 * float(z.abs().sum() * 100)


def test_boundary_tangent_lf():
    from cardiac_ablation_ecm2_tpu.ops import vecfe as jo

    for kind in ("hex", "tet"):
        jnd, tnd = spaces(kind, "nd0", True)
        f = lambda x: np.stack([1 + x[..., 1], x[..., 2] ** 2, x[..., 0]], -1)  # noqa: E731
        for marker in (None, [1, 3]):
            assert rel(jo.nd_boundary_tangent_lf(jnd, f, marker),
                       to.nd_boundary_tangent_lf(tnd, f, marker, **F64)) <= 1e-12


def mixed_pair(jop, top, nt, seed):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    x = rng.standard_normal(nt)
    y = rng.standard_normal(top.ndof_test)
    jx, jy = jax.jit(lambda u, v: (jop.mult(u), jop.mult_t(v)))(jnp.asarray(x), jnp.asarray(y))
    assert rel(jx, top.mult(torch.as_tensor(x))) <= 1e-12
    assert rel(jy, top.mult_t(torch.as_tensor(y))) <= 1e-12


def test_mixed_vector_family():
    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.fem import L2FESpace as JL2
    from cardiac_ablation_ecm2_tpu.ops import mixed_vecfe as jmx

    jm, tm = meshes("hex", True)
    jnd, tnd = spaces("hex", "ndho", True)
    jrt, trt = spaces("hex", "rtho", True)
    jh1, th1 = JFESpace(jm, 2), FESpace(tm, 2)
    jl2, tl2 = JL2(jm, 1), L2FESpace(tm, 1)
    S = np.diag([1.0, 2.0, 0.5]) + 0.1
    cases = [
        ("mixed_vector_gradient", (jh1, jnd), (th1, tnd), dict(matrix_coeff=S)),
        ("mixed_vector_weak_divergence", (jnd, jh1), (tnd, th1), {}),
        ("mixed_vector_mass", (jnd, jrt), (tnd, trt), {}),
        ("mixed_vector_curl", (jnd, jrt), (tnd, trt), {}),
        ("mixed_weak_curl", (jrt, jnd), (trt, tnd), {}),
        ("vectorfe_divergence", (jrt, jl2), (trt, tl2), {}),
        ("mixed_scalar_mass", (jh1, jl2), (th1, tl2), {}),
    ]
    for i, (name, ja, ta, kw) in enumerate(cases):
        jop = getattr(jmx, name)(*ja, nq1d=4, **kw)
        top = getattr(tmx, name)(*ta, nq1d=4, **kw, **F64)
        mixed_pair(jop, top, top.ndof_trial, i)
        if i < 2:
            assert rel(jop.assemble_matrix().toarray(),
                       top.assemble_matrix().toarray()) <= 1e-12
    # 2D scalar curl on quads and triangles
    for kind, sp in (("quad", "ndho"), ("tri", "ndsx")):
        (jm2, tm2), (j2, t2) = meshes(kind), spaces(kind, sp)
        jop = jmx.mixed_scalar_curl(j2, JL2(jm2, 1), nq1d=4)
        top = tmx.mixed_scalar_curl(t2, L2FESpace(tm2, 1), nq1d=4, **F64)
        mixed_pair(jop, top, t2.ndof, 9)


def test_mixed_h1_pairings():
    from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
    from cardiac_ablation_ecm2_tpu.ops import mixed_vecfe as jmx

    jm, tm = meshes("hex", True)
    jv, tvs = JFESpace(jm, 2, vdim=3), FESpace(tm, 2, vdim=3)
    jp, tp = JFESpace(jm, 1), FESpace(tm, 1)
    jnd, tnd = spaces("hex", "nd0", True)
    V = np.array([0.3, -0.5, 0.8])

    def Vf(x):
        x = np.asarray(x)
        return np.stack([1 + x[..., 1], x[..., 0] * x[..., 2], -x[..., 2]], -1)

    cases = [
        ("vector_divergence", (jv, jp), (tvs, tp), {}),
        ("gradient", (jp, jv), (tp, tvs), {}),
        ("derivative", (jp, jp, 1), (tp, tp, 1), {}),
        ("mixed_dot_product", (jv, jp, V), (tvs, tp, V), {}),
        ("mixed_vector_product", (jp, jv, Vf), (tp, tvs, Vf), {}),
        ("mixed_cross_product", (jv, jv, V), (tvs, tvs, V), {}),
        ("mixed_directional_derivative", (jp, jp, Vf), (tp, tp, Vf), {}),
        ("mixed_grad_grad", (jp, jp), (tp, tp), dict(coeff=2.5)),
        ("mixed_cross_grad_grad", (jp, jp, V), (tp, tp, V), {}),
        ("mixed_cross_grad", (jp, jv, V), (tp, tvs, V), {}),
        ("mixed_scalar_weak_divergence", (jp, jp, V), (tp, tp, V), {}),
        ("mixed_cross_curl", (jnd, jv, V), (tnd, tvs, V), dict(nq1d=3)),
    ]
    for i, (name, ja, ta, kw) in enumerate(cases):
        jop = getattr(jmx, name)(*ja, **kw)
        top = getattr(tmx, name)(*ta, **kw, **F64)
        mixed_pair(jop, top, top.ndof_trial, 20 + i)
    jm2, tm2 = meshes("quad", False)
    j2, t2 = JFESpace(jm2, 2, vdim=2), FESpace(tm2, 2, vdim=2)
    jop = jmx.mixed_scalar_cross_product(j2, JFESpace(jm2, 1), V[:2])
    top = tmx.mixed_scalar_cross_product(t2, FESpace(tm2, 1), V[:2], **F64)
    mixed_pair(jop, top, t2.ndof, 40)


def test_mixed_divergence_block():
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2_tpu.fem import L2FESpace as JL2
    from cardiac_ablation_ecm2_tpu.ops.block import mixed_divergence as jmd

    for kind in ("quad", "hex"):
        jm, tm = meshes(kind, True)
        jrt, trt = spaces(kind, "rt0", True)
        jB, jBt = jmd(jrt, JL2(jm, 0))
        tB, tBt = mixed_divergence(trt, L2FESpace(tm, 0), **F64)
        rng = np.random.default_rng(7)
        u, p = rng.standard_normal(trt.ndof), rng.standard_normal(tm.ne)
        assert rel(jax.jit(jB)(jnp.asarray(u)), tB(torch.as_tensor(u))) <= 1e-12
        assert rel(jax.jit(jBt)(jnp.asarray(p)), tBt(torch.as_tensor(p))) <= 1e-12


@pytest.mark.parametrize("kind", ["quad", "tri"])
def test_restricted_dimension_spaces(kind):
    from cardiac_ablation_ecm2_tpu.ops import vecfe_r as jr

    jm, tm = meshes(kind, kind == "quad")
    S = np.array([[2.0, 0.3, 0.1], [0.3, 1.5, 0.2], [0.1, 0.2, 1.0]])
    for p in (1, 2):
        for ctor, build, coeffs in (
                ("NDR2DSpace", "build_nd_r2d_operator", (S, 1.3)),
                ("RTR2DSpace", "build_rt_r2d_operator", (0.9, 1.7))):
            js, tsp = getattr(jr, ctor)(jm, p), getattr(tr, ctor)(tm, p)
            assert np.array_equal(js.gather_map, tsp.gather_map)
            for marker in (None, [1]):
                assert np.array_equal(js.essential_dofs(marker), tsp.essential_dofs(marker))
            check_apply(getattr(jr, build)(js, *coeffs),
                        getattr(tr, build)(tsp, *coeffs, **F64), tsp.ndof, seed=p)


def test_nd_r1d():
    from cardiac_ablation_ecm2_tpu.ops import vecfe_r as jr

    x = np.sort(np.random.default_rng(2).uniform(0, 1, 7))
    for p in (1, 2, 3):
        js, tsp = jr.NDR1DSpace(x, p), tr.NDR1DSpace(x, p)
        assert np.array_equal(js.gather_map, tsp.gather_map)
        assert np.array_equal(js.essential_dofs(), tsp.essential_dofs())
        check_apply(jr.build_nd_r1d_operator(js, 1.2, 0.8),
                    tr.build_nd_r1d_operator(tsp, 1.2, 0.8, **F64), tsp.ndof, seed=p)
