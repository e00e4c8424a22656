"""The hand-written CUDA kernels on the card: the gather-sum, the
transposing gather, the segment-sum, the SELL SpMV of one weight plane
and the probe gathers bitwise equal to their plain PyTorch versions,
FULL assembly repeatable bit for bit, the fused diffusion apply within
rounding of its plain version at every shape it takes, with float32 or
bfloat16 qdata (and raising on one it does not), and the restriction,
the tet ELL operator, the tet partial-assembly step (merged CG, explicit
RK4), the masked cardiac-hex lattice, the coupled
ablation app, Poisson with each preconditioner, ex16 heat and ``entry()``
on CUDA equal to the CPU, the LOR operator at the [4] mesh's size
equal to a plain composition, and the operator layer (single-plane ELL
operators with rows 729 wide, the order-4 restrictions, PA forms with
convection, boundary and vector terms, GMRES, the BP harness, elasticity)
on CUDA equal to the CPU or bitwise to plain, the sharded bioheat
step at world size 1 over NCCL equal to world size 1 over gloo, and the
mesh core (2D restrictions bitwise to plain, ``HTransfer``, h-multigrid
PCG and 2D Poisson on quads, triangles and curved quads) on CUDA equal to
the CPU, and the NC slice (P and Pᵀ bitwise their plain versions, NC
solves and the sharded NC Poisson at world 1 over NCCL equal to the CPU).
Needs an NVIDIA GPU and nvcc; skips without a GPU.  This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cardiac_ablation_ecm2_tpu_torch.fem.basis import make_dof_to_quad
from cardiac_ablation_ecm2_tpu_torch.fem.cartesian import CartesianFESpace
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.fem.geometry import Geometry
from cardiac_ablation_ecm2_tpu_torch.fem.masked_lattice import masked_lattice_essential
from cardiac_ablation_ecm2_tpu_torch.fem.quadinterp import device_basis
from cardiac_ablation_ecm2_tpu_torch.fem.restriction import (
    ElementRestriction,
    scatter_slots,
)
from cardiac_ablation_ecm2_tpu_torch.linalg import ode
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import (
    make_cardiac_hex_lattice,
    make_cardiac_hex_mesh,
    make_cardiac_tet_mesh,
)
from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import (
    make_cartesian_3d,
    make_cartesian_3d_tet,
)
from cardiac_ablation_ecm2_tpu_torch.models import bioheat
from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg
from cardiac_ablation_ecm2_tpu_torch.ops import ell
from cardiac_ablation_ecm2_tpu_torch.ops import fused_diffusion as fd
from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
from cardiac_ablation_ecm2_tpu_torch.utils.config import config, configure


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("J", [1, 3, 8])
def test_kernel_bitwise_equals_plain(cuda, dtype, J):
    rng = np.random.default_rng(J)
    nsrc, nout = 100_003, 333_333
    src = torch.as_tensor(rng.standard_normal(nsrc), dtype=dtype, device=cuda)
    src[::97] = -0.0
    idx = torch.as_tensor(rng.integers(0, nsrc + 1, (J, nout)),
                          dtype=torch.int32, device=cuda)
    before = bg.gather_sum.launches
    out = bg.gather_sum(src, idx)
    torch.cuda.synchronize()
    assert bg.gather_sum.launches == before + 1
    ref = bg.gather_sum_plain(src, idx)
    assert torch.equal(out.view(torch.int64 if dtype == torch.float64
                                else torch.int32),
                       ref.view(torch.int64 if dtype == torch.float64
                                else torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ne,nd", [(1_037, 27), (4_099, 10), (95_683, 10),
                                   (300, 64), (130, 125)])
def test_gather_transpose_bitwise_equals_plain(cuda, dtype, ne, nd):
    """Partial last tiles, the tet and hex widths, and widths whose tile
    is halved to fit 48 KB of shared memory (64 and 125 in float64)."""
    rng = np.random.default_rng(ne + nd)
    nsrc = 50_021
    src = torch.as_tensor(rng.standard_normal(nsrc), dtype=dtype, device=cuda)
    src[::53] = -0.0
    g = torch.as_tensor(rng.integers(0, nsrc + 1, (ne, nd)), dtype=torch.int32,
                        device=cuda)
    before = bg.gather_transpose.launches
    out = bg.gather_transpose(src, g)
    torch.cuda.synchronize()
    assert bg.gather_transpose.launches == before + 1
    assert out.shape == (nd, ne)
    assert torch.equal(_bits(out), _bits(bg.gather_transpose_plain(src, g)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_bitwise_equals_plain(cuda, dtype):
    """Segments of 0 to ~60 slots, −0.0 sources."""
    rng = np.random.default_rng(21)
    ndof = 40_009
    flat = rng.integers(0, ndof, 400_000)
    flat[:60] = 17                                    # one long segment
    flat[(flat % 101) == 5] += 1                      # dofs without a slot
    slots, offsets = scatter_slots(flat, ndof)
    src = torch.as_tensor(rng.standard_normal(flat.size), dtype=dtype, device=cuda)
    src[::7] = -0.0
    sl, off = (torch.as_tensor(a, device=cuda) for a in (slots, offsets))
    before = bg.segment_sum.launches
    out = bg.segment_sum(src, sl, off)
    torch.cuda.synchronize()
    assert bg.segment_sum.launches == before + 1
    assert torch.equal(_bits(out), _bits(bg.segment_sum_plain(src, sl, off)))


def test_full_assembly_repeatable_on_card(cuda):
    """FULL assembly on the card sums duplicates with the segment-sum (no
    float atomics): two assemblies are bitwise equal, with the CPU's
    pattern and its data to round-off."""
    L = 0.04
    fes = FESpace(make_cardiac_tet_mesh(8, lengths=(L, L, L / 2),
                                        electrode_radius=0.004), 2)

    def assemble(dev):
        return BilinearForm(fes, dev).add_domain_integrator(
            "diffusion", 0.54).assemble_matrix()

    A, B, C = assemble(cuda), assemble(cuda), assemble("cpu")
    assert np.array_equal(A.indptr, B.indptr) and np.array_equal(A.indices, B.indices)
    assert np.array_equal(A.data.view(np.int64), B.data.view(np.int64))
    assert np.array_equal(A.indices, C.indices)
    assert np.abs(A.data - C.data).max() <= 1e-12 * np.abs(C.data).max()


def test_restriction_cuda_equals_cpu(cuda):
    L = 0.04
    fes = FESpace(make_cardiac_hex_mesh(12, lengths=(L, L, L / 2),
                                        electrode_radius=0.004), 2)
    rc = ElementRestriction(fes.gather_map, fes.ndof, cuda)
    rh = ElementRestriction(fes.gather_map, fes.ndof, "cpu")
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.standard_normal(fes.ndof))
    ue = torch.as_tensor(rng.standard_normal(fes.gather_map.shape))
    assert torch.equal(rc.mult(u.to(cuda)).cpu(), rh.mult(u))
    assert torch.equal(rc.mult_t(u.to(cuda)).cpu(), rh.mult_t(u))
    assert torch.equal(rc.mult_transpose(ue.to(cuda)).cpu(), rh.mult_transpose(ue))
    ueT = ue.T.contiguous()
    assert torch.equal(rc.mult_transpose_t(ueT.to(cuda)).cpu(),
                       rh.mult_transpose_t(ueT))


def _random_pair(n, seed):
    rng = np.random.default_rng(seed)

    def one():
        nnz = rng.integers(1, 140, n)
        rows = np.repeat(np.arange(n), nnz)
        cols = rng.integers(0, n, rows.size)
        return sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                             shape=(n, n))

    return one(), one()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_kernel_bitwise_equals_plain(cuda, dtype):
    A, B = _random_pair(20_011, 3)
    pair = ell.MultiELLPair.from_csr_pair(A, B, dtype, cuda)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(A.shape[0]),
                        dtype=dtype, device=cuda)
    x[::89] = -0.0
    for c0, c1 in ((1.0, 0.10896662), (0.0, 1.0), (1.0, 0.0), (-2.0, 5.0)):
        plane = pair.combined(c0, c1)
        before = ell.ell_spmv.launches
        y = ell.ell_spmv(plane, x)
        torch.cuda.synchronize()
        assert ell.ell_spmv.launches == before + 1
        assert torch.equal(_bits(y), _bits(ell.ell_spmv_plain(plane, x)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_combined_plane_bitwise_equals_plain(cuda, dtype):
    """``mult_combined`` on the card (a plane formed, then the kernel)
    against the plain version on a CPU copy of the pair, bit for bit."""
    A, B = _random_pair(20_011, 5)
    pair = ell.MultiELLPair.from_csr_pair(A, B, dtype, cuda)
    host = ell.MultiELLPair.from_csr_pair(A, B, dtype, "cpu")
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(A.shape[0]),
                        dtype=dtype)
    x[::89] = -0.0
    for c0, c1 in ((1.0, 0.10896662), (0.0, 1.0)):
        before = ell.ell_spmv.launches
        y = pair.mult_combined(x.to(cuda), c0, c1)
        torch.cuda.synchronize()
        assert ell.ell_spmv.launches == before + 1
        assert torch.equal(_bits(y.cpu()), _bits(host.mult_combined(x, c0, c1)))


def test_tet_ell_operator_cuda_equals_cpu(cuda):
    L = 0.04
    old = config.quad_extra
    configure(quad_extra=0)
    try:
        fes = FESpace(make_cardiac_tet_mesh(6, lengths=(L, L, L / 2),
                                            electrode_radius=0.004), 2)
        kw = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, q_met=1e6,
                  ess_bdr=[1, 2, 3, 4, 5, 6], rel_tol=1e-5, max_iter=300,
                  dtype="float64", fused_setup=True, theta_form=True,
                  assembled_apply="ell")
        ops = [bioheat.BioheatOperator(fes, device=d, **kw) for d in (cuda, "cpu")]
    finally:
        configure(quad_extra=old)
    before = ell.ell_spmv.launches
    Ts = []
    for op in ops:
        step = bioheat.make_stepper(op, ode.select("sdirk33"))
        T = torch.zeros(fes.ndof, dtype=torch.float64, device=op.device)
        for _ in range(2):
            T, _t = step(T, 0.0, 0.25)
        Ts.append(T.cpu())
    assert ell.ell_spmv.launches > before
    assert ops[0].cg_iterations == ops[1].cg_iterations
    rel = float((Ts[0] - Ts[1]).abs().max() / Ts[1].abs().max())
    assert rel <= 1e-10, rel


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n1,nq1", fd.SHAPES)
def test_fused_diffusion_matches_plain(cuda, n1, nq1, dtype, tol):
    """Random E-vector and qdata at an odd ne (a short last tile), and the
    collapsed (6, 1, nq) qdata; tolerance relative to max|y| (the kernel and
    the einsums sum in different orders)."""
    rng = np.random.default_rng(10 * n1 + nq1)
    db = device_basis(make_dof_to_quad(Geometry.CUBE, n1 - 1, nq1), dtype, cuda)
    ne = 1_009
    e = torch.as_tensor(rng.standard_normal((ne, n1 ** 3)), dtype=dtype, device=cuda)
    q = torch.as_tensor(rng.standard_normal((6, ne, nq1 ** 3)), dtype=dtype,
                        device=cuda)
    for qd in (q, q[:, :1].contiguous()):
        before = fd.diffusion_apply.launches
        y = fd.diffusion_apply(db, qd, e)
        torch.cuda.synchronize()
        assert fd.diffusion_apply.launches == before + 1
        ref = fd.diffusion_apply_plain(db, qd, e)
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err <= tol, err


@pytest.mark.parametrize("n1,nq1", fd.SHAPES)
def test_fused_diffusion_bf16_qdata_matches_plain(cuda, n1, nq1):
    """The bfloat16-qdata instantiation (float32 e and y) against the plain
    version fed the same bfloat16 values, within [8]'s float32 tolerance,
    full and collapsed qdata; float64 e with bfloat16 qdata raises."""
    rng = np.random.default_rng(20 * n1 + nq1)
    db = device_basis(make_dof_to_quad(Geometry.CUBE, n1 - 1, nq1),
                      torch.float32, cuda)
    ne = 1_009
    e = torch.as_tensor(rng.standard_normal((ne, n1 ** 3)), dtype=torch.float32,
                        device=cuda)
    q = torch.as_tensor(rng.standard_normal((6, ne, nq1 ** 3)),
                        dtype=torch.bfloat16, device=cuda)
    for qd in (q, q[:, :1].contiguous()):
        before = fd.diffusion_apply.launches
        y = fd.diffusion_apply(db, qd, e)
        torch.cuda.synchronize()
        assert fd.diffusion_apply.launches == before + 1
        ref = fd.diffusion_apply_plain(db, qd, e)
        assert ref.dtype == torch.float32
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err <= 1e-5, err
    db64 = device_basis(make_dof_to_quad(Geometry.CUBE, n1 - 1, nq1),
                        torch.float64, cuda)
    with pytest.raises(ValueError):
        fd.diffusion_apply(db64, q, e.double())


def test_fused_diffusion_rejects_unsupported_shape(cuda):
    db = device_basis(make_dof_to_quad(Geometry.CUBE, 5, 6), torch.float32, cuda)
    e = torch.zeros(7, 216, device=cuda)
    q = torch.zeros(6, 7, 216, device=cuda)
    before = fd.diffusion_apply.launches
    with pytest.raises(ValueError):
        fd.diffusion_apply(db, q, e)
    assert fd.diffusion_apply.launches == before


@pytest.mark.parametrize("affine", ["auto", "off"])
def test_tet_pa_operator_cuda_equals_cpu(cuda, affine):
    """The tet partial-assembly step (affine, and the per-point lane-major
    apply with the affine collapse off) at n=8 in float64: three SDIRK33
    steps with merged CG, and one explicit RK4 step, on the card within
    1e-10 of the CPU with equal CG counts."""
    L = 0.04
    old = config.quad_extra, config.affine_collapse
    configure(quad_extra=0, affine_collapse=affine)
    try:
        fes = FESpace(make_cardiac_tet_mesh(8, lengths=(L, L, L / 2),
                                            electrode_radius=0.004), 2)
        kw = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, ess_bdr=[1, 2, 3], rel_tol=1e-5,
                  max_iter=300, theta_form=True, q_met=1e6, dtype="float64",
                  cg_variant="merged")
        ops = [bioheat.BioheatOperator(fes, device=d, **kw) for d in (cuda, "cpu")]
    finally:
        configure(quad_extra=old[0], affine_collapse=old[1])
    assert (ops[0]._aff is not None) == (affine == "auto")
    Ts, Ks = [], []
    for op in ops:
        T = torch.zeros(fes.ndof, dtype=torch.float64, device=op.device)
        t = 0.0
        for _ in range(3):
            T, t = ode.select("sdirk33").step(op, T, t, 0.25)
        Ts.append(T.cpu())
        Ks.append(ode.select("rk4").step(op, T, t, 0.01)[0].cpu())
    assert ops[0].cg_iterations == ops[1].cg_iterations
    for a, b in (Ts, Ks):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-10


def test_masked_lattice_cuda_equals_cpu(cuda):
    """BENCH_MESH=cardiac-hex BENCH_STRUCTURED=1 at n=10 in float64: the
    structured restriction and the fused diffusion kernel on the card
    against the plain versions on the CPU."""
    L = 0.04
    mesh, keep, ns = make_cardiac_hex_lattice(10, lengths=(L, L, L / 2),
                                              electrode_radius=0.004)
    fes = CartesianFESpace(mesh, 2, ns, (L, L, L / 2))
    old = config.quad_extra
    configure(quad_extra=0)
    try:
        kw = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, q_met=1e6, rel_tol=1e-5,
                  max_iter=300, dtype="float64", fused_setup=True,
                  theta_form=True, elem_mask=keep.astype(np.float64),
                  ess_dofs=masked_lattice_essential(ns, 2, keep))
        ops = [bioheat.BioheatOperator(fes, device=d, **kw) for d in (cuda, "cpu")]
    finally:
        configure(quad_extra=old)
    before = fd.diffusion_apply.launches
    Ts = []
    for op in ops:
        step = bioheat.make_stepper(op, ode.select("sdirk33"))
        T = torch.zeros(fes.ndof, dtype=torch.float64, device=op.device)
        for _ in range(2):
            T, _t = step(T, 0.0, 0.25)
        Ts.append(T.cpu())
    assert fd.diffusion_apply.launches > before
    assert ops[0].cg_iterations == ops[1].cg_iterations
    rel = float((Ts[0] - Ts[1]).abs().max() / Ts[1].abs().max())
    assert rel <= 1e-10, rel


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,shape", [
    ("take_flat", (1_001, 5_003)),
    # take_along_rows (R, C, B), B >= 2R (strips) but where said: strips of
    # one sector a row (w = 8 float32, 4 float64), w = 4 float32 (R in
    # (7,264, 14,528]; float64 w = 2), w = 2 float32 (float64 w = 1), w = 1
    # float32 (float64 direct), the direct branch for R above 58,112 floats,
    # a narrow last strip (C = 130), a table narrower than a strip (C = 3),
    # the direct branch for B < 2R, and a tiny output on strips
    ("take_along_rows", (713, 128, 2_333)), ("take_along_rows", (10_000, 16, 20_100)),
    ("take_along_rows", (20_000, 16, 40_100)), ("take_along_rows", (40_000, 16, 80_100)),
    ("take_along_rows", (60_000, 16, 120_100)), ("take_along_rows", (100, 130, 2_100)),
    ("take_along_rows", (17, 3, 90_000)), ("take_along_rows", (512, 128, 512)),
    ("take_along_rows", (17, 3, 41)),
    # take_along_lanes (B, W, K): dense rows staged (K = W, and K > W/2 with
    # odd row bytes), sparse rows direct (K = W/8 in items of 4, K = 61 one
    # at a time), rows wider than the 48 KB staged tile, odd widths
    ("take_along_lanes", (2_333, 128, 128)), ("take_along_lanes", (300, 130, 100)),
    ("take_along_lanes", (517, 1_024, 128)), ("take_along_lanes", (300, 512, 61)),
    ("take_along_lanes", (9, 16_384, 77)), ("take_along_lanes", (41, 3, 5)),
    ("take_rows", (713, 128, 2_333)), ("take_rows", (37, 5, 101))])
def test_probe_kernels_bitwise_equal_plain(cuda, dtype, kind, shape):
    """Each probe gather on the card against its plain version, at a shape
    for every branch of its kernel (see the list above).  Every index lies
    on the gathered axis; then a second call with about one index in
    twenty outside it (−1 or the axis length) must read 0 there and equal
    the plain version elsewhere (one out-of-range row index for
    take_rows)."""
    from cardiac_ablation_ecm2_tpu_torch.ops import gather_probes as gp

    rng = np.random.default_rng(sum(shape))
    fn, plain = getattr(gp, kind), getattr(gp, kind + "_plain")
    if kind == "take_flat":
        n, k = shape
        data = rng.standard_normal(n)
        idx = rng.integers(0, n, (k // 7, 7))
    elif kind == "take_along_rows":
        R, C, B = shape
        data, idx = rng.standard_normal((R, C)), rng.integers(0, R, (B, C))
    elif kind == "take_along_lanes":
        B, W, K = shape
        data, idx = rng.standard_normal((B, W)), rng.integers(0, W, (B, K))
    else:
        R, C, N = shape
        data, idx = rng.standard_normal((R, C)), np.sort(rng.integers(0, R, N))
    data = torch.as_tensor(data, dtype=dtype, device=cuda)
    idx = torch.as_tensor(idx, dtype=torch.int32, device=cuda)
    before = fn.launches
    out = fn(data, idx)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(_bits(out), _bits(plain(data, idx)))
    if kind == "take_rows":
        bad = torch.tensor([0, data.shape[0], -1], dtype=torch.int32, device=cuda)
        out = fn(data, bad)
        assert torch.equal(out[0], data[0]) and not out[1:].any()
    elif kind in ("take_along_rows", "take_along_lanes"):
        axis = data.shape[0] if kind == "take_along_rows" else data.shape[1]
        off = torch.as_tensor(rng.random(idx.shape) < 0.05, device=cuda)
        bad = torch.where(off, torch.as_tensor(
            np.where(rng.random(idx.shape) < 0.5, -1, axis), dtype=torch.int32,
            device=cuda), idx)
        out = fn(data, bad)
        ref = plain(data, torch.where(off, 0, bad)).masked_fill(off, 0.0)
        assert off.any() and not out[off].any()
        assert torch.equal(_bits(out), _bits(ref))


def test_ablation_cuda_equals_cpu(cuda):
    """The coupled app at the cardiac hex n=6 in float64, σ(T) re-solved
    every step: Φ, SAR, T and Ω on the card within 1e-10 of the CPU, equal
    CG counts for every RF and stage solve, and both kernels launched.  The
    coupled steps follow one plain step: at the uniform T_a, σ(T) is a
    constant, Φ does not change, and a re-solve there would iterate on
    round-off, whose CG count differs between summation orders."""
    from cardiac_ablation_ecm2_tpu_torch.models.ablation import AblationSim

    L = 0.04
    mesh = make_cardiac_hex_mesh(6, lengths=(L, L, L / 2), electrode_radius=0.004)
    kw = dict(electrode_bdr=[2], ground_bdr=[3], body_bdr=[1], voltage=30.0,
              sigma=0.54, rel_tol=1e-11, dtype="float64", resolve_every=1,
              sigma_T=lambda Tq: 0.54 * (1.0 + 0.015 * (Tq - 37.0)))
    before = bg.gather_sum.launches, fd.diffusion_apply.launches
    sims = [AblationSim(mesh=mesh, device=d, **kw) for d in (cuda, "cpu")]
    out = []
    for s in sims:
        T, om, t = s.step(*s.initial_state(), 0.0, 0.5)
        out.append(s.run(t + 1.0, 0.5, T, om, t0=t))
    assert bg.gather_sum.launches > before[0]
    assert fd.diffusion_apply.launches > before[1]
    assert sims[0].rf.iterations == sims[1].rf.iterations
    assert sims[0].rf_op.cg_iterations == sims[1].rf_op.cg_iterations
    assert sims[0].op.cg_iterations == sims[1].op.cg_iterations
    pairs = [(sims[0].rf.phi, sims[1].rf.phi), (sims[0].phi, sims[1].phi),
             (sims[0].sar_q, sims[1].sar_q), (out[0][0], out[1][0]),
             (out[0][1], out[1][1])]
    for a, b in pairs:
        rel = float((a.cpu() - b).abs().max() / b.abs().max())
        assert rel <= 1e-10, rel


@pytest.fixture
def quad_extra_0():
    old = config.quad_extra
    configure(quad_extra=0)
    yield
    configure(quad_extra=old)


def _rel(a, b):
    return float((a.cpu() - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("pre", ["jacobi", "chebyshev", "lor", None])
def test_poisson_cuda_equals_cpu(cuda, quad_extra_0, pre):
    """Poisson on the cardiac hex n=16 in float64 (κ 0.54, u = 0 on the
    electrode and the ground, rel_tol 1e-10): u on the card within 1e-10 of
    the CPU and equal CG counts; the power method's start is drawn on the
    CPU, so the Chebyshev bounds start alike."""
    from cardiac_ablation_ecm2_tpu_torch.models import poisson

    L = 0.04
    mesh = make_cardiac_hex_mesh(16, lengths=(L, L, L / 2), electrode_radius=0.004)
    kw = dict(order=2, rhs=1.0, kappa=0.54, ess_bdr=[2, 3], rel_tol=1e-10,
              max_iter=3000, preconditioner=pre, dtype="float64")
    before = bg.gather_transpose.launches, bg.segment_sum.launches
    rg = poisson.solve(mesh, device=cuda, **kw)
    assert bg.gather_transpose.launches > before[0]
    assert bg.segment_sum.launches > before[1]
    rc = poisson.solve(mesh, device="cpu", **kw)
    assert rg.converged and rc.converged
    assert rg.iterations == rc.iterations
    assert _rel(rg.u, rc.u) <= 1e-10


def test_heat_cuda_equals_cpu(cuda, quad_extra_0):
    """ex16 on the cardiac hex n=6 in float64 (faces 2 and 3 held): three
    SDIRK33 steps on the card within 1e-10 of the CPU, equal stage CG
    counts, the fused diffusion kernel launched."""
    from cardiac_ablation_ecm2_tpu_torch.fem.gridfunction import project
    from cardiac_ablation_ecm2_tpu_torch.models import heat

    L = 0.04
    fes = FESpace(make_cardiac_hex_mesh(6, lengths=(L, L, L / 2),
                                        electrode_radius=0.004), 2)
    before = fd.diffusion_apply.launches
    out, ops = [], []
    for d in (cuda, "cpu"):
        op = heat.ConductionOperator(fes, ess_bdr=(2, 3), dtype="float64", device=d)
        u = project(fes, lambda x: torch.exp(-20.0 * (((x - L / 2) / L) ** 2).sum(-1)),
                    "float64", d)
        step = heat.make_stepper(op, ode.select("sdirk33"))
        t = 0.0
        for _ in range(3):
            u, t = step(u, t, 0.01)
        out.append(u)
        ops.append(op)
    assert fd.diffusion_apply.launches > before
    assert ops[0].cg_iterations == ops[1].cg_iterations
    assert _rel(out[0], out[1]) <= 1e-10


def test_entry_cuda_equals_cpu(cuda):
    """``entry()`` in the configured float64: θ = T − 37 on the card within
    1e-10 of the CPU."""
    from cardiac_ablation_ecm2_tpu_torch.entry import entry

    out = []
    for d in (cuda, "cpu"):
        fn, args = entry(device=d)
        assert args[0].device.type == torch.device(d).type
        T, t = fn(*args)
        assert float(t) == 0.5
        out.append(T - 37.0)
    assert out[0].dtype == torch.float64
    assert _rel(out[0], out[1]) <= 1e-10


def test_lor_operator_matches_plain_composition(cuda, quad_extra_0):
    """``DeviceLOROperator.mult`` on the [4] mesh (cardiac hex n=126, order
    2, 7,962,688 sub-hexes) in float64, electrode and ground constrained:
    within 1e-12·max|y| of a plain ``index_select`` / batched matvec /
    ``index_add_`` composition on the same element matrices, so the LOR
    restriction (the gather and segment-sum kernels) is held to a plain
    version at its full size."""
    from cardiac_ablation_ecm2_tpu_torch.ops.lor_device import DeviceLOROperator

    L = 0.04
    fes = FESpace(make_cardiac_hex_mesh(126, lengths=(L, L, L / 2),
                                        electrode_radius=0.004), 2)
    ess = fes.essential_dofs([2, 3])
    op = DeviceLOROperator(fes, 0.54, ess=ess, dtype="float64", device=cuda)
    assert op.A_e.shape == (7_962_688, 8, 8)
    x = torch.randn(fes.ndof, dtype=torch.float64, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(8))
    before = bg.gather_sum.launches, bg.segment_sum.launches
    y = op.mult(x)
    assert (bg.gather_sum.launches, bg.segment_sum.launches) == (
        before[0] + 1, before[1] + 1)
    conn = op.restr.g[0].long()
    keep = 1.0 - op.ess_mask
    e = (x * keep).index_select(0, conn).view(-1, 8)
    ye = torch.einsum("snm,sm->sn", op.A_e, e)
    ref = torch.zeros_like(x).index_add_(0, conn, ye.reshape(-1))
    ref = ref * keep + x * op.ess_mask
    assert float((y - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def _stiffness(mesh, p):
    return BilinearForm(FESpace(mesh, p), "cpu").add_domain_integrator(
        "diffusion").assemble_matrix("float64")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_single_plane_bitwise_equals_plain(cuda, dtype):
    """One weight plane of the operator layer's ELL operators: a hex
    order-4 stiffness (vertex rows 729 wide) and a random rectangular
    matrix, the kernel bitwise equal to its plain version."""
    K = _stiffness(make_cartesian_3d(3, 3, 3), 4)
    R = sp.random(5_003, 3_001, density=0.004, random_state=8, format="csr")
    for A, cls in ((K, ell.MultiELLOperator), (R, ell.ELLOperator)):
        op = cls.from_csr(A, dtype, device=cuda)
        assert A is R or op.max_width == 729
        x = torch.as_tensor(np.random.default_rng(9).standard_normal(A.shape[1]),
                            dtype=dtype, device=cuda)
        before = ell.ell_spmv.launches
        y = op.mult(x)
        torch.cuda.synchronize()
        assert ell.ell_spmv.launches == before + 1 and y.shape == (A.shape[0],)
        assert torch.equal(_bits(y), _bits(ell.ell_spmv_plain(op, x)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("geom", ["hex", "tet"])
def test_order4_restriction_bitwise_equals_plain(cuda, dtype, geom):
    """The order-4 maps the BP harness runs: hex nd = 125, tet nd = 35, in
    every layout, bitwise equal to the plain versions."""
    mesh = (make_cartesian_3d if geom == "hex" else make_cartesian_3d_tet)(5, 4, 3)
    fes = FESpace(mesh, 4)
    r = ElementRestriction(fes.gather_map, fes.ndof, cuda)
    assert r.nd == (125 if geom == "hex" else 35)
    gen = torch.Generator(device=cuda).manual_seed(4)
    u = torch.randn(fes.ndof, generator=gen, device=cuda, dtype=dtype)
    ue = torch.randn(r.ne * r.nd, generator=gen, device=cuda, dtype=dtype)
    pairs = [(bg.gather_sum(u, r.g), bg.gather_sum_plain(u, r.g)),
             (bg.gather_transpose(u, r.gm), bg.gather_transpose_plain(u, r.gm))]
    for slots in (r.slots, r.slotsT):
        pairs.append((bg.segment_sum(ue, slots, r.offsets),
                      bg.segment_sum_plain(ue, slots, r.offsets)))
    for a, b in pairs:
        assert torch.equal(_bits(a), _bits(b))


def test_operator_layer_cuda_equals_cpu(cuda):
    """Float64 on the card against the CPU, 1e-12: a scalar form with
    convection and a boundary mass (affine lane path), a vdim-3 elasticity
    form with a matrix diffusion term, their diagonals; GMRES on the
    scalar form (equal iterations); the BP harness at n=4 in every mode
    (8 CG iterations); a small elasticity solve (equal CG counts)."""
    from cardiac_ablation_ecm2_tpu_torch.benchmarks import bp
    from cardiac_ablation_ecm2_tpu_torch.linalg.smoothers import jacobi
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import gmres
    from cardiac_ablation_ecm2_tpu_torch.models import elasticity

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    mesh = make_cartesian_3d(3, 3, 3)
    K = torch.tensor([[2.0, 0.3, 0.1], [0.3, 1.5, 0.2], [0.1, 0.2, 1.0]],
                     dtype=torch.float64)
    outs = []
    for d in (cuda, "cpu"):
        fes = FESpace(mesh, 2)
        A = (BilinearForm(fes, d).add_domain_integrator("diffusion", 0.05)
             .add_domain_integrator("convection", None, vector_coeff=(1.0, 0.5, 0.25))
             .add_boundary_integrator("mass", 1.0, marker=[1, 3]).assemble("float64"))
        vfes = FESpace(mesh, 2, vdim=3)
        nq = vfes.d2q.weights.shape[0]
        V = (BilinearForm(vfes, d).add_domain_integrator("elasticity", (1.3, 0.8))
             .add_domain_integrator("diffusion", K.expand(mesh.ne, nq, 3, 3))
             .assemble("float64"))
        x = torch.as_tensor(np.random.default_rng(1).standard_normal(vfes.ndof),
                            device=d)
        b = torch.ones(fes.ndof, dtype=torch.float64, device=d)
        y, info = gmres(A.mult, b, M=jacobi(A.diagonal()), rel_tol=1e-10,
                        restart=10, max_iter=500)
        outs.append((A.mult(x[:fes.ndof]), A.diagonal(), V.mult(x), V.diagonal(),
                     y, info.iterations))
    for a, b in zip(outs[0][:5], outs[1][:5]):
        assert rel(a, b) <= 1e-12
    assert outs[0][5] == outs[1][5]
    for kw in ({}, dict(structured=True), dict(simplex=True), dict(ell=True),
               dict(ell=True, simplex=True)):
        card = bp.run((1, 2, 3, 4), 4, "float64", 8, device=cuda, **kw)
        host = bp.run((1, 2, 3, 4), 4, "float64", 8, device="cpu", **kw)
        for a, b in zip(card, host):
            assert a["cg_iters"] == b["cg_iters"] and rel(a["x"], b["x"]) <= 1e-10
    res = [elasticity.solve(make_cartesian_3d(8, 2, 2, sx=4.0), 2, fixed_bdr=(5,),
                            force_bdr=(3,), dtype="float64", device=d)
           for d in (cuda, "cpu")]
    assert res[0].iterations == res[1].iterations
    assert rel(res[0].u, res[1].u) <= 1e-10


def _sharded_step(rank, world, dev):
    """Two sharded SDIRK33 steps on the cardiac hex mesh n=6, float64."""
    from cardiac_ablation_ecm2_tpu_torch.parallel import bioheat as pbio

    L = 0.04

    def src(x):
        r2 = (x[..., 0] - L / 2) ** 2 + (x[..., 1] - L / 2) ** 2 + (x[..., 2] - L / 4) ** 2
        return 2e7 * torch.exp(-r2 / (2 * 0.003 ** 2))

    sim = pbio.setup(make_cardiac_hex_mesh(6, lengths=(L, L, L / 2),
                                           electrode_radius=0.004),
                     order=2, q_src=src, ess_bdr=[1, 2, 3, 4, 5, 6],
                     rel_tol=1e-10, dtype="float64", device=dev)
    T, t = sim.T0, 0.0
    for _ in range(2):
        T, t = sim.step(T, t, 0.25)
    return torch.as_tensor(sim.gather(T)), list(sim.cg_iterations)


def test_sharded_world1_nccl_equals_gloo(cuda):
    """The sharded bioheat step at world size 1 over NCCL on the card (its
    restriction kernels and the fused diffusion apply) against world size
    1 over gloo on the CPU: within 1e-10, equal CG counts."""
    from cardiac_ablation_ecm2_tpu_torch.parallel import launch

    before = [bg.gather_sum.launches, bg.segment_sum.launches,
              fd.diffusion_apply.launches]
    Tg, itg = launch.run_single(_sharded_step, None)
    after = [bg.gather_sum.launches, bg.segment_sum.launches,
             fd.diffusion_apply.launches]
    assert all(a > b for a, b in zip(after, before))
    Tc, itc = launch.run_single(_sharded_step, "cpu")
    assert itg == itc
    assert _rel(Tg - 37.0, Tc - 37.0) <= 1e-10


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("geom,p", [("quad", 1), ("quad", 2), ("quad", 3),
                                    ("tri", 1), ("tri", 2), ("tri", 3)])
def test_2d_restriction_bitwise_equals_plain(cuda, dtype, geom, p):
    """The 2D maps (quad nd 4/9/16, tri nd 3/6/10) of a refined mesh (its
    children numbered o·ne_c + e) in every layout, bitwise equal to the
    plain versions."""
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import (
        make_cartesian_2d,
        make_cartesian_2d_tri,
    )

    make = make_cartesian_2d if geom == "quad" else make_cartesian_2d_tri
    fes = FESpace(make(9, 7).uniform_refinement(), p)
    r = ElementRestriction(fes.gather_map, fes.ndof, cuda)
    assert r.nd == ((p + 1) ** 2 if geom == "quad" else (p + 1) * (p + 2) // 2)
    gen = torch.Generator(device=cuda).manual_seed(p)
    u = torch.randn(fes.ndof, generator=gen, device=cuda, dtype=dtype)
    ue = torch.randn(r.ne * r.nd, generator=gen, device=cuda, dtype=dtype)
    pairs = [(bg.gather_sum(u, r.g), bg.gather_sum_plain(u, r.g)),
             (bg.gather_transpose(u, r.gm), bg.gather_transpose_plain(u, r.gm))]
    for slots in (r.slots, r.slotsT):
        pairs.append((bg.segment_sum(ue, slots, r.offsets),
                      bg.segment_sum_plain(ue, slots, r.offsets)))
    for a, b in pairs:
        assert torch.equal(_bits(a), _bits(b))


def _h_hierarchy(geom):
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import (
        make_cartesian_2d,
        make_cartesian_2d_tri,
    )

    if geom == "hex":
        coarse = make_cardiac_hex_mesh(3, lengths=(0.04, 0.04, 0.02),
                                       electrode_radius=0.004)
    else:
        coarse = (make_cartesian_2d if geom == "quad" else make_cartesian_2d_tri)(4, 4)
    return [coarse, coarse.uniform_refinement(), coarse.uniform_refinement(2)]


@pytest.mark.parametrize("geom", ["quad", "tri", "hex"])
def test_htransfer_cuda_equals_cpu(cuda, geom):
    """HTransfer prolongate and restrict_t in float64 on the card (the
    restriction kernels) against the CPU, 1e-13."""
    from cardiac_ablation_ecm2_tpu_torch.fem.transfer import HTransfer

    meshes = _h_hierarchy(geom)[:2]
    fc, ff = FESpace(meshes[0], 2), FESpace(meshes[1], 2)
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal(fc.ndof), rng.standard_normal(ff.ndof)
    outs = []
    for d in (cuda, "cpu"):
        before = bg.segment_sum.launches
        tr = HTransfer(fc, ff, "float64", d)
        outs.append((tr.prolongate(torch.as_tensor(a, device=d)),
                     tr.restrict_t(torch.as_tensor(b, device=d))))
        if d == cuda:
            assert bg.segment_sum.launches > before
    for x, y in zip(*outs):
        assert _rel(x.cpu(), y) <= 1e-13


@pytest.mark.parametrize("geom", ["quad", "hex"])
def test_h_multigrid_cuda_equals_cpu(cuda, geom):
    """make_h_multigrid PCG (three levels, order 2, u = 0 on the boundary)
    in float64 on the card against the CPU: equal CG counts, 1e-10."""
    from cardiac_ablation_ecm2_tpu_torch.linalg.multigrid import make_h_multigrid
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf
    from cardiac_ablation_ecm2_tpu_torch.ops.operators import ConstrainedOperator

    meshes = _h_hierarchy(geom)
    spaces = {id(m): FESpace(m, 2) for m in meshes}
    runs = []
    for d in (cuda, "cpu"):
        def op(f):
            A = BilinearForm(f, d).add_domain_integrator("diffusion").assemble("float64")
            return ConstrainedOperator.wrap(A.operator(), f.essential_dofs(),
                                            "float64", d)

        mg = make_h_multigrid(meshes, lambda m: spaces[id(m)], op,
                              ess_factory=lambda f: f.essential_dofs(),
                              dtype="float64", device=d)
        fes = spaces[id(meshes[-1])]
        A = op(fes)
        b = domain_lf(fes, None, dtype="float64", device=d) * A.mask
        x, info = cg(A.mult, b, M=mg.preconditioner(), rel_tol=1e-10, max_iter=200)
        assert info.converged
        runs.append((x, info.iterations))
    assert runs[0][1] == runs[1][1]
    assert _rel(runs[0][0].cpu(), runs[1][0]) <= 1e-10


def test_2d_poisson_cuda_equals_cpu(cuda, quad_extra_0):
    """Poisson on quads, triangles and curved quads at order 2 in float64
    on the card against the CPU: equal CG counts, 1e-10."""
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import (
        curve_mesh,
        make_cartesian_2d,
        make_cartesian_2d_tri,
    )
    from cardiac_ablation_ecm2_tpu_torch.models import poisson

    def warp(x):
        return np.stack([x[..., 0] + 0.05 * np.sin(np.pi * x[..., 1]),
                         x[..., 1] + 0.05 * np.sin(np.pi * x[..., 0])], axis=-1)

    for mesh in (make_cartesian_2d(16, 16), make_cartesian_2d_tri(16, 16),
                 curve_mesh(make_cartesian_2d(16, 16), warp, 2)):
        res = [poisson.solve(mesh, order=2, rel_tol=1e-10, dtype="float64",
                             device=d) for d in (cuda, "cpu")]
        assert res[0].iterations == res[1].iterations
        assert _rel(res[0].u.cpu(), res[1].u) <= 1e-10


def _small_restriction(dev):
    rng = np.random.default_rng(29)
    gm = rng.integers(0, 40, (9, 8))
    gm[1, :3] = 39
    return ElementRestriction(gm, 40, dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_restriction_functions_bitwise_equal_kernels(cuda, dtype):
    """Each direction's autograd Function: forward bitwise the kernel,
    backward bitwise the other direction's kernel, jvp bitwise the kernel
    on the tangent, on the cardiac hex n=8 order-2 map."""
    fes = FESpace(make_cardiac_hex_mesh(8), 2)
    r = ElementRestriction(fes.gather_map, fes.ndof, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda, dtype=dtype)
    ne, nd = r.ne, r.nd
    cases = (
        (r.mult, rnd(r.ndof), lambda x: bg.gather_sum(x, r.g).view(ne, nd),
         lambda g: bg.segment_sum(g.reshape(-1), r.slots, r.offsets)),
        (r.mult_t, rnd(r.ndof), lambda x: bg.gather_transpose(x, r.gm),
         lambda g: bg.segment_sum(g.reshape(-1), r.slotsT, r.offsets)),
        (r.mult_transpose, rnd(ne, nd),
         lambda x: bg.segment_sum(x.reshape(-1), r.slots, r.offsets),
         lambda g: bg.gather_sum(g, r.g).view(ne, nd)),
        (r.mult_transpose_t, rnd(nd, ne),
         lambda x: bg.segment_sum(x.reshape(-1), r.slotsT, r.offsets),
         lambda g: bg.gather_transpose(g, r.gm)),
    )
    bitwise = lambda a, b: torch.equal(a.view(torch.int64 if dtype == torch.float64
                                               else torch.int32),
                                       b.view(torch.int64 if dtype == torch.float64
                                              else torch.int32))
    for fn, x, kern, adj in cases:
        assert bitwise(fn(x), kern(x))
        xg = x.clone().requires_grad_(True)
        y = fn(xg)
        assert y.grad_fn is not None
        g = rnd(*y.shape)
        (gx,) = torch.autograd.grad(y, xg, g)
        assert bitwise(gx, adj(g))
        t = rnd(*x.shape)
        assert bitwise(torch.func.jvp(fn, (x,), (t,))[1], kern(t))


def test_restriction_grad_goes_through_kernels(cuda):
    """A gradient on CUDA tensors has a grad_fn and launches the kernels
    (a ``.sum()`` gradient arrives with stride 0 and is made contiguous)."""
    r = _small_restriction(cuda)
    u = torch.randn(40, device=cuda, dtype=torch.float64, requires_grad=True)
    before = bg.segment_sum.launches
    loss = r.mult(u).sum()
    assert loss.grad_fn is not None
    loss.backward()
    assert bg.segment_sum.launches == before + 1
    ones = torch.ones(r.ne * r.nd, device=cuda, dtype=torch.float64)
    assert torch.equal(u.grad, bg.segment_sum(ones, r.slots, r.offsets))


@pytest.mark.parametrize("op", ["mult", "mult_t", "mult_transpose", "mult_transpose_t"])
def test_restriction_gradcheck_cuda(cuda, op):
    r = _small_restriction(cuda)
    shape = {"mult": (40,), "mult_t": (40,), "mult_transpose": (9, 8),
             "mult_transpose_t": (8, 9)}[op]
    x = torch.randn(shape, device=cuda, dtype=torch.float64, requires_grad=True)
    f = getattr(r, op)
    assert torch.autograd.gradcheck(f, (x,), check_forward_ad=True)
    assert torch.autograd.gradgradcheck(f, (x,), check_fwd_over_rev=True)


def test_hyperelastic_and_wave_cuda_equal_cpu(cuda, quad_extra_0):
    """Newton on a small hyperelastic beam (equal Newton counts, CG counts
    within round-off) and three Newmark wave steps on a hex cube (equal
    counts), float64, card against CPU."""
    from cardiac_ablation_ecm2_tpu_torch.fem.gridfunction import project
    from cardiac_ablation_ecm2_tpu_torch.linalg.ode2 import select2
    from cardiac_ablation_ecm2_tpu_torch.models.hyperelastic import HyperelasticProblem
    from cardiac_ablation_ecm2_tpu_torch.models.wave import WaveOperator, make_stepper

    fes = FESpace(make_cartesian_3d(8, 1, 1, sx=8.0), 2, vdim=3)
    runs = [HyperelasticProblem(fes=fes, fixed_bdr=(5,), force_bdr=(3,),
                                force=np.array([1e-2, 0.0, 0.0]), dtype="float64",
                                device=d).solve() for d in (cuda, "cpu")]
    (ug, ig), (uc, ic) = runs
    # equal Newton counts; CG counts equal but for round-off, within 3 (a
    # step's count moves under a 1e-15 relative change of the tangent apply;
    # the card and the CPU have differed by at most 2)
    assert ig.converged and ig.iterations == ic.iterations
    assert len(ig.linear_iterations) == len(ic.linear_iterations)
    assert all(abs(a - b) <= 3
               for a, b in zip(ig.linear_iterations, ic.linear_iterations))
    assert _rel(ug.cpu(), uc) <= 1e-10
    wfes = FESpace(make_cartesian_3d(4, 4, 4), 2)
    out = []
    for d in (cuda, "cpu"):
        op = WaveOperator(wfes, rel_tol=1e-12, dtype="float64", device=d)
        step = make_stepper(op, select2("newmark"))
        u = project(wfes, lambda x: torch.sin(np.pi * x[..., 0]) * torch.sin(
            np.pi * x[..., 1]) * torch.sin(np.pi * x[..., 2]), "float64", d)
        v, t, counts = torch.zeros_like(u), 0.0, []
        for _ in range(3):
            u, v, t = step(u, v, t, 0.05)
            counts.append((op.mass_info.iterations, op.implicit_info.iterations))
        out.append((u.cpu(), counts))
    assert out[0][1] == out[1][1]
    assert _rel(out[0][0], out[1][0]) <= 1e-10


def _dg_vel(x):
    v = torch.zeros_like(x)
    v[..., 0], v[..., 1] = 1.0, 0.5
    if x.shape[-1] == 3:
        v[..., 2] = 0.25
    return v


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dg_face_route_kernels(cuda, dtype):
    """The DG applies on the card: every face read a take_rows launch, the
    sum into the elements one segment_sum launch; two applies bitwise
    equal; the route's reads and sums bitwise equal to their plain
    versions."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import L2FESpace
    from cardiac_ablation_ecm2_tpu_torch.ops import gather_probes as gp
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_advection import DGAdvection
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_diffusion import DGDiffusion

    fes = L2FESpace(make_cartesian_3d(4, 3, 3), 3)
    for op, apply in ((DGAdvection(fes, _dg_vel, dtype=dtype, device=cuda),
                       lambda o, u: o.mult(0.0, u)),
                      (DGDiffusion(fes, dtype=dtype, device=cuda), lambda o, u: o.mult(u))):
        u = torch.randn(fes.ndof, dtype=dtype, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(5))
        b = (gp.take_rows.launches, bg.segment_sum.launches)
        y1 = apply(op, u)
        y2 = apply(op, u)
        torch.cuda.synchronize()
        assert (gp.take_rows.launches - b[0], bg.segment_sum.launches - b[1]) == (6, 2)
        assert torch.equal(y1, y2)
        F = op.faces
        ue = u.view(fes.mesh.ne, -1)
        for g in range(1, 4):
            assert torch.equal(F.read(ue, g), gp.take_rows_plain(ue, F.idx[g]))
        parts = [torch.randn(len(F.idx[g]), fes.nd_elem, dtype=dtype, device=cuda)
                 for g in range(4)]
        slots, offsets = F.slots((True,) * 4)
        src = torch.cat([p.reshape(-1) for p in parts])
        assert torch.equal(F.sum(parts).reshape(-1),
                           bg.segment_sum_plain(src, slots, offsets))


def test_dg_cuda_equals_cpu(cuda):
    """Advection (RK3-SSP), SIPG and BR2 solves, DG elasticity, Burgers and
    Euler, IMEX advection–diffusion, the estimators, condensation and ex22
    on the card equal to the CPU, float64."""
    from cardiac_ablation_ecm2_tpu_torch.fem import estimators
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import L2FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d
    from cardiac_ablation_ecm2_tpu_torch.models.advection_diffusion import (
        DGAdvectionDiffusion,
    )
    from cardiac_ablation_ecm2_tpu_torch.ops.condense import (
        StaticCondensation,
        element_matrices,
    )
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_advection import DGAdvection, project_l2
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_diffusion import DGDiffusion, DGDiffusionBR2
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_elasticity import DGElasticity
    from cardiac_ablation_ecm2_tpu_torch.ops.hyperbolic import HyperbolicDG

    fes = L2FESpace(make_cartesian_3d(4, 4, 4), 2)
    fes2 = L2FESpace(make_cartesian_2d(6, 6), 2)
    out = []
    for d in (cuda, "cpu"):
        r = {}
        op = DGAdvection(fes, _dg_vel, dtype="float64", device=d)
        u = project_l2(fes, lambda x: torch.exp(-((x - 0.3) ** 2).sum(-1) / 0.01),
                       "float64", d)
        for _ in range(5):
            u, _ = ode.select("rk3_ssp").step(op, u, 0.0, 1e-3)
        r["adv"] = u
        for name, Op in (("sipg", DGDiffusion), ("br2", DGDiffusionBR2)):
            A = Op(fes2, dtype="float64", device=d)
            b = A.dirichlet_rhs(lambda x: torch.sin(x[..., 0]))
            dg = A.diagonal()
            x, info = cg(A.mult, b, M=lambda v: v / dg, rel_tol=1e-10, max_iter=2000)
            r[name] = (x, info.iterations)
        E = DGElasticity(fes2, lam=1.5, mu=0.8, dtype="float64", device=d)
        r["elast"] = E.mult(torch.linspace(-1, 1, E.ndof, dtype=torch.float64, device=d))
        for law in ("burgers", "euler"):
            H = HyperbolicDG(fes2, law=law, dtype="float64", device=d)
            q = torch.ones(fes2.ndof * H.nc, dtype=torch.float64, device=d)
            q = q + 0.1 * torch.sin(torch.arange(q.numel(), device=d, dtype=q.dtype))
            r[law] = H.mult(0.0, q)
        m = DGAdvectionDiffusion(fes2, _dg_vel, epsilon=1e-2, rel_tol=1e-12,
                                 dtype="float64", device=d)
        uu = project_l2(fes2, lambda x: torch.exp(-((x - 0.4) ** 2).sum(-1) / 0.02),
                        "float64", d)
        r["imex"] = (ode.select("imex_rk2").step(m, uu, 0.0, 0.01)[0],
                     list(m.cg_iterations))
        h1 = FESpace(make_cartesian_2d(5, 4), 2)
        uh = torch.as_tensor(np.sin(3 * h1.dof_coords[:, 0]), device=d)
        r["est"] = [torch.as_tensor(f(h1, uh)) for f in (
            estimators.zz_estimator, estimators.kelly_estimator,
            estimators.lszz_estimator)]
        hc = FESpace(make_cartesian_3d(2, 2, 2), 3)
        sc = StaticCondensation(hc, element_matrices(hc, 1.0, 0.5, dtype="float64",
                                                     device=d))
        r["cond"] = sc.mult(torch.linspace(0, 1, sc.n_iface, dtype=torch.float64,
                                           device=d))
        out.append(r)
    g, c = out
    assert _rel(g["adv"], c["adv"]) <= 1e-12
    for k in ("sipg", "br2"):
        assert abs(g[k][1] - c[k][1]) <= 3 and _rel(g[k][0], c[k][0]) <= 1e-10
    for k in ("elast", "burgers", "euler", "cond"):
        assert _rel(g[k], c[k]) <= 1e-12, k
    assert _rel(g["imex"][0], c["imex"][0]) <= 1e-10
    assert all(abs(a - b) <= 3 for a, b in zip(g["imex"][1], c["imex"][1]))
    for a, b in zip(g["est"], c["est"]):
        assert _rel(a, b) <= 1e-10


def test_sharded_dg_world1_nccl_equals_serial(cuda):
    """parallel/dg at world size 1 over NCCL: the advection apply and the
    SIPG solve equal the serial operators' on the card."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import L2FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_advection import DGAdvection
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_diffusion import DGDiffusion
    from cardiac_ablation_ecm2_tpu_torch.parallel import dg as pdg
    from cardiac_ablation_ecm2_tpu_torch.parallel import launch

    fes = L2FESpace(make_cartesian_3d(3, 3, 3), 2)
    u = torch.linspace(-1, 1, fes.ndof, dtype=torch.float64)

    def body(rank, world, dev):
        a = pdg.setup(fes, _dg_vel, dtype="float64", device=dev)
        s = pdg.setup_sipg(fes, dtype="float64", device=dev,
                           f_rhs=lambda x: torch.ones(x.shape[:-1], dtype=x.dtype))
        x, info = s.solve(rel_tol=1e-10)
        return a.mult(0.0, a.scatter(u)).cpu(), x.cpu(), info.iterations

    y, x, its = launch.run_single(body)
    ser = DGAdvection(fes, _dg_vel, dtype="float64", device=cuda)
    assert torch.equal(y, ser.mult(0.0, u.to(cuda)).cpu())
    D = DGDiffusion(fes, dtype="float64", device=cuda)
    from cardiac_ablation_ecm2_tpu_torch.fem.build import basis_for, geom_factors_for
    from cardiac_ablation_ecm2_tpu_torch.fem.quadinterp import eval_values_t

    gf = geom_factors_for(fes, None, "float64", cuda)
    b = eval_values_t(basis_for(fes, "float64", cuda), gf.wdet).reshape(-1)
    dg = D.diagonal()
    xs, info = cg(D.mult, b, M=lambda v: v / dg, rel_tol=1e-10)
    assert its == info.iterations and torch.equal(x, xs.cpu())


def _all_layouts_bitwise(r, dev, seed):
    """Every kernel and layout of the restriction ``r`` bitwise its plain
    version, float32 and float64; each kernel launched."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for dtype in (torch.float32, torch.float64):
        u = torch.randn(r.ndof, generator=gen, device=dev, dtype=dtype)
        ue = torch.randn(r.ne * r.nd, generator=gen, device=dev, dtype=dtype)
        before = {k: getattr(bg, k).launches
                  for k in ("gather_sum", "gather_transpose", "segment_sum")}
        pairs = [(bg.gather_sum(u, r.g), bg.gather_sum_plain(u, r.g)),
                 (bg.gather_transpose(u, r.gm), bg.gather_transpose_plain(u, r.gm)),
                 (bg.segment_sum(ue, r.slots, r.offsets),
                  bg.segment_sum_plain(ue, r.slots, r.offsets)),
                 (bg.segment_sum(ue, r.slotsT, r.offsets),
                  bg.segment_sum_plain(ue, r.slotsT, r.offsets))]
        for got, want in pairs:
            assert torch.equal(_bits(got), _bits(want))
        assert all(getattr(bg, k).launches > n for k, n in before.items())


def test_vector_fe_maps_bitwise(cuda):
    """The ND, RT, tensor-HO and simplex gather maps, the AMS edge and face
    maps and the discrete curl's map, every kernel and layout."""
    from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector as fv
    from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector_ho as ho
    from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector_simplex as sx
    from cardiac_ablation_ecm2_tpu_torch.linalg.ams import EdgeTransfer, FaceTransfer
    from cardiac_ablation_ecm2_tpu_torch.ops.vecfe import discrete_curl

    hexes = make_cardiac_hex_mesh(6, lengths=(0.04, 0.04, 0.02), electrode_radius=0.004)
    tets = make_cartesian_3d_tet(4, 3, 3)
    nd, rt, h1 = fv.NDSpace(hexes), fv.RTSpace(hexes), FESpace(hexes, 1)
    maps = [ElementRestriction(s.gather_map, s.ndof, cuda) for s in (
        nd, rt, ho.NDSpaceHO(hexes, 2), ho.RTSpaceHO(hexes, 3),
        sx.NDSimplexSpace(tets, 3), sx.RTSimplexSpace(tets, 2))]
    maps += [EdgeTransfer(nd, h1, torch.float64, cuda).restr,
             FaceTransfer(hexes, h1, torch.float64, cuda).restr,
             discrete_curl(nd, rt, device=cuda).restr]
    for i, r in enumerate(maps):
        _all_layouts_bitwise(r, cuda, 500 + i)


def test_ams_pcg_cuda_equals_cpu(cuda):
    """ex3's --ams problem over the 2³ → 8³ hierarchy in float64: AMS's CG
    count equal on the card and the CPU and its iterate within 1e-10;
    Jacobi's ~117 steps to 1e-10 sit in CG's round-off regime (116 on the
    card against 118 on the CPU, measured), so its count is held within 3
    and its iterate within 1e-7; the card's solves launch the restriction
    kernels."""
    from cardiac_ablation_ecm2_tpu_torch.examples.ex3_maxwell import (
        ams_rhs,
        hierarchy,
        masked_system,
    )
    from cardiac_ablation_ecm2_tpu_torch.fem.fe_vector import NDSpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.ams import make_ams
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.ops.vecfe import build_nd_operator, vecfe_linear_form

    meshes = hierarchy(8)
    nd, h1 = NDSpace(meshes[-1]), FESpace(meshes[-1], 1)
    bdr = sorted(set(meshes[-1].bdr_attributes.tolist()))
    out = []
    for dev in (cuda, torch.device("cpu")):
        kw = dict(dtype=torch.float64, device=dev)
        op = build_nd_operator(nd, 1.0, 1.0, **kw)
        A, dg, b = masked_system(op, nd.essential_dofs(None), vecfe_linear_form(op, ams_rhs))
        M = make_ams(nd, h1, A, dg, ess_bdr=bdr, meshes=meshes, **kw)
        before = bg.segment_sum.launches
        xj, ij = cg(A, b, M=lambda r: r / dg, rel_tol=1e-10, max_iter=4000)
        xa, ia = cg(A, b, M=M, rel_tol=1e-10, max_iter=500)
        out.append((xj.cpu(), xa.cpu(), ij.iterations, ia.iterations,
                    bg.segment_sum.launches - before))
    (gj, ga, gij, gia, launched), (cj, ca, cij, cia, _) = out
    assert gia == cia and abs(gij - cij) <= 3 and gia < gij
    assert launched >= 5 * (gia + 1) + gij + 1
    for g, c, tol in ((gj, cj, 1e-7), (ga, ca, 1e-10)):
        assert float((g - c).abs().max()) <= tol * float(c.abs().max())


def _pvecfe_rank(rank, world, dev, space):
    from cardiac_ablation_ecm2_tpu_torch.parallel import pvecfe

    pv = pvecfe.setup(space, mass_coeff=1.0, curlcurl_coeff=1.0,
                      rhs_fn=lambda x: np.stack([np.ones_like(x[..., 0]), x[..., 1],
                                                 x[..., 0]], axis=-1),
                      ess_bdr=sorted(set(space.mesh.bdr_attributes.tolist())),
                      rel_tol=1e-10, precond="ams", dtype="float64", device=dev)
    u, its, _ = pv.solve()
    return u, its


def test_pvecfe_world1_nccl_equals_gloo(cuda):
    """parallel/pvecfe with the in-shard AMS at world size 1: NCCL on the
    card against gloo on the CPU, equal counts, u within 1e-10."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fe_vector import NDSpace
    from cardiac_ablation_ecm2_tpu_torch.parallel import launch

    space = NDSpace(make_cartesian_3d(6, 5, 4))
    ug, ig = launch.run_single(lambda r, w, d: _pvecfe_rank(r, w, d, space))
    uc, ic = launch.run_single(lambda r, w, d: _pvecfe_rank(r, w, d, space), "cpu")
    assert ig == ic
    assert np.abs(ug - uc).max() <= 1e-10 * np.abs(uc).max()


def _nc_hex(n=8):
    """The cardiac hex mesh n with the chip check's two electrode rounds."""
    from cardiac_ablation_ecm2_tpu_torch.mesh.ncmesh import make_nc, refine_hexes

    nc = make_nc(make_cardiac_hex_mesh(n))
    for r in (10.0, 7.0):
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        nc, _ = refine_hexes(nc, np.linalg.norm(cent - 20.0, axis=1) < r)
    return nc


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nc_prolongation_kernels(cuda, dtype):
    """NCFESpace's P and Pᵀ on the card: one gather-sum and one segment-sum
    launch each, bitwise their plain versions, and (float64) within
    1e-14·max of the CPU space's."""
    from cardiac_ablation_ecm2_tpu_torch.fem.ncfespace import (
        NCFESpace,
        prolongate_plain,
        restrict_t_plain,
    )

    nc = _nc_hex()
    sp, sh = NCFESpace(nc, 2, device=cuda), NCFESpace(nc, 2, device="cpu")
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.standard_normal(sp.ndof_conf), dtype=dtype)
    v = torch.as_tensor(rng.standard_normal(sp.fes.ndof_scalar), dtype=dtype)
    g0, s0 = bg.gather_sum.launches, bg.segment_sum.launches
    P, Pt = sp.prolongate(u.to(cuda)), sp.restrict_t(v.to(cuda))
    torch.cuda.synchronize()
    assert (bg.gather_sum.launches - g0, bg.segment_sum.launches - s0) == (1, 1)
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(P.view(bits), prolongate_plain(sp, u.to(cuda)).view(bits))
    assert torch.equal(Pt.view(bits), restrict_t_plain(sp, v.to(cuda)).view(bits))
    if dtype == torch.float64:
        for got, ref in ((P, sh.prolongate(u)), (Pt, sh.restrict_t(v))):
            assert (got.cpu() - ref).abs().max() <= 1e-14 * ref.abs().max()


def _nc_solve(sp, dev):
    """The masked PᵀAP Poisson solve of f = 1, u = 0 on the boundary, float64."""
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf

    A = BilinearForm(sp.fes, dev).add_domain_integrator("diffusion").assemble(
        dtype=torch.float64)
    AC = sp.constrained_operator(A.mult)
    m = torch.ones(sp.ndof_conf, dtype=torch.float64, device=dev)
    m[torch.as_tensor(sp.essential_dofs(), dtype=torch.long, device=dev)] = 0.0
    b = sp.restrict_t(domain_lf(sp.fes, None, dtype=torch.float64, device=dev)) * m
    x, info = cg(lambda y: AC(y * m) * m + y * (1 - m), b, rel_tol=1e-10,
                 max_iter=4000)
    return x.cpu().numpy(), info.iterations


@pytest.mark.parametrize("kind", ["hex", "tet"])
def test_nc_solve_cuda_equals_cpu(cuda, kind):
    """The constrained solve on an NC cardiac hex mesh (order 2) and an NC tet
    mesh (order 2, tri-face constraints): card against CPU, u within
    1e-10·max|u|, CG counts within 2."""
    from cardiac_ablation_ecm2_tpu_torch.fem.ncfespace import NCFESpace
    from cardiac_ablation_ecm2_tpu_torch.mesh.nctet import make_nc_tet, refine_tets_nc

    if kind == "hex":
        nc = _nc_hex(6)
    else:
        nc = make_nc_tet(make_cartesian_3d_tet(2, 2, 2))
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        nc, _ = refine_tets_nc(nc, np.linalg.norm(cent, axis=1) < 0.6)
    xg, ig = _nc_solve(NCFESpace(nc, 2, device=cuda), cuda)
    xc, ic = _nc_solve(NCFESpace(nc, 2, device="cpu"), "cpu")
    assert abs(ig - ic) <= 2
    assert np.abs(xg - xc).max() <= 1e-10 * np.abs(xc).max()


def _pnc_rank(rank, world, dev, nc):
    from cardiac_ablation_ecm2_tpu_torch.fem.ncfespace import NCFESpace
    from cardiac_ablation_ecm2_tpu_torch.parallel import pnc

    u, its, _ = pnc.setup(NCFESpace(nc, 2, device=dev), rel_tol=1e-10,
                          dtype="float64", device=dev).solve()
    return u, its


def test_pnc_world1_nccl_equals_gloo(cuda):
    """parallel/pnc at world size 1: NCCL on the card against gloo on the
    CPU, counts within 2, u within 1e-10·max|u|."""
    from cardiac_ablation_ecm2_tpu_torch.parallel import launch

    nc = _nc_hex(6)
    ug, ig = launch.run_single(lambda r, w, d: _pnc_rank(r, w, d, nc))
    uc, ic = launch.run_single(lambda r, w, d: _pnc_rank(r, w, d, nc), "cpu")
    assert abs(ig - ic) <= 2
    assert np.abs(ug - uc).max() <= 1e-10 * np.abs(uc).max()
