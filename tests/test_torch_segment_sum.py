"""The restriction's transposing L→E and sorted segment-sum E→L (plain
versions, which CPU tensors take) against the JAX package's restrictions,
and FULL assembly's duplicate sum through the segment-sum.

* L→E into the (nd, ne) layout copies values: bitwise equal to JAX
  ``ElementRestriction.mult_t`` and ``FastElementRestriction.mult_t``.
* E→L against JAX ``mult_transpose`` / ``mult_transpose_t``: float64
  within 1e-13·max|y| and float32 within rtol/atol 1e-6 (JAX sums the
  element-major slot order, the transposed E→L here sums the (nd, ne)
  slot order, and the fast hex path adds its planes' sentinel zeros).
* The segment-sum adds in slot order with the first slot initialising:
  bitwise equal to a sequential sum written out, −0.0 kept, an empty
  segment +0.0; bitwise equal to the multiplicity planes' ``gather_sum``
  where no sum is an exact zero.
* FULL assembly's CSR is bitwise what the serial ``index_add_`` gave."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.fem.restriction import (
    ElementRestriction as JElementRestriction,
)
from cardiac_ablation_ecm2_tpu.fem.restriction import FastElementRestriction
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_hex_mesh as jhex
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_tet_mesh as jtet
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.fem.restriction import (
    ElementRestriction,
    scatter_planes,
    scatter_slots,
)
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import (
    make_cardiac_hex_mesh,
    make_cardiac_tet_mesh,
)
from cardiac_ablation_ecm2_tpu_torch.ops import bilinearform as tbf
from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg

L = 0.04
KW = dict(lengths=(L, L, L / 2), electrode_radius=0.004)
MESHES = {"hex": (jhex, make_cardiac_hex_mesh, 8),
          "tet": (jtet, make_cardiac_tet_mesh, 4)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SPACES = {}


def _spaces(kind):
    """(JAX base restriction, JAX fast restriction, port restriction on
    the CPU) of one order-2 cardiac mesh, built once per mesh kind."""
    if kind not in _SPACES:
        jmake, tmake, n = MESHES[kind]
        jfes, tfes = JFESpace(jmake(n, **KW), 2), FESpace(tmake(n, **KW), 2)
        gm = np.asarray(jfes.gather_map)
        assert np.array_equal(gm, tfes.gather_map)
        _SPACES[kind] = (
            JElementRestriction.from_map(gm, jfes.ndof_scalar),
            FastElementRestriction.from_map(gm, jfes.ndof_scalar),
            ElementRestriction(tfes.gather_map, tfes.ndof_scalar, "cpu"))
    return _SPACES[kind]


def _sequential(src, slots, offsets):
    """The segment-sum written out in numpy, one segment at a time."""
    out = np.zeros(len(offsets) - 1, dtype=src.dtype)
    for i in range(len(out)):
        seg = src[slots[offsets[i]:offsets[i + 1]]]
        if len(seg):
            acc = seg[0]
            for v in seg[1:]:
                acc = acc + v
            out[i] = acc
    return out


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


@pytest.mark.parametrize("kind", ["hex", "tet"])
def test_gather_transpose_plain_equals_jax_mult_t(kind):
    jbase, jfast, r = _spaces(kind)
    u = np.random.default_rng(0).standard_normal(r.ndof).astype(np.float32)
    out = r.mult_t(torch.from_numpy(u))
    assert out.shape == (r.nd, r.ne) and out.is_contiguous()
    ju = jnp.asarray(u)
    assert np.array_equal(out.numpy(), np.asarray(jbase.mult_t(ju)))
    assert np.array_equal(out.numpy(), np.asarray(jfast.mult_t(ju)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gather_transpose_sentinel_and_shapes(dtype):
    """Index len(src) reads 0; (ne, nd) of a last partial tile."""
    rng = np.random.default_rng(1)
    src = rng.standard_normal(301).astype(dtype)
    g = rng.integers(0, 302, (1_037, 27)).astype(np.int32)
    out = bg.gather_transpose(torch.from_numpy(src), torch.from_numpy(g))
    ref = np.append(src, dtype(0))[g].T
    assert _bits(out.numpy()).tolist() == _bits(ref).tolist()


@pytest.mark.parametrize("dtype,layout", [(d, lay) for d in ("float32", "float64")
                                          for lay in ("ne_nd", "nd_ne")])
@pytest.mark.parametrize("kind", ["hex", "tet"])
def test_segment_sum_plain_matches_jax_mult_transpose(kind, dtype, layout):
    jbase, jfast, r = _spaces(kind)
    ue = np.random.default_rng(2).standard_normal((r.ne, r.nd)).astype(dtype)
    if layout == "ne_nd":
        out = r.mult_transpose(torch.from_numpy(ue)).numpy()
        refs = [jbase.mult_transpose(jnp.asarray(ue)),
                jfast.mult_transpose(jnp.asarray(ue))]
    else:
        ueT = np.ascontiguousarray(ue.T)
        out = r.mult_transpose_t(torch.from_numpy(ueT)).numpy()
        refs = [jbase.mult_transpose_t(jnp.asarray(ueT)),
                jfast.mult_transpose_t(jnp.asarray(ueT))]
    for ref in map(np.asarray, refs):
        assert out.dtype == ref.dtype
        if dtype == "float64":
            assert np.abs(out - ref).max() <= 1e-13 * np.abs(ref).max()
        else:
            assert np.allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segment_sum_sequential_signed_zero_and_empty(dtype):
    """A lone −0.0 stays −0.0, −0.0 + −0.0 + ... is −0.0, an empty segment
    is +0.0 (the multiplicity planes' sentinel made a lone −0.0 +0.0)."""
    rng = np.random.default_rng(3)
    flat = rng.integers(0, 60, 500)
    flat[flat == 7] = 8                      # dof 7: no slot
    flat[0] = 61                             # dof 61: slot 0 alone
    src = rng.standard_normal(500).astype(dtype)
    slots, offsets = scatter_slots(flat, 64)  # dofs 60, 62, 63: no slot
    src[slots[offsets[3]:offsets[4]]] = -0.0  # dof 3: only −0.0
    src[0] = -0.0
    src[slots[offsets[5]]] = -0.0             # dof 5: −0.0 first
    out = bg.segment_sum(torch.from_numpy(src), torch.from_numpy(slots),
                         torch.from_numpy(offsets)).numpy()
    ref = _sequential(src, slots, offsets)
    assert _bits(out).tolist() == _bits(ref).tolist()
    assert out[3] == 0 and np.signbit(out[3]) and offsets[4] - offsets[3] > 1
    assert out[61] == 0 and np.signbit(out[61])
    empty = out[[7, 60, 62, 63]]
    assert not empty.any() and not np.signbit(empty).any()
    planes = bg.gather_sum(torch.from_numpy(src),
                           torch.from_numpy(scatter_planes(flat, 64))).numpy()
    assert planes[61] == 0 and not np.signbit(planes[61])


def test_restriction_dofs_without_slot():
    gm = np.array([[0, 2, 3], [3, 2, 5]])
    r = ElementRestriction(gm, 8, "cpu")
    y = r.mult_transpose(torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]))
    assert y.tolist() == [1.0, 0.0, 7.0, 7.0, 0.0, 6.0, 0.0, 0.0]
    yT = r.mult_transpose_t(torch.tensor([[1.0, 4.0], [2.0, 5.0], [3.0, 6.0]]))
    assert yT.tolist() == y.tolist()


def test_tet_segment_sum_full_multiplicity_equals_planes():
    """The tet space's E→L at its full multiplicity (every level of the
    widest dof) against the sentinel planes' gather_sum, both layouts,
    float64: bitwise, since no random sum is an exact zero."""
    _, _, r = _spaces("tet")
    ne, nd = r.ne, r.nd
    gm = r.gm.numpy()
    ue = torch.from_numpy(np.random.default_rng(4).standard_normal(ne * nd))
    counts = np.diff(r.offsets.numpy())
    assert counts.max() == np.bincount(gm.reshape(-1)).max() > 8
    for flat, fn, shape in ((gm.reshape(-1), r.mult_transpose, (ne, nd)),
                            (gm.T.reshape(-1), r.mult_transpose_t, (nd, ne))):
        planes = torch.from_numpy(scatter_planes(flat, r.ndof))
        assert planes.shape[0] == counts.max()
        assert torch.equal(fn(ue.view(shape)), bg.gather_sum(ue, planes))


def _index_add(keys, vals):
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    out = torch.zeros(len(uniq), dtype=vals.dtype)
    out.index_add_(0, inv, vals)
    return uniq, out


def test_sum_duplicates_equals_serial_index_add():
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 3_000, 40_000))
    vals = torch.from_numpy(rng.standard_normal(40_000))
    uniq, sums = tbf.sum_duplicates(keys, vals)
    ruq, ref = _index_add(keys, vals)
    assert torch.equal(uniq, ruq)
    assert torch.equal(sums.view(torch.int64), ref.view(torch.int64))


@pytest.mark.parametrize("kind,coeff", [("mass", 3.6e6), ("diffusion", 0.54)])
def test_full_assembly_bitwise_equals_index_add(monkeypatch, kind, coeff):
    fes = FESpace(make_cardiac_tet_mesh(4, **KW), 2)

    def assemble():
        return tbf.BilinearForm(fes, "cpu").add_domain_integrator(
            kind, coeff).assemble_matrix()

    A = assemble()
    monkeypatch.setattr(tbf, "sum_duplicates", _index_add)
    B = assemble()
    for name in ("indptr", "indices", "data"):
        assert np.array_equal(_bits(getattr(A, name)) if name == "data"
                              else getattr(A, name),
                              _bits(getattr(B, name)) if name == "data"
                              else getattr(B, name))
