"""The port's gather-sum (plain version, which CPU tensors take) against the
JAX block-gather Pallas kernel in interpret mode, and the port's
ElementRestriction against JAX's FastElementRestriction, in float32.

Gathers copy values, so they must agree bitwise.  Sums are held to rtol
1e-6: when the JAX tables exceed their per-row block limit the JAX E→L
falls back to a scan whose additions run in another order, which moves f32
sums by a few ulps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cardiac_ablation_ecm2_tpu.fem import FESpace as JFESpace
from cardiac_ablation_ecm2_tpu.fem.restriction import FastElementRestriction
from cardiac_ablation_ecm2_tpu.mesh.cardiac import make_cardiac_hex_mesh as jmake
from cardiac_ablation_ecm2_tpu.ops import block_gather as jbg
from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
from cardiac_ablation_ecm2_tpu_torch.fem.restriction import (
    ElementRestriction,
    scatter_planes,
)
from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg

L = 0.04


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("J", [1, 8])
def test_gather_sum_random_with_sentinel(J):
    rng = np.random.default_rng(3)
    nsrc, nout = 731, 4097
    g = rng.integers(0, nsrc + 1, (J, nout))      # nsrc = zero sentinel
    src = rng.standard_normal(nsrc).astype(np.float32)
    t = jbg.build_tables(list(g) if J > 1 else g[0], nsrc)
    ref = np.asarray(jbg.apply(jnp.asarray(src), t, interpret=True))
    out = bg.gather_sum(torch.from_numpy(src),
                        torch.from_numpy(g.astype(np.int32))).numpy()
    if J == 1:
        assert np.array_equal(out, ref)
    else:
        assert np.allclose(out, ref, rtol=1e-6, atol=1e-6)
    # the sequential plain sum, written out
    pad = np.append(src, np.float32(0))
    seq = pad[g[0]]
    for j in range(1, J):
        seq = seq + pad[g[j]]
    assert np.array_equal(out, seq)


def test_cpu_takes_plain_version_without_launch():
    src = torch.arange(5, dtype=torch.float64)
    idx = torch.tensor([[4, 5, 0], [1, 1, 5]], dtype=torch.int32)
    before = bg.gather_sum.launches
    out = bg.gather_sum(src, idx)
    assert bg.gather_sum.launches == before
    assert out.tolist() == [5.0, 1.0, 0.0]


@pytest.mark.parametrize("bad", ["int64_idx", "1d_idx", "meta_device"])
def test_gather_sum_rejects(bad):
    src = torch.zeros(4)
    idx = torch.zeros((1, 3), dtype=torch.int32)
    if bad == "int64_idx":
        idx = idx.long()
    elif bad == "1d_idx":
        idx = idx[0]
    else:
        src, idx = src.to("meta"), idx.to("meta")
    with pytest.raises(ValueError):
        bg.gather_sum(src, idx)


def test_scatter_planes_sum_every_slot_once():
    rng = np.random.default_rng(1)
    flat = rng.integers(0, 50, 400)
    planes = scatter_planes(flat, 53)              # dofs 50..52 have no slot
    assert planes.shape == (np.bincount(flat).max(), 53)
    slots = planes[planes < flat.size]
    assert np.array_equal(np.sort(slots), np.arange(flat.size))
    assert np.all(flat[planes[0][:50]] == np.arange(50))
    assert np.all(planes[:, 50:] == flat.size)


def test_restriction_matches_fast_element_restriction():
    jfes = JFESpace(jmake(8, lengths=(L, L, L / 2), electrode_radius=0.004), 2)
    tfes = FESpace(make_cardiac_hex_mesh(8, lengths=(L, L, L / 2),
                                         electrode_radius=0.004), 2)
    gm = np.asarray(jfes.gather_map)
    assert np.array_equal(gm, tfes.gather_map)
    ne, nd = gm.shape
    fast = FastElementRestriction.from_map(gm, jfes.ndof_scalar)
    r = ElementRestriction(tfes.gather_map, tfes.ndof_scalar, "cpu")

    rng = np.random.default_rng(0)
    u = rng.standard_normal(tfes.ndof_scalar).astype(np.float32)
    ue = rng.standard_normal((ne, nd)).astype(np.float32)
    tu, tue = torch.from_numpy(u), torch.from_numpy(ue)

    assert np.array_equal(r.mult(tu).numpy(), np.asarray(fast.mult(jnp.asarray(u))))
    assert np.array_equal(r.mult_t(tu).numpy(),
                          np.asarray(fast.mult_t(jnp.asarray(u))))
    ref = np.asarray(fast.mult_transpose(jnp.asarray(ue)))
    assert np.allclose(r.mult_transpose(tue).numpy(), ref, rtol=1e-6, atol=1e-6)
    ueT = np.ascontiguousarray(ue.T)
    refT = np.asarray(fast.mult_transpose_t(jnp.asarray(ueT)))
    assert np.allclose(r.mult_transpose_t(torch.from_numpy(ueT)).numpy(), refT,
                       rtol=1e-6, atol=1e-6)
