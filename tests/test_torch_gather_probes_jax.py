"""The port's ``take_along_rows`` and ``take_along_lanes`` on CPU tensors
(their plain versions) bitwise against the JAX package's Mosaic probes
themselves: the Pallas calls of ``benchmarks/gather_micro3.py:55`` (t1,
``kern0``), ``:88`` (t2, ``kern1``) and ``benchmarks/gather_micro4.py:46``
(u1, ``kernA``), ``:80`` (u2, ``kernW``), with their ``BlockSpec``s and
``pltpu.VMEM``, run in Pallas interpret mode at reduced shapes.  The probe
scripts run their probes when imported, so the calls are repeated here
rather than imported.  Gathers copy values, so every comparison is
bitwise.  float64 stays float64 in JAX: ``tests/conftest.py`` enables
x64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cardiac_ablation_ecm2_tpu_torch.ops import gather_probes as gp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these sizes gain nothing from more, and a
    parallel test run shares the cores between its workers; restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JNP = {np.float32: jnp.float32, np.float64: jnp.float64}


def _take0(t_ref, i_ref, o_ref):
    """``kern0`` (t1) and ``kernA`` (u1)."""
    o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:], axis=0)


def _take1(t_ref, i_ref, o_ref):
    """``kern1`` (t2) and ``kernW`` (u2)."""
    o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:], axis=1)


def _t1(table, idxp, blk):
    """t1: the whole table in every grid step, blk output rows a step."""
    R, C = table.shape
    nblk = idxp.shape[0] // blk
    return pl.pallas_call(
        _take0, grid=(nblk,),
        in_specs=[pl.BlockSpec((R, C), lambda i: (0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((blk, C), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((blk, C), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(idxp.shape, _JNP[table.dtype.type]),
        interpret=True)(table, idxp)


def _u1(table, idx):
    """u1: one call, both arrays whole in VMEM."""
    return pl.pallas_call(
        _take0, out_shape=jax.ShapeDtypeStruct(idx.shape, _JNP[table.dtype.type]),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(table, idx)


def _lanes(mat, idx, blk):
    """t2 (K = W) and u2 (K = W/8): blk rows of mat and idx a grid step."""
    W, K = mat.shape[1], idx.shape[1]
    return pl.pallas_call(
        _take1, grid=(mat.shape[0] // blk,),
        in_specs=[pl.BlockSpec((blk, W), lambda i: (i, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((blk, K), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((blk, K), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(idx.shape, _JNP[mat.dtype.type]),
        interpret=True)(mat, idx)


def _same(out: torch.Tensor, ref):
    ref = np.asarray(ref)
    out = out.numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert np.array_equal(out.view(np.uint8), np.ascontiguousarray(ref).view(np.uint8))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("R,C,B,blk", [(71, 128, 233, 16), (7, 8, 29, 8)])
def test_take_along_rows_equals_t1(dt, R, C, B, blk):
    """t1's form: idx padded with zero rows to whole output blocks."""
    rng = np.random.default_rng(R + B)
    table = rng.standard_normal((R, C)).astype(dt)
    idx = rng.integers(0, R, (B, C)).astype(np.int32)
    nblk = -(-B // blk)
    idxp = np.pad(idx, ((0, nblk * blk - B), (0, 0)))
    _same(gp.take_along_rows(torch.from_numpy(table), torch.from_numpy(idxp)),
          _t1(table, idxp, blk))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_take_along_rows_equals_u1(dt):
    """u1 at its own shape, (512, 128) from (512, 128)."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((512, 128)).astype(dt)
    idx = rng.integers(0, 512, (512, 128)).astype(np.int32)
    _same(gp.take_along_rows(torch.from_numpy(table), torch.from_numpy(idx)),
          _u1(table, idx))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("W,K,blk", [(128, 128, 16), (256, 32, 8), (512, 64, 8),
                                     (1024, 128, 8)])
def test_take_along_lanes_equals_t2_u2(dt, W, K, blk):
    """t2 (K = W = 128) and u2 at each of its widths (K = W/8), three
    blocks of rows (u2's blocks cut to ``blk`` rows)."""
    rng = np.random.default_rng(W + K)
    mat = rng.standard_normal((3 * blk, W)).astype(dt)
    idx = rng.integers(0, W, (3 * blk, K)).astype(np.int32)
    _same(gp.take_along_lanes(torch.from_numpy(mat), torch.from_numpy(idx)),
          _lanes(mat, idx, blk))
