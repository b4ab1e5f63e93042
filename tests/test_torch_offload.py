"""The port's host-offloaded table (``cuembed_tpu_torch.offload``) against
``cuembed_tpu.offload.HostOffloadTable`` on the same numpy table and batches,
the cases of ``tests/test_offload.py``.

On the CPU the head lives on the CPU (``device="cpu"``) and the lookup is the
plain version of K1 on the head-and-shipped-rows buffer; the cold rows go
through the same ``native.offload_prepare`` (numpy here).

Tolerances: the lookup equals the port's lookup on the resident table bit
for bit (the same rows in the same order), and integer-valued tables with
integer gradients at lr = 0.5 keep the SGD step exact: bit for bit against
JAX. Random reals: the JAX tests' (rtol = 1e-5, atol = 1e-6; AdaGrad over two
steps rtol = 1e-4, atol = 1e-5 on the table).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuembed_tpu import CombineMode as JMode
from cuembed_tpu.offload import HostOffloadTable as JOffload

import cuembed_tpu_torch as tce
from cuembed_tpu_torch import CombineMode, HostOffloadTable
from cuembed_tpu_torch.utils.pipeline import InputPipeline

TOL = dict(rtol=1e-5, atol=1e-6)


def _setup(rng, V=1024, hot=256, W=16, B=32, H=4, integer=False):
    table = (rng.integers(-8, 9, (V, W)) if integer
             else rng.standard_normal((V, W))).astype(np.float32)
    # skew toward the head, but touch the tail too
    idx = np.where(rng.random((B, H)) < 0.7, rng.integers(0, hot, (B, H)),
                   rng.integers(hot, V, (B, H))).astype(np.int32)
    return table, idx, HostOffloadTable(table, hot, cold_cap=B * H, device="cpu"), \
        JOffload(table, hot, cold_cap=B * H)


@pytest.mark.parametrize("mode", [CombineMode.SUM, CombineMode.MEAN])
def test_offload_lookup_matches_resident(mode):
    rng = np.random.default_rng(0)
    table, idx, off, joff = _setup(rng)
    got = off.lookup(off.prepare(idx), mode=mode)
    # One lookup on the resident table with the same coefficients: same bits.
    coeff = None if mode == CombineMode.SUM else tce.combine_coefficients(
        None, mode, *idx.shape, device="cpu").view(idx.shape)
    resident = tce.embedding_lookup(torch.from_numpy(table), torch.from_numpy(idx), coeff)
    assert torch.equal(got, resident)
    want = joff.lookup(joff.prepare(idx), mode=JMode(mode.value))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_offload_lookup_weighted():
    rng = np.random.default_rng(1)
    table, idx, off, joff = _setup(rng)
    w = rng.standard_normal(idx.shape).astype(np.float32)
    got = off.lookup(off.prepare(idx, w))
    resident = tce.embedding_lookup(torch.from_numpy(table), torch.from_numpy(idx),
                                    torch.from_numpy(w))
    assert torch.equal(got, resident)
    np.testing.assert_allclose(got.numpy(), np.asarray(joff.lookup(joff.prepare(idx, w))),
                               **TOL)


@pytest.mark.parametrize("integer", [False, True])
def test_offload_sgd_matches_resident(integer):
    rng = np.random.default_rng(2)
    table, idx, off, joff = _setup(rng, integer=integer)
    gy = (rng.integers(-4, 5, (32, 16)) if integer
          else rng.standard_normal((32, 16))).astype(np.float32)
    lr = 0.5 if integer else 0.1
    off.sgd_update(off.prepare(idx), torch.from_numpy(gy), lr=lr)
    joff.sgd_update(joff.prepare(idx), jnp.asarray(gy), lr=lr)
    if integer:
        np.testing.assert_array_equal(off.full_table(), joff.full_table())
    else:
        np.testing.assert_allclose(off.full_table(), joff.full_table(), **TOL)


def test_offload_adagrad_matches_resident_two_steps():
    rng = np.random.default_rng(3)
    table, idx, off, joff = _setup(rng)
    gy = rng.standard_normal((32, 16)).astype(np.float32)
    off.adagrad_init()
    joff.adagrad_init()
    for _ in range(2):
        off.adagrad_update(off.prepare(idx), torch.from_numpy(gy), lr=0.1)
        joff.adagrad_update(joff.prepare(idx), jnp.asarray(gy), lr=0.1)
    np.testing.assert_allclose(off.full_table(), joff.full_table(), rtol=1e-4, atol=1e-5)
    got_a = np.concatenate([off.head_accum.numpy(), off.tail_accum])
    want_a = np.concatenate([np.asarray(joff.head_accum), joff.tail_accum])
    np.testing.assert_allclose(got_a, want_a, rtol=1e-4, atol=1e-6)


def test_offload_cold_cap_overflow_raises():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((1024, 16)).astype(np.float32)
    off = HostOffloadTable(table, 256, cold_cap=8, device="cpu")
    idx = np.arange(256, 256 + 64, dtype=np.int32).reshape(16, 4)
    with pytest.raises(ValueError, match="cold_cap"):
        off.prepare(idx)
    with pytest.raises(ValueError, match="hot_rows"):
        HostOffloadTable(table, 1024, device="cpu")
    batch = HostOffloadTable(table, 256, cold_cap=64, device="cpu").prepare(idx)
    with pytest.raises(ValueError, match="CONCAT"):
        off.lookup(batch, mode=CombineMode.CONCAT)
    with pytest.raises(ValueError, match="adagrad_init"):
        off.adagrad_update(batch, torch.zeros(16, 16), lr=0.1)


def test_offload_traffic_is_unique_cold_rows_only():
    """Shipped bytes scale with unique cold rows, not nnz or tail size:
    duplicated cold ids occupy one slot."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((100_000, 16)).astype(np.float32)
    off = HostOffloadTable(table, 256, cold_cap=8, device="cpu")
    idx = np.full((64, 4), 50_000, np.int32)
    batch = off.prepare(idx)
    assert batch.uniq_cold.shape[0] == 1 and tuple(batch.cold_rows.shape) == (8, 16)
    got = off.lookup(batch)
    want = JOffload(table, 256, cold_cap=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.lookup(want.prepare(idx))), **TOL)


def test_offload_pipeline_integration():
    """prepare() runs on the input-pipeline thread; the consumer only sees
    prepared batches, and they look up as on the main thread."""
    rng = np.random.default_rng(6)
    table, _, off, _ = _setup(rng)
    batches = [rng.integers(0, 1024, (32, 4)).astype(np.int32) for _ in range(4)]
    it = iter(batches)
    with InputPipeline(lambda: off.prepare(next(it)), depth=2) as pipe:
        for ids in batches:
            out = off.lookup(pipe.get())
            assert torch.equal(out, off.lookup(off.prepare(ids)))


def test_offload_bf16_head_ships_rows_in_its_dtype():
    rng = np.random.default_rng(7)
    table, idx, _, _ = _setup(rng)
    off = HostOffloadTable(table, 256, cold_cap=128, device="cpu",
                           device_dtype=torch.bfloat16)
    batch = off.prepare(idx)
    assert batch.cold_rows.dtype == torch.bfloat16
    resident = torch.from_numpy(table).to(torch.bfloat16)
    assert torch.equal(off.lookup(batch), tce.embedding_lookup(resident, torch.from_numpy(idx)))
