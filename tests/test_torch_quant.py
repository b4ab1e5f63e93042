"""The port's int8 rows against ``cuembed_tpu.ops.quant``: the quantized
bytes, the whole-table int8 lookup, the tiered lookup with an int8 head
(``tiered_forward(q_head=...)``), and the refusal of gradients.

Inputs are made with numpy from a seed; the JAX package runs on the CPU.
Quantized bytes and extracted scales are compared exactly. Lookups: each
position's term is the same fp32 product in both packages, summed in
another order, so they agree to fp32 rounding (rtol = atol = 2e-5, as
``tests/test_quant.py``'s golden comparison); both also stay within the
documented bound of the exact lookup, ``sum of max|row| / 254`` per bag.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuembed_tpu as jce
from cuembed_tpu.ops import quant as jquant
from cuembed_tpu.ops import tiered as jtiered

import cuembed_tpu_torch as tce
from cuembed_tpu_torch.ops import quant as tquant
from cuembed_tpu_torch.ops.tiered import DEFAULT_HOT_BYTES, TieredConfig, int8_served
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
CFG = dict(hot_rows=512, chunk_elems=64, cold_slots=64, mxu_head_rows=64, mid_slots=64)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("pad", [4, 128])
def test_quantized_bytes_match_jax(pad, dtype):
    rng = np.random.default_rng(0)
    rows = (rng.standard_normal((64, 256)) * np.exp(rng.standard_normal((64, 1))))
    rows[5] = 0.0  # a zero row: scale 1
    rows = rows.astype(np.float32)
    if dtype == "bf16":
        rows = rows.astype(ml_dtypes.bfloat16).astype(np.float32)
    t = torch.from_numpy(rows)
    j = jnp.asarray(rows)
    if dtype == "bf16":
        t, j = t.bfloat16(), j.astype(jnp.bfloat16)
    got = tquant.quantize_rows(t, pad=pad)
    # As the JAX package runs it, under jit (quantize_head, the all-to-all
    # payload): XLA turns the division by 127 into a product by fp32(1/127).
    want = jax.jit(jquant.quantize_rows, static_argnames="pad")(j, pad=pad)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tquant.dequantize_rows(got, 256).numpy(),
                                  np.asarray(jquant.dequantize_rows(want, 256)))
    amax = np.abs(rows).max(axis=1, keepdims=True)
    deq = tquant.dequantize_rows(got, 256).numpy()
    assert (np.abs(deq - rows) <= amax / 254 + 1e-7).all()
    with pytest.raises(ValueError, match="4-byte"):
        tquant.quantize_rows(t, pad=3)


def test_quantize_head_carries_across():
    """quantize_head's bytes equal JAX's, a JAX QuantizedHead comes across
    through from_numpy, and the scales decode exactly."""
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((40, 128)).astype(np.float32)
    jq = jquant.quantize_head(jnp.asarray(rows))
    tq = tquant.quantize_head(torch.from_numpy(rows))
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    assert (tq.rows, tq.width) == (jq.rows, jq.width)
    back = tquant.QuantizedHead.from_numpy(np.asarray(jq.data), device="cpu")
    assert torch.equal(back.data, tq.data)
    np.testing.assert_array_equal(tquant.extract_scales(tq.data).numpy(),
                                  np.asarray(jquant.extract_scales(jq.data)))
    np.testing.assert_array_equal(tquant.dequant_rows(tq).numpy(),
                                  np.asarray(jquant.dequant_rows(jq)))
    with pytest.raises(ValueError, match="width % 128"):
        tquant.quantize_head(torch.zeros((4, 64)))
    with pytest.raises(ValueError, match="int8"):
        tquant.QuantizedHead.from_numpy(np.zeros((4, 200), np.float32), device="cpu")


def test_int8_head_rows_matches_jax():
    for width in (128, 256, 512):
        for budget in (1 << 10, 108 * 1024 * 1024, DEFAULT_HOT_BYTES):
            assert tquant.int8_head_rows(width, budget) == jquant.int8_head_rows(width,
                                                                                 budget)
    assert tquant.int8_head_rows(256, DEFAULT_HOT_BYTES) == 294_912


@pytest.mark.parametrize("mode", ["sum", "mean", "sum_w"])
def test_int8_serving_lookup_matches_jax(mode):
    rng = np.random.default_rng(30)
    V, W, B, H = 512, 256, 32, 8
    table = rng.standard_normal((V, W)).astype(np.float32)
    idx = rng.integers(0, V, (B, H))
    w = rng.standard_normal((B, H)).astype(np.float32) if mode == "sum_w" else None
    m = mode.removesuffix("_w")
    tq = tquant.quantize_head(torch.from_numpy(table))
    got = tquant.int8_serving_lookup(tq, torch.from_numpy(idx),
                                     None if w is None else torch.from_numpy(w),
                                     mode=tce.CombineMode(m))
    want = jquant.int8_serving_lookup(jquant.quantize_head(jnp.asarray(table)),
                                      jnp.asarray(idx.astype(np.int32)),
                                      None if w is None else jnp.asarray(w),
                                      mode=jce.CombineMode(m))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    exact = tce.embedding_lookup(torch.from_numpy(table), torch.from_numpy(idx),
                                 None if w is None else torch.from_numpy(w),
                                 mode=tce.CombineMode(m)).numpy()
    coeff = np.ones((B, H)) if w is None else np.abs(w)
    if m == "mean":
        coeff = coeff / H
    bound = (np.abs(table).max(axis=1)[idx] / 254.0 * coeff).sum(axis=1) + 1e-5
    assert (np.abs(got.numpy() - exact).max(axis=1) <= bound).all()


def _q_problem(rng, V, B, H, W, skew=3):
    table = rng.standard_normal((V, W)).astype(np.float32)
    idx = np.minimum((rng.random((B, H)) ** skew * V).astype(np.int64), V - 1)
    return table, idx


@pytest.mark.parametrize("case", ["sum", "mean", "sum_w", "overflow", "bf16"])
def test_tiered_int8_head_matches_jax(case):
    """tiered_forward(q_head=...) against the JAX engine: the int8 rows
    mixed in where JAX's fast path takes them, and, in a batch whose chunk
    overflows its slots, none (JAX serves it exactly)."""
    rng = np.random.default_rng(1)
    V, B, H, W = 4000, 64, 8, 256
    table, idx = _q_problem(rng, V, B, H, W, skew=1 if case == "overflow" else 3)
    slots = dict(mid_slots=8, cold_slots=8) if case == "overflow" else {}
    cfg = TieredConfig(**{**CFG, **slots})
    q_rows = 1024
    w = rng.standard_normal((B, H)).astype(np.float32) if case == "sum_w" else None
    m = "mean" if case == "mean" else "sum"
    tt = torch.from_numpy(table)
    jt = jnp.asarray(table)
    if case == "bf16":
        tt, jt = tt.bfloat16(), jt.astype(jnp.bfloat16)
    tq = tquant.quantize_head(tt[:q_rows])
    jq = jquant.quantize_head(jt[:q_rows])
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    got = tce.tiered_forward(tt, torch.from_numpy(idx),
                             None, None if w is None else torch.from_numpy(w),
                             mode=tce.CombineMode(m), cfg=cfg, q_head=tq)
    want = jtiered.tiered_forward(jt, jnp.asarray(idx.astype(np.int32)), None,
                                  None if w is None else jnp.asarray(w),
                                  mode=jce.CombineMode(m),
                                  cfg=jtiered.TieredConfig(**{**CFG, **slots}), q_head=jq)
    served = int8_served(torch.from_numpy(idx), cfg, q_rows)
    if case == "overflow":
        assert not served.any()  # uniform ids overflow the mid slots
        exact = tce.embedding_lookup(tt, torch.from_numpy(idx))
        np.testing.assert_allclose(got.numpy(), exact.numpy(), **TOL)
    else:
        assert served.any()
    tol = dict(rtol=2e-2, atol=2e-2) if case == "bf16" else TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    # Within the documented bound of the exact lookup.
    exact = tce.embedding_lookup(torch.from_numpy(table), torch.from_numpy(idx),
                                 None if w is None else torch.from_numpy(w),
                                 mode=tce.CombineMode(m)).numpy()
    coeff = np.ones((B, H)) if w is None else np.abs(w)
    if m == "mean":
        coeff = coeff / H
    amax = np.abs(table).max(axis=1)
    bound = (amax[idx] / 254 * coeff * served.numpy()).sum(axis=1) + 1e-4
    if case != "bf16":
        assert (np.abs(got.numpy() - exact).max(axis=1) <= bound).all()


def test_int8_served_matches_jax_overflow_predicate():
    """The chunk predicate on both sides of each slot bound."""
    cfg = TieredConfig(hot_rows=64, chunk_elems=16, cold_slots=3, mxu_head_rows=4,
                       mid_slots=5)
    base = np.zeros((2, 16), np.int64)  # head positions: count in no tier
    for mid, cold, overflow in ((5, 3, False), (6, 0, True), (0, 4, True), (5, 0, False)):
        idx = base.copy()
        idx[1, :mid] = 10  # mid tier (4 <= idx < 64)
        idx[1, mid:mid + cold] = 100  # past the int8 rows
        got = int8_served(torch.from_numpy(idx.reshape(4, 8)), cfg, 64)
        assert bool(got.any()) == (mid > 0 and not overflow)


def test_gradients_through_int8_raise():
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((512, 128)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 512, (32, 4)))
    cfg = TieredConfig(hot_rows=64, chunk_elems=128, cold_slots=128, mxu_head_rows=32,
                       mid_slots=128)
    qh = tquant.quantize_head(table[:128])
    t = table.clone().requires_grad_()
    out = tce.tiered_forward(t, idx, cfg=cfg, q_head=qh)
    with pytest.raises(NotImplementedError, match="serving-only"):
        out.square().sum().backward()
    with pytest.raises(NotImplementedError, match="serving-only"):
        tquant.quantize_head(t)
    with torch.no_grad():  # a serving snapshot of a trained table
        assert tquant.quantize_head(t).rows == 512
    assert tquant.quantize_head(t.detach()).rows == 512
