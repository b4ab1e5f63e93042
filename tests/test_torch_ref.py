"""The port's numpy golden models (``cuembed_tpu_torch/ref``) against the
JAX package's (``cuembed_tpu/ref``) on the same seeded inputs: every
function's result equal bit for bit (dtype, shape and values).

Covered: the forward over fixed and CSR layouts, SUM, weighted SUM, MEAN
and CONCAT, fp32, fp16 and bf16 tables with and without low-precision math,
zero-hotness samples; the backward, full and compressed, weighted and not,
with ``skip_grad_init``; the row-id extractions, the transpose (weighted
and not) and the compressed-index remap, with the reference's 4-nnz
fixture among them.
"""

import ml_dtypes
import numpy as np
import pytest

import cuembed_tpu.ref as jref
from cuembed_tpu.types import CombineMode as JMode

import cuembed_tpu_torch.ref as tref
from cuembed_tpu_torch import CombineMode

DTYPES = {"fp32": np.float32, "fp16": np.float16, "bf16": ml_dtypes.bfloat16}


def _same(got, want):
    if want is None:
        assert got is None
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _fixed(rng, dtype, batch=12, hotness=5, rows=40, width=7):
    table = rng.standard_normal((rows, width)).astype(dtype)
    idx = rng.integers(0, rows, (batch, hotness)).astype(np.int32)
    w = rng.random((batch, hotness)).astype(np.float32)
    return table, idx, w


def _csr(rng, dtype, batch=12, hotness=5, rows=40, width=7):
    table = rng.standard_normal((rows, width)).astype(dtype)
    per = rng.integers(0, hotness + 1, batch)
    per[3] = 0  # a zero-hotness sample
    offsets = np.concatenate([[0], np.cumsum(per)]).astype(np.int32)
    idx = rng.integers(0, rows, int(offsets[-1])).astype(np.int32)
    w = rng.random(idx.shape[0]).astype(np.float32)
    return table, idx, offsets, w


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("lpm", [False, True])
@pytest.mark.parametrize("mode", ["sum", "sum_w", "mean", "concat"])
def test_forward_fixed_bits(dtype, lpm, mode):
    rng = np.random.default_rng(0)
    table, idx, w = _fixed(rng, DTYPES[dtype])
    m = mode.removesuffix("_w")
    w = w if mode == "sum_w" else None
    got = tref.embedding_forward_ref(table, idx, weights=w, mode=CombineMode(m),
                                     low_precision_math=lpm)
    want = jref.embedding_forward_ref(table, idx, weights=w, mode=JMode(m),
                                      low_precision_math=lpm)
    _same(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("lpm", [False, True])
@pytest.mark.parametrize("mode", ["sum", "sum_w", "mean"])
def test_forward_csr_bits(dtype, lpm, mode):
    rng = np.random.default_rng(1)
    table, idx, offsets, w = _csr(rng, DTYPES[dtype])
    m = mode.removesuffix("_w")
    w = w if mode == "sum_w" else None
    got = tref.embedding_forward_ref(table, idx, offsets=offsets, weights=w,
                                     mode=CombineMode(m), low_precision_math=lpm)
    want = jref.embedding_forward_ref(table, idx, offsets=offsets, weights=w,
                                      mode=JMode(m), low_precision_math=lpm)
    _same(got, want)


def test_forward_errors_match():
    table, idx = np.zeros((4, 2), np.float32), np.zeros((2, 2), np.int32)
    for fn, mode in ((tref.embedding_forward_ref, CombineMode),
                     (jref.embedding_forward_ref, JMode)):
        with pytest.raises(ValueError, match="weights are only supported"):
            fn(table, idx, weights=np.ones((2, 2)), mode=mode.MEAN)
        with pytest.raises(ValueError, match="CONCAT"):
            fn(table, idx.reshape(-1), offsets=np.array([0, 2, 4]), mode=mode.CONCAT)
        with pytest.raises(ValueError, match="flat"):
            fn(table, idx, offsets=np.array([0, 2, 4]))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "fp16"])
def test_backward_bits(weighted, compressed, dtype):
    rng = np.random.default_rng(2)
    nnz, rows, width, batch = 60, 25, 6, 12
    idx = rng.integers(0, rows, nnz).astype(np.int32)
    sid = rng.integers(0, batch, nnz).astype(np.int32)
    w = rng.random(nnz).astype(np.float32) if weighted else None
    t_idx, t_sid, t_w = jref.transpose_ref(sid, idx, w)
    gy = rng.standard_normal((batch, width)).astype(DTYPES[dtype])
    remap = jref.compute_compressed_grad_indices_ref(t_idx) if compressed else None
    n_rows = int(remap[-1]) + 1 if compressed else rows
    kw = dict(transpose_remapped_indices=remap, transpose_weights=t_w)
    got = tref.embedding_backward_ref(gy, n_rows, t_idx, t_sid, **kw)
    want = jref.embedding_backward_ref(gy, n_rows, t_idx, t_sid, **kw)
    _same(got[0], want[0])
    _same(got[1], want[1])
    # Accumulating into a given gradient.
    init = rng.standard_normal((n_rows, width)).astype(DTYPES[dtype])
    got = tref.embedding_backward_ref(gy, n_rows, t_idx, t_sid, skip_grad_init=True,
                                      grad_out=init.copy(), **kw)
    want = jref.embedding_backward_ref(gy, n_rows, t_idx, t_sid, skip_grad_init=True,
                                       grad_out=init.copy(), **kw)
    _same(got[0], want[0])


@pytest.mark.parametrize("weighted", [False, True])
def test_transforms_bits(weighted):
    rng = np.random.default_rng(3)
    batch, hotness, rows = 9, 4, 30
    _same(tref.extract_row_ids_from_fixed_ref(batch, hotness),
          jref.extract_row_ids_from_fixed_ref(batch, hotness))
    _same(tref.extract_row_ids_from_fixed_ref(batch, hotness, np.int64),
          jref.extract_row_ids_from_fixed_ref(batch, hotness, np.int64))
    offsets = np.concatenate([[0], np.cumsum(rng.integers(0, 5, batch))]).astype(np.int32)
    _same(tref.extract_row_ids_from_csr_ref(offsets), jref.extract_row_ids_from_csr_ref(offsets))
    _same(tref.extract_row_ids_for_concat_ref(17), jref.extract_row_ids_for_concat_ref(17))
    nnz = int(offsets[-1])
    idx = rng.integers(0, rows, nnz).astype(np.int32)
    sid = tref.extract_row_ids_from_csr_ref(offsets)
    w = rng.choice([0.25, 0.5, 1.0], nnz).astype(np.float32) if weighted else None
    for g, j in zip(tref.transpose_ref(sid, idx, w), jref.transpose_ref(sid, idx, w)):
        _same(g, j)
    t_idx = jref.transpose_ref(sid, idx, w)[0]
    _same(tref.compute_compressed_grad_indices_ref(t_idx),
          jref.compute_compressed_grad_indices_ref(t_idx))


def test_reference_fixture():
    """The reference's 4-nnz transpose fixture (``tests/test_embedding_
    transpose.cu``), as ``tests/test_transforms_golden.py`` holds JAX to it."""
    idx = np.array([1, 3, 0, 4], np.int32)
    sid = np.array([0, 0, 1, 1], np.int32)
    w = np.array([1.0, 0.5, 1.0, 0.5], np.float32)
    t_idx, t_sid, t_w = tref.transpose_ref(sid, idx, w)
    np.testing.assert_array_equal(t_idx, [0, 1, 3, 4])
    np.testing.assert_array_equal(t_sid, [1, 0, 0, 1])
    np.testing.assert_array_equal(t_w, [1.0, 1.0, 0.5, 0.5])
    np.testing.assert_array_equal(
        tref.compute_compressed_grad_indices_ref(np.array([0, 0, 2, 2, 5], np.int32)),
        [0, 0, 1, 1, 2])
