"""The port's sorted-COO backward (the plain version, and K3's CPU route)
against ``embedding_backward_xla`` / ``embedding_backward_compressed_xla``,
the Pallas kernel in interpret mode and the numpy golden model
``cuembed_tpu/ref/backward.py``.

Inputs are made with numpy from a seed. Integer-valued data keeps every
partial sum exact, so those comparisons are bitwise; on random reals the
port and XLA both add position by position in sorted order, and are held
to 1e-6 (fp32 sums of a few dozen terms in possibly another order).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuembed_tpu.ops.lookup_xla import (
    embedding_backward_compressed_xla,
    embedding_backward_xla,
)
from cuembed_tpu.ops.pallas_backward import embedding_backward_pallas
from cuembed_tpu.ref import embedding_backward_ref

import cuembed_tpu_torch as tce
from cuembed_tpu_torch.ops import cuda_backward, dispatch
from cuembed_tpu_torch.utils import trace

SENT = 2**31 - 1

# The reference's fixture (tests/test_embedding_backward.cu:161-206), as in
# tests/test_backward_golden.py: width 4, 5 categories, a duplicate run.
NUM_CATEGORIES = 5
T_IDX = np.array([0, 1, 3, 3], np.int32)
T_SID = {"sum": np.array([1, 0, 0, 1], np.int32),
         "concat": np.array([2, 0, 1, 3], np.int32)}
T_WEIGHTS = np.array([3.0, 1.0, 0.5, 3.0], np.float32)
GRAD_Y = {"sum": np.arange(1.0, 9.0, dtype=np.float32).reshape(2, 4),
          "concat": np.arange(1.0, 17.0, dtype=np.float32).reshape(4, 4)}
REF_FULL = {
    ("sum", False): [[5, 6, 7, 8], [1, 2, 3, 4], [0, 0, 0, 0], [6, 8, 10, 12], [0, 0, 0, 0]],
    ("sum", True): [[15, 18, 21, 24], [1, 2, 3, 4], [0, 0, 0, 0], [15.5, 19, 22.5, 26],
                    [0, 0, 0, 0]],
    ("concat", False): [[9, 10, 11, 12], [1, 2, 3, 4], [0, 0, 0, 0], [18, 20, 22, 24],
                        [0, 0, 0, 0]],
    ("concat", True): [[27, 30, 33, 36], [1, 2, 3, 4], [0, 0, 0, 0], [41.5, 45, 48.5, 52],
                       [0, 0, 0, 0]],
}


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("mode", ["sum", "concat"])
@pytest.mark.parametrize("weighted", [False, True])
def test_golden_full_and_compressed(mode, weighted):
    w = T_WEIGHTS if weighted else None
    full = tce.embedding_backward_torch(_t(GRAD_Y[mode]), NUM_CATEGORIES, _t(T_IDX),
                                        _t(T_SID[mode]), _t(w))
    np.testing.assert_array_equal(full.numpy(), np.array(REF_FULL[(mode, weighted)]))
    comp = tce.embedding_backward_compressed_torch(_t(GRAD_Y[mode]), _t(T_IDX),
                                                   _t(T_SID[mode]), _t(w))
    assert int(comp.num_unique) == 3
    np.testing.assert_array_equal(comp.rows.numpy()[:3],
                                  np.array(REF_FULL[(mode, weighted)])[[0, 1, 3]])
    np.testing.assert_array_equal(comp.unique_indices.numpy()[:3], [0, 1, 3])
    assert not comp.rows[3:].any() and not comp.unique_indices[3:].any()


def test_golden_padding_initial_grad_and_empty():
    pad_idx = np.concatenate([T_IDX, [SENT, SENT]]).astype(np.int32)
    pad_sid = np.concatenate([T_SID["sum"], [0, 1]]).astype(np.int32)
    got = tce.embedding_backward_torch(_t(GRAD_Y["sum"]), NUM_CATEGORIES, _t(pad_idx),
                                       _t(pad_sid), nnz=4)
    np.testing.assert_array_equal(got.numpy(), np.array(REF_FULL[("sum", False)]))
    init = torch.ones((NUM_CATEGORIES, 4))
    got = tce.embedding_backward_torch(_t(GRAD_Y["sum"]), NUM_CATEGORIES, _t(T_IDX),
                                       _t(T_SID["sum"]), initial_grad=init)
    assert got is init  # added into in place (skip_grad_init)
    np.testing.assert_array_equal(got.numpy(), np.array(REF_FULL[("sum", False)]) + 1.0)
    empty = tce.embedding_backward_compressed_torch(
        _t(GRAD_Y["sum"]), torch.full((4,), SENT, dtype=torch.int32),
        torch.zeros(4, dtype=torch.int32), nnz=0)
    assert int(empty.num_unique) == 0 and not empty.rows.any()
    assert not tce.embedding_backward_torch(
        _t(GRAD_Y["sum"]), NUM_CATEGORIES, torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32)).any()


def _sorted_coo(rng, n_live, cap, V, rows, index_dtype=np.int32):
    idx = np.full(cap, SENT, np.int64)
    idx[:n_live] = rng.integers(0, V, n_live)
    sid = np.zeros(cap, np.int32)
    sid[:n_live] = rng.integers(0, rows, n_live)
    order = np.argsort(idx, kind="stable")
    return idx[order].astype(index_dtype), sid[order]


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "reals"])
def test_full_matches_xla_and_golden_model(integer, weighted, index_dtype):
    rng = np.random.default_rng(83)
    V, W, rows, n_live, cap = 300, 16, 32, 200, 240
    t_idx, t_sid = _sorted_coo(rng, n_live, cap, V, rows, index_dtype)
    if integer:
        gy = rng.integers(-8, 9, (rows, W)).astype(np.float32)
        w = rng.choice([0.5, 1.0, 2.0], cap).astype(np.float32)
        init = rng.integers(-3, 4, (V, W)).astype(np.float32)
    else:
        gy = rng.standard_normal((rows, W)).astype(np.float32)
        w = rng.random(cap).astype(np.float32)
        init = rng.standard_normal((V, W)).astype(np.float32)
    w = w if weighted else None
    i32 = t_idx.astype(np.int32)
    for nnz, start in ((None, None), (n_live, None), (n_live - 10, init)):
        want = embedding_backward_xla(
            _j(gy), V, _j(i32), _j(t_sid), _j(w),
            nnz=None if nnz is None else jnp.int32(nnz),
            initial_grad=_j(start))
        got = tce.embedding_backward_torch(
            _t(gy), V, _t(t_idx), _t(t_sid), _t(w), nnz=nnz,
            initial_grad=None if start is None else _t(start.copy()))
        if integer:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # The numpy golden model over the live prefix.
    ref, _ = embedding_backward_ref(gy, V, t_idx[:n_live], t_sid[:n_live],
                                    transpose_weights=None if w is None else w[:n_live])
    got = tce.embedding_backward_torch(_t(gy), V, _t(t_idx), _t(t_sid), _t(w), nnz=n_live)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("nnz", [None, 200, 0], ids=["all", "prefix", "none"])
def test_compressed_matches_xla(nnz, weighted):
    """Every run of the live prefix counts, the sentinel's included when
    the prefix reaches it; padding rows are zero, padding indices 0."""
    rng = np.random.default_rng(89)
    V, W, rows, n_live, cap = 300, 16, 32, 200, 256
    t_idx, t_sid = _sorted_coo(rng, n_live, cap, V, rows)
    gy = rng.integers(-8, 9, (rows, W)).astype(np.float32)
    w = rng.choice([0.5, 1.0, 2.0], cap).astype(np.float32) if weighted else None
    want = embedding_backward_compressed_xla(
        _j(gy), _j(t_idx), _j(t_sid), _j(w), nnz=None if nnz is None else jnp.int32(nnz))
    got = tce.embedding_backward_compressed_torch(_t(gy), _t(t_idx), _t(t_sid), _t(w),
                                                  nnz=nnz)
    assert int(got.num_unique) == int(want.num_unique)
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.unique_indices.numpy(),
                                  np.asarray(want.unique_indices))


@pytest.mark.parametrize("live_cap", [256, 64], ids=["fits", "overflows"])
@pytest.mark.parametrize("compressed", [False, True])
def test_live_cap_changes_nothing(compressed, live_cap):
    rng = np.random.default_rng(97)
    V, W, rows, n_live, cap = 300, 16, 32, 200, 512
    t_idx, t_sid = _sorted_coo(rng, n_live, cap, V, rows)
    gy = rng.standard_normal((rows, W)).astype(np.float32)
    args = (_t(gy), _t(t_idx), _t(t_sid))
    if compressed:
        want = tce.embedding_backward_compressed_torch(*args, nnz=n_live)
        got = tce.embedding_backward_compressed_torch(*args, nnz=n_live, live_cap=live_cap)
        assert torch.equal(got.rows, want.rows)
        assert torch.equal(got.unique_indices, want.unique_indices)
        assert int(got.num_unique) == int(want.num_unique)
    else:
        want = tce.embedding_backward_torch(args[0], V, *args[1:], nnz=n_live)
        got = tce.embedding_backward_torch(args[0], V, *args[1:], nnz=n_live,
                                           live_cap=live_cap)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [np.float16, ml_dtypes.bfloat16])
def test_half_grad_y_matches_xla(dtype):
    """grad_y in a half type (low-precision math): both add in that type, in
    sorted order; integer-valued data below 2^8 keeps that exact."""
    rng = np.random.default_rng(5)
    V, W, rows, n_live, cap = 100, 8, 16, 120, 128
    t_idx, t_sid = _sorted_coo(rng, n_live, cap, V, rows)
    gy = rng.integers(-2, 3, (rows, W)).astype(np.float32)
    w = rng.choice([0.5, 1.0], cap).astype(np.float32)
    want = embedding_backward_xla(_j(gy.astype(dtype)), V, _j(t_idx), _j(t_sid), _j(w),
                                  nnz=jnp.int32(n_live))
    tdt = torch.float16 if dtype == np.float16 else torch.bfloat16
    got = tce.embedding_backward_torch(_t(gy).to(tdt), V, _t(t_idx), _t(t_sid), _t(w),
                                       nnz=n_live)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("dtype", [np.float16, ml_dtypes.bfloat16])
def test_half_sums_round_at_every_add(dtype, initial):
    """A half-typed grad_y adds position by position in its own type, as
    XLA's scatter-add does: runs of about 12 values near 1000 round at the
    adds, full and compressed, bit for bit with JAX."""
    rng = np.random.default_rng(4)
    V, W, rows, n_live, cap = 10, 8, 16, 120, 128
    t_idx, t_sid = _sorted_coo(rng, n_live, cap, V, rows)
    gy = (1000 + rng.integers(-3, 4, (rows, W))).astype(dtype)
    init = rng.integers(-9, 10, (V, W)).astype(dtype) if initial else None
    w = rng.choice([0.5, 1.0], cap).astype(np.float32)
    tdt = torch.float16 if dtype == np.float16 else torch.bfloat16

    def half(a):
        return None if a is None else torch.from_numpy(a.astype(np.float32)).to(tdt)
    want = embedding_backward_xla(_j(gy), V, _j(t_idx), _j(t_sid), _j(w),
                                  nnz=jnp.int32(n_live),
                                  initial_grad=None if init is None else _j(init))
    got = tce.embedding_backward_torch(half(gy), V, _t(t_idx), _t(t_sid), _t(w),
                                       nnz=n_live, initial_grad=half(init))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
    in_fp32 = tce.embedding_backward_torch(half(gy).float(), V, _t(t_idx), _t(t_sid),
                                           _t(w), nnz=n_live,
                                           initial_grad=None if init is None
                                           else half(init).float())
    assert not torch.equal(got, in_fp32.to(tdt))
    want_c = embedding_backward_compressed_xla(_j(gy), _j(t_idx), _j(t_sid), _j(w),
                                               nnz=jnp.int32(n_live))
    got_c = tce.embedding_backward_compressed_torch(half(gy), _t(t_idx), _t(t_sid),
                                                    _t(w), nnz=n_live)
    np.testing.assert_array_equal(got_c.rows.float().numpy(),
                                  np.asarray(want_c.rows).astype(np.float32))


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("dtype", [np.float16, ml_dtypes.bfloat16])
def test_dispatch_backward_sums_in_accumulation_dtype(dtype, backend):
    """dispatch.backward returns grad_y's dtype on every route; with fp32
    accumulation of a half grad_y it equals JAX's cast, fp32 sum, cast
    (runs of about 12 values near 1000, whose sums round in the half type),
    and without it the plain version in grad_y's dtype, which differs."""
    rng = np.random.default_rng(9)
    V, W, rows, n_live, cap = 10, 8, 16, 120, 128
    t_idx, t_sid = _sorted_coo(rng, n_live, cap, V, rows)
    gy = (1000 + rng.integers(-3, 4, (rows, W))).astype(np.float32)
    tdt = torch.float16 if dtype == np.float16 else torch.bfloat16
    half = _t(gy).to(tdt)
    want = embedding_backward_xla(_j(gy.astype(dtype)).astype(jnp.float32), V, _j(t_idx),
                                  _j(t_sid), None, nnz=jnp.int32(n_live)).astype(dtype)
    got = dispatch.backward(half, V, _t(t_idx), _t(t_sid), None, nnz=n_live,
                            backend=backend, accumulation_dtype=torch.float32)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
    in_half = dispatch.backward(half, V, _t(t_idx), _t(t_sid), None, nnz=n_live,
                                backend=backend)
    assert torch.equal(in_half, tce.embedding_backward_torch(half, V, _t(t_idx), _t(t_sid),
                                                             nnz=n_live))
    assert not torch.equal(in_half, got)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("batch,hotness,V,W", [
    (32, 8, 200, 128),
    (13, 5, 67, 256),
    (64, 3, 40, 128),   # heavy duplication (long runs)
])
def test_matches_pallas_kernel_in_interpret_mode(batch, hotness, V, W, weighted):
    """The shapes of tests/test_pallas_backward.py: the Pallas kernel K3
    replaces, run in interpret mode, bit for bit on integer data."""
    rng = np.random.default_rng(batch + W)
    idx = rng.integers(0, V, batch * hotness).astype(np.int32)
    sid = (np.arange(batch * hotness, dtype=np.int32) // hotness)
    order = np.argsort(idx, kind="stable")
    t_idx = np.concatenate([idx[order], np.full(7, SENT, np.int32)])
    t_sid = np.concatenate([sid[order], np.zeros(7, np.int32)])
    gy = rng.integers(-10, 11, (batch, W)).astype(np.float32)
    w = rng.choice([0.5, 0.25, 1.0], t_idx.shape[0]).astype(np.float32) if weighted else None
    want = embedding_backward_pallas(_j(gy), V, _j(t_idx), _j(t_sid), _j(w),
                                     interpret=True)
    got = tce.embedding_backward_torch(_t(gy), V, _t(t_idx), _t(t_sid), _t(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # K3's wrapper on CPU tensors takes the plain version.
    again = cuda_backward.embedding_backward_cuda(_t(gy), V, _t(t_idx), _t(t_sid), _t(w))
    assert torch.equal(again, got)


def test_kernel_wrappers_check_inputs_and_route_cpu_to_plain():
    rng = np.random.default_rng(2)
    t_idx, t_sid = _sorted_coo(rng, 50, 60, 40, 8)
    gy = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    i, s = _t(t_idx), _t(t_sid)
    launches = (trace.counters()["launch.k3_full"],
                trace.counters()["launch.k3_compressed"])
    got = cuda_backward.embedding_backward_cuda_compressed(gy, i, s, nnz=50)
    want = tce.embedding_backward_compressed_torch(gy, i, s, nnz=50)
    assert torch.equal(got.rows, want.rows) and int(got.num_unique) == int(want.num_unique)
    assert launches == (trace.counters()["launch.k3_full"],
                        trace.counters()["launch.k3_compressed"])
    with pytest.raises(ValueError, match="grad_y"):
        cuda_backward.embedding_backward_cuda(gy.double(), 40, i, s)
    with pytest.raises(ValueError, match="transpose_indices"):
        cuda_backward.embedding_backward_cuda(gy, 40, i.float(), s)
    with pytest.raises(ValueError, match="sample_ids"):
        cuda_backward.embedding_backward_cuda(gy, 40, i, s[:-1])
    with pytest.raises(ValueError, match="weights"):
        cuda_backward.embedding_backward_cuda(gy, 40, i, s, torch.ones(60).double())
    with pytest.raises(ValueError, match="initial_grad"):
        cuda_backward.embedding_backward_cuda(gy, 40, i, s, initial_grad=torch.zeros(40, 5))
    with pytest.raises(ValueError, match="must be on"):
        cuda_backward.embedding_backward_cuda(gy, 40, i, s.to("meta"))
