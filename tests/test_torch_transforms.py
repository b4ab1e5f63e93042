"""The port's index transforms against ``cuembed_tpu.ops.transforms`` and
the numpy golden model ``cuembed_tpu/ref/transforms.py``.

Inputs are made with numpy from a seed. Index transforms are integer
permutations and scans: every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuembed_tpu.ops import transforms as jt
from cuembed_tpu.ref import compute_compressed_grad_indices_ref, transpose_ref

from cuembed_tpu_torch.ops import transforms as tt

SENTINEL = 2**31 - 1


def test_transpose_golden():
    """The reference's 4-position fixture (test_embedding_transpose.cu)."""
    idx = np.array([1, 3, 0, 4], np.int32)
    sid = np.array([0, 0, 1, 1], np.int32)
    w = np.array([1.0, 0.5, 1.0, 0.5], np.float32)
    t_idx, t_sid, t_w = tt.transpose(*map(torch.from_numpy, (sid, idx, w)))
    np.testing.assert_array_equal(t_idx.numpy(), [0, 1, 3, 4])
    np.testing.assert_array_equal(t_sid.numpy(), [1, 0, 0, 1])
    np.testing.assert_array_equal(t_w.numpy(), [1.0, 1.0, 0.5, 0.5])
    assert tt.transpose(torch.from_numpy(sid), torch.from_numpy(idx))[2] is None


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("sid_order", ["unsorted", "nondecreasing"])
def test_transpose_matches_jax(sid_order, index_dtype, weighted):
    """A stable two-key sort on (index, sample id), for any sample ids, with
    duplicate (index, sample id) pairs; weights ride along."""
    rng = np.random.default_rng(7)
    n = 513
    idx = rng.integers(0, 37, n).astype(index_dtype)
    sid = rng.integers(0, 100, n).astype(np.int32)
    if sid_order == "nondecreasing":
        sid = np.sort(sid)
    w = rng.random(n).astype(np.float32) if weighted else None
    want = jt.transpose(jnp.asarray(sid), jnp.asarray(idx.astype(np.int32)),
                        None if w is None else jnp.asarray(w))
    got = tt.transpose(torch.from_numpy(sid), torch.from_numpy(idx),
                       None if w is None else torch.from_numpy(w))
    for g, wnt in zip(got, want):
        if wnt is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert got[0].dtype == torch.from_numpy(idx).dtype
    # The golden model breaks (index, sample id) ties on the weight: compare
    # the sorted keys exactly.
    r_idx, r_sid, _ = transpose_ref(sid, idx, w)
    np.testing.assert_array_equal(got[0].numpy(), r_idx)
    np.testing.assert_array_equal(got[1].numpy(), r_sid)
    if sid_order == "nondecreasing":
        fast = tt.transpose_position_ordered(
            torch.from_numpy(sid), torch.from_numpy(idx),
            None if w is None else torch.from_numpy(w))
        for g, f in zip(got, fast):
            assert (g is None and f is None) or torch.equal(g, f)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("slots", [56, 16], ids=["fits", "overflows"])
def test_transpose_masked_compact_matches_jax(slots, weighted):
    """Equal to the JAX function on every non-sentinel entry (its contract);
    the JAX fast path (slots fit) and its fallback (every chunk overflows)."""
    rng = np.random.default_rng(61)
    n, head, V, E = 1024, 40, 400, 64
    idx = rng.integers(0, V, n).astype(np.int32)
    masked = np.where(idx < head, SENTINEL, idx).astype(np.int32)
    sid = (np.arange(n) // 8).astype(np.int32)
    w = rng.standard_normal(n).astype(np.float32) if weighted else None
    want = jt.transpose_masked_compact(
        jnp.asarray(sid), jnp.asarray(masked), None if w is None else jnp.asarray(w),
        chunk_elems=E, nonhead_slots=slots)
    got = tt.transpose_masked_compact(
        torch.from_numpy(sid), torch.from_numpy(masked),
        None if w is None else torch.from_numpy(w), chunk_elems=E, nonhead_slots=slots)
    k = int((np.asarray(want[0]) != SENTINEL).sum())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, wnt in zip(got[1:], want[1:]):
        if wnt is not None:
            np.testing.assert_array_equal(g.numpy()[:k], np.asarray(wnt)[:k])


@pytest.mark.parametrize("weighted", [False, True])
def test_transpose_masked_compact_any_sample_order(weighted):
    """Sample ids that fall with the position: equal to the two-key
    transpose on every non-sentinel entry (its contract, for any COO)."""
    rng = np.random.default_rng(62)
    n, head, V = 1024, 40, 400
    idx = rng.integers(0, V, n).astype(np.int32)
    masked = np.where(idx < head, SENTINEL, idx).astype(np.int32)
    sid = rng.permutation(n).astype(np.int32) // 4
    w = rng.standard_normal(n).astype(np.float32) if weighted else None
    want = jt.transpose(jnp.asarray(sid), jnp.asarray(masked),
                        None if w is None else jnp.asarray(w))
    got = tt.transpose_masked_compact(
        torch.from_numpy(sid), torch.from_numpy(masked),
        None if w is None else torch.from_numpy(w), chunk_elems=64, nonhead_slots=56)
    k = int((masked != SENTINEL).sum())
    for g, wnt in zip(got, want):
        if wnt is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy()[:k], np.asarray(wnt)[:k])


@pytest.mark.parametrize("case", ["golden", "random", "single", "empty"])
def test_compressed_grad_indices_match_jax(case):
    rng = np.random.default_rng(3)
    sorted_idx = {
        "golden": np.array([0, 1, 3, 3], np.int32),
        "random": np.sort(rng.integers(0, 50, 300)).astype(np.int32),
        "single": np.array([5], np.int32),
        "empty": np.zeros(0, np.int32),
    }[case]
    got = tt.compute_compressed_grad_indices(torch.from_numpy(sorted_idx))
    np.testing.assert_array_equal(got.numpy(),
                                  compute_compressed_grad_indices_ref(sorted_idx))
    if sorted_idx.size:
        want = jt.compute_compressed_grad_indices(jnp.asarray(sorted_idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "golden":
        np.testing.assert_array_equal(got.numpy(), [0, 1, 2, 2])


@pytest.mark.parametrize("fill_value", [None, 0, SENTINEL])
def test_compact_sparse_indices_match_jax(fill_value):
    rng = np.random.default_rng(4)
    sorted_idx = np.sort(rng.integers(0, 40, 200)).astype(np.int32)
    remapped = compute_compressed_grad_indices_ref(sorted_idx)
    got = tt.compact_sparse_indices(torch.from_numpy(sorted_idx),
                                    torch.from_numpy(remapped), fill_value)
    want = jt.compact_sparse_indices(jnp.asarray(sorted_idx), jnp.asarray(remapped),
                                     fill_value)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nu = int(remapped[-1]) + 1
    np.testing.assert_array_equal(got.numpy()[:nu], np.unique(sorted_idx))
