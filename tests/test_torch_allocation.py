"""The port's ``utils/allocation.py`` against ``cuembed_tpu.utils.
allocation``: the 8 invariant cases of ``tests/test_allocation.py`` (the
reference's ``tests/test_embedding_allocation.cu:56-135``) on the port's
``allocate``, and ``allocate`` equal to the JAX package's array for array,
bit for bit (fixed, CSR, CONCAT, weighted, compressed gradients, permuted
and shuffled ids, fp16 and int64 dtypes, ``forward_only``).
"""

import dataclasses

import numpy as np
import pytest

from cuembed_tpu.types import CombineMode as JMode
from cuembed_tpu.utils import allocation as jalloc

from cuembed_tpu_torch import CombineMode
from cuembed_tpu_torch.utils import allocation
from cuembed_tpu_torch.utils.allocation import AllocationOptions, allocate

BASE = AllocationOptions(
    num_categories=500, batch_size=64, hotness=8, embed_width=12, alpha=1.05
)


def test_fixed_shapes():
    a = allocate(BASE)
    assert a.table.shape == (500, 12)
    assert a.indices.shape == (64, 8)
    assert a.offsets is None and a.weights is None
    assert a.nnz == 64 * 8
    assert a.grad_y.shape == (64, 12)
    assert a.transpose_indices.shape == (a.nnz,)
    assert np.all(np.diff(a.transpose_indices) >= 0)  # sorted


def test_csr_shapes():
    a = allocate(BASE.with_(is_csr=True))
    assert a.offsets.shape == (65,)
    assert a.offsets[0] == 0
    assert a.indices.shape == (int(a.offsets[-1]),)
    per_sample = np.diff(a.offsets)
    assert per_sample.min() >= 0 and per_sample.max() <= 8


def test_concat_shapes():
    a = allocate(BASE.with_(combine_mode=CombineMode.CONCAT))
    assert a.grad_y.shape == (64 * 8, 12)
    # Concat sample ids are the identity sequence.
    np.testing.assert_array_equal(a.sample_ids, np.arange(a.nnz, dtype=np.int32))


def test_weights_values():
    a = allocate(BASE.with_(is_weighted=True))
    assert a.weights.shape == a.indices.shape
    assert set(np.unique(a.weights)) <= {0.25, 0.5}


def test_per_sample_uniqueness_and_range():
    a = allocate(BASE)
    assert a.indices.min() >= 1  # 0 reserved
    assert a.indices.max() < 500
    for row in a.indices:
        assert np.unique(row).size == row.size


def test_compressed_grad_arrays():
    a = allocate(BASE.with_(compressed_grad=True))
    assert a.transpose_remapped_indices is not None
    assert int(a.transpose_remapped_indices[-1]) + 1 == a.num_unique
    # remapped ids are a non-decreasing dense cover of 0..num_unique-1
    d = np.diff(a.transpose_remapped_indices)
    assert set(np.unique(d)) <= {0, 1}


def test_grad_y_integer_valued():
    a = allocate(BASE)
    assert np.array_equal(a.grad_y, np.round(a.grad_y))
    assert a.grad_y.min() >= -10 and a.grad_y.max() <= 10


def test_validation_errors():
    with pytest.raises(ValueError):
        allocate(BASE.with_(is_csr=True, combine_mode=CombineMode.CONCAT))
    with pytest.raises(ValueError):
        allocate(BASE.with_(is_weighted=True, combine_mode=CombineMode.MEAN))


CASES = {
    "fixed": {},
    "csr": dict(is_csr=True),
    "concat": dict(combine_mode="concat"),
    "weighted": dict(is_weighted=True),
    "csr_weighted_compressed": dict(is_csr=True, is_weighted=True, compressed_grad=True),
    "mean_compressed": dict(combine_mode="mean", compressed_grad=True),
    "permuted_shuffled": dict(permute_indices=True, shuffle_indices=True, alpha=1.15),
    "fp16_int64": dict(embed_dtype=np.dtype(np.float16), index_dtype=np.dtype(np.int64),
                       offset_dtype=np.dtype(np.int64), is_csr=True),
    "uniform": dict(alpha=0.0, hotness=3),
}


@pytest.mark.parametrize("forward_only", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_allocate_equals_jax(case, forward_only):
    kw = dict(CASES[case])
    mode = kw.pop("combine_mode", "sum")
    got = allocate(BASE.with_(combine_mode=CombineMode(mode), **kw),
                   forward_only=forward_only)
    want = jalloc.allocate(
        jalloc.AllocationOptions(num_categories=500, batch_size=64, hotness=8,
                                 embed_width=12, alpha=1.05).with_(
            combine_mode=JMode(mode), **kw),
        forward_only=forward_only)
    for f in dataclasses.fields(want):
        if f.name == "options":
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w is None or isinstance(w, int):
            assert g == w, f.name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)
    assert got.nnz == want.nnz
    np.testing.assert_array_equal(got.flat_indices, want.flat_indices)


def test_seeds_and_fields_match_jax():
    assert (allocation.EMBEDDING_SEED, allocation.GRAD_SEED) == (
        jalloc.EMBEDDING_SEED, jalloc.GRAD_SEED)
    assert ([f.name for f in dataclasses.fields(AllocationOptions)]
            == [f.name for f in dataclasses.fields(jalloc.AllocationOptions)])
