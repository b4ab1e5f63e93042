"""The port's types and row-id transforms against the JAX package's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuembed_tpu as jce
from cuembed_tpu.types import combine_coefficients as jax_coefficients

import cuembed_tpu_torch as tce
from cuembed_tpu_torch.types import check_index_dtype


def test_combine_modes_match():
    assert [m.value for m in tce.CombineMode] == [m.value for m in jce.CombineMode]


@pytest.mark.parametrize("storage", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("lpm", [False, True])
def test_accumulation_dtype_matches(storage, lpm):
    want = jnp.dtype(jce.accumulation_dtype(getattr(jnp, storage), lpm)).name
    got = tce.accumulation_dtype(getattr(torch, storage), lpm)
    assert got == getattr(torch, want)


def test_index_dtypes_stay_native():
    assert check_index_dtype(torch.int32) == torch.int32
    assert check_index_dtype(torch.int64) == torch.int64  # not narrowed
    for bad in (torch.int16, torch.float32, torch.uint8):
        with pytest.raises(ValueError, match="unsupported index dtype"):
            check_index_dtype(bad)


def test_formats():
    assert tce.FixedFormat(3).hotness == 3
    assert tce.CSRFormat(0).capacity == 0
    with pytest.raises(ValueError):
        tce.FixedFormat(0)
    with pytest.raises(ValueError):
        tce.CSRFormat(-1)


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("sum", True), ("mean", False)])
def test_combine_coefficients_match(mode, weighted):
    rng = np.random.default_rng(3)
    w = rng.random((6, 5)).astype(np.float32) if weighted else None
    want = jax_coefficients(None if w is None else jnp.asarray(w),
                            jce.CombineMode(mode), 6, 5)
    got = tce.combine_coefficients(
        None if w is None else torch.from_numpy(w), tce.CombineMode(mode), 6, 5,
        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_combine_coefficients_errors():
    with pytest.raises(ValueError, match="CONCAT"):
        tce.combine_coefficients(None, tce.CombineMode.CONCAT, 2, 2, device="cpu")
    with pytest.raises(ValueError, match="SUM"):
        tce.combine_coefficients(torch.ones(4), tce.CombineMode.MEAN, 2, 2)
    with pytest.raises(ValueError, match="device"):
        tce.combine_coefficients(None, tce.CombineMode.SUM, 2, 2)


@pytest.mark.parametrize("batch,hotness", [(1, 1), (7, 3), (16, 64)])
def test_row_ids_fixed_and_concat(batch, hotness):
    want = np.asarray(jce.extract_row_ids_from_fixed(batch, hotness))
    got = tce.extract_row_ids_from_fixed(batch, hotness, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tce.extract_row_ids_for_concat(batch * hotness, device="cpu").numpy(),
        np.asarray(jce.extract_row_ids_for_concat(batch * hotness)),
    )


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("pad", [0, 5])
def test_row_ids_from_csr(index_dtype, pad):
    """Empty samples stack; positions past offsets[-1] clamp into the last
    sample, as in the JAX package."""
    rng = np.random.default_rng(pad)
    per = rng.integers(0, 4, 12)
    per[[0, 3, 11]] = 0
    offsets = np.concatenate([[0], np.cumsum(per)]).astype(np.int32)
    indices = np.zeros(int(offsets[-1]) + pad, np.int32)
    want = np.asarray(jce.extract_row_ids_from_csr(jnp.asarray(offsets),
                                                   jnp.asarray(indices)))
    got = tce.extract_row_ids_from_csr(
        torch.from_numpy(offsets).to(index_dtype),
        torch.from_numpy(indices).to(index_dtype))
    assert got.dtype == index_dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [8, 64])
def test_init_table_is_the_jax_law(width):
    """``init_table_`` draws U(-1/sqrt(W), 1/sqrt(W)), the JAX package's table
    init law: within the bound, reaching near it, centred; ``width``
    overrides the last dimension (a packed table's rows hold k rows)."""
    bound = 1.0 / width ** 0.5
    gen = torch.Generator().manual_seed(0)
    t = tce.types.init_table_(torch.empty((4096, width)), gen)
    assert float(t.abs().max()) <= bound
    assert float(t.abs().max()) > 0.99 * bound
    assert abs(float(t.mean())) < 0.01 * bound
    packed = tce.types.init_table_(torch.empty((512, 4 * width)), gen, width)
    assert float(packed.abs().max()) <= bound
    assert float(packed.abs().max()) > 0.99 * bound
    # The JAX collection's tables obey the same bound.
    jt = jce.EmbeddingCollection([jce.TableConfig("a", 4096, width)]).init(
        jax.random.PRNGKey(0))["a"]
    assert float(jnp.max(jnp.abs(jt))) <= bound
