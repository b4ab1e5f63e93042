"""The port's measurement helpers: the application-bytes formula against
the JAX package's, and the least-time bound's byte and operation counts."""

import pytest
import torch

from cuembed_tpu.types import CombineMode as JMode
from cuembed_tpu.utils import benchmarking as jax_bench
from cuembed_tpu.utils.benchmarking import forward_app_bytes as jax_app_bytes

from cuembed_tpu_torch import CombineMode
from cuembed_tpu_torch.utils import benchmarking


@pytest.mark.parametrize("mode", ["sum", "mean", "concat"])
@pytest.mark.parametrize("is_csr", [False, True], ids=["fixed", "csr"])
def test_forward_app_bytes_matches_jax(mode, is_csr):
    kw = dict(batch=65536, hotness=64, width=256, elem_bytes=2, is_csr=is_csr,
              nnz=2_099_852 if is_csr else None)
    got = benchmarking.forward_app_bytes(mode=CombineMode(mode), **kw)
    assert got == jax_app_bytes(mode=JMode(mode), **kw)


def test_forward_app_bytes_csr_needs_nnz():
    with pytest.raises(ValueError, match="nnz"):
        benchmarking.forward_app_bytes(batch=4, hotness=2, width=8, elem_bytes=4,
                                       is_csr=True)


def test_forward_bound_counts_distinct_rows():
    table = torch.zeros((100, 16), dtype=torch.float16)
    idx = torch.tensor([[3, 3, 7], [7, 9, 3]], dtype=torch.int64)
    b = benchmarking.forward_bound(table, idx, out_rows=2, extra_bytes=40)
    assert b["unique_rows"] == 3
    assert b["bytes"] == 3 * 16 * 2 + 6 * 8 + 40 + 2 * 16 * 2
    assert b["flops"] == 6 * 16
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(
        b["bytes"] / benchmarking.H100_HBM_BYTES_PER_S * 1e3)
    weighted = benchmarking.forward_bound(table, idx, 2, flops_per_element=2)
    assert weighted["flops"] == 2 * b["flops"]


def test_timer_needs_a_card():
    if torch.cuda.is_available():
        assert benchmarking.cuda_time_ms(lambda: None, warmup=0, iters=2) >= 0
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            benchmarking.cuda_time_ms(lambda: None)


@pytest.mark.parametrize("is_csr", [False, True], ids=["fixed", "csr"])
@pytest.mark.parametrize("is_weighted", [False, True])
@pytest.mark.parametrize("compressed", [False, True])
def test_transpose_app_bytes_matches_jax(is_csr, is_weighted, compressed):
    kw = dict(nnz=4_194_304, index_bytes=8, batch=65536, is_csr=is_csr,
              is_weighted=is_weighted, compressed=compressed)
    assert benchmarking.transpose_app_bytes(**kw) == jax_bench.transpose_app_bytes(**kw)


@pytest.mark.parametrize("mode", ["sum", "concat"])
@pytest.mark.parametrize("is_weighted", [False, True])
@pytest.mark.parametrize("l2_variant", [False, True])
def test_backward_app_bytes_matches_jax(mode, is_weighted, l2_variant):
    kw = dict(nnz=4_194_304, batch=65536, width=256, num_unique=571_818,
              elem_bytes=4, index_bytes=8, is_weighted=is_weighted,
              l2_variant=l2_variant)
    got = benchmarking.backward_app_bytes(mode=CombineMode(mode), **kw)
    assert got == jax_bench.backward_app_bytes(mode=JMode(mode), **kw)


def test_backward_bound_at_the_flagship_batch():
    """The flagship fixed batch: fp32 grad_y [65536, 256], 4,194,304 sorted
    positions (int64 index, int32 sample id), 571,818 distinct rows."""
    kw = dict(gy_rows=65536, width=256, elem_bytes=4, live=4_194_304, index_bytes=8,
              num_unique=571_818, weighted=False)
    full = benchmarking.backward_bound(compressed=False, **kw)
    assert full["bytes"] == 67_108_864 + 50_331_648 + 1_171_083_264 == 1_288_523_776
    assert full["bound_by"] == "bytes"
    assert full["bound_ms"] == pytest.approx(0.3846, abs=1e-4)
    comp = benchmarking.backward_bound(compressed=True, **kw)
    # Touched rows written once, with their int64 indices.
    assert comp["bytes"] == 702_982_144 + 571_818 * 8
    weighted = benchmarking.backward_bound(compressed=False, **{**kw, "weighted": True})
    assert weighted["bytes"] == full["bytes"] + 4 * 4_194_304
    assert weighted["flops"] == 2 * full["flops"] == 2 * 4_194_304 * 256
