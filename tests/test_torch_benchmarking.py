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


# -- measurement hygiene: the cases of tests/test_sweep_emitter.py:33-100, each
# run on the port's function and on the JAX package's -------------------------

def _hygiene():
    from cuembed_tpu.utils import benchmarking as jb

    return (benchmarking, jb)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_slope_stats_degenerate_flag(which):
    b = _hygiene()[which == "jax"]
    assert b.DEGENERATE_SLOPE_S == jax_bench.DEGENERATE_SLOPE_S
    assert not b._slope_stats(1e-3, 1.2e-3, 2e-3)["degenerate"]
    assert b._slope_stats(b.DEGENERATE_SLOPE_S, 1.2e-3, 2e-3)["degenerate"]
    assert b._slope_stats(1e-3, b.DEGENERATE_SLOPE_S, 2e-3)["degenerate"]
    assert benchmarking._slope_stats(1e-3, 2e-3, 3e-3) == jax_bench._slope_stats(
        1e-3, 2e-3, 3e-3)


@pytest.mark.parametrize("peak", [3350.0, 2000.0])
def test_plausible_floor(peak):
    floor = benchmarking.plausible_floor_s(262144, peak)
    assert floor == jax_bench.plausible_floor_s(262144, peak)
    assert floor == 262144 / (1.25 * peak * 1e9)
    assert benchmarking.DEGENERATE_SLOPE_S < floor
    assert benchmarking.plausible_floor_s(1e6, peak, safety=2.0) == \
        jax_bench.plausible_floor_s(1e6, peak, safety=2.0)


def _stats(median, degenerate=False):
    return {"min": median, "median": median, "max": median, "degenerate": degenerate}


@pytest.mark.parametrize("which", ["port", "jax"])
def test_measure_until_plausible_retries_then_accepts(which):
    b = _hygiene()[which == "jax"]
    seq = [_stats(1e-9, degenerate=True), _stats(5e-4)]
    calls = []

    def measure():
        calls.append(1)
        return seq[min(len(calls) - 1, len(seq) - 1)]

    st = b.measure_until_plausible(measure, floor_s=1e-6)
    assert len(calls) == 2
    assert not st["implausible"]
    assert st["median"] == 5e-4


@pytest.mark.parametrize("which", ["port", "jax"])
def test_measure_until_plausible_flags_persistent_garbage(which):
    b = _hygiene()[which == "jax"]
    calls = []

    def measure():
        calls.append(1)
        return _stats(1e-9, degenerate=True)

    st = b.measure_until_plausible(measure, floor_s=1e-6, retries=2)
    assert len(calls) == 3  # initial + 2 retries
    assert st["implausible"]


@pytest.mark.parametrize("which", ["port", "jax"])
def test_measure_until_plausible_floor_without_degenerate(which):
    # A non-degenerate but faster-than-light median still re-measures: 0.1 us
    # for 1 MB of application traffic is physically impossible on an H100.
    b = _hygiene()[which == "jax"]
    floor = b.plausible_floor_s(1_000_000, 3350.0)
    st = b.measure_until_plausible(lambda: _stats(1e-7), floor_s=floor)
    assert st["implausible"]


def test_lookups_per_sec_matches_jax():
    args = (65536, 64, 2.25e-4)
    assert benchmarking.lookups_per_sec(*args) == jax_bench.lookups_per_sec(*args)


def test_hbm_peak_is_the_cards(monkeypatch):
    """The data sheet's rate by the card's name: the H100 SXM's 3,350 GB/s,
    which is also the default for a card the table does not know. Without a
    card the lookup and the streaming rate raise."""
    peak = benchmarking.detect_hbm_peak_gbps
    assert benchmarking.H100_HBM_BYTES_PER_S == 3350.0 * 1e9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            peak()
        with pytest.raises(RuntimeError, match="CUDA device"):
            benchmarking.stream_rate_gbps()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert peak() == 3350.0
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "some other card")
    assert peak() == 3350.0
    assert peak(default=1.0) == 1.0
