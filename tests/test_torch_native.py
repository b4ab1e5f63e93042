"""The port's host binding, ``cuembed_tpu_torch.native``, against the JAX
package's ``cuembed_tpu.native``.

* The numpy fallbacks of both packages, from the same numpy inputs, give
  the same arrays (integers and copied floats: compared exactly).
* Both bindings look for the library on the same path, so they take the
  same branch in one process.
* A copy of ``native/cuembed_host.cpp`` built into a temporary directory
  with ``g++`` (skipped without one; the library in ``native/`` is never
  built by the tests, which would switch the JAX suite to it) is loaded
  through ``load_library``, and each C entry point is held to its numpy
  fallback: exactly, except the power-law sampler, whose native stream
  only shares the fallback's distribution (checked as ``tests/test_native.py``
  checks it).
"""

import os
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np
import pytest

from cuembed_tpu import native as jnative
from cuembed_tpu_torch import native as tnative

ROOT = Path(__file__).resolve().parent.parent


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "idx": rng.integers(0, 500, (64, 8)).astype(np.int32),
        "remap": rng.permutation(500).astype(np.int32),
        "offsets": np.concatenate([[0], np.cumsum(rng.integers(0, 5, 40))]).astype(np.int32),
        "sid": np.arange(512, dtype=np.int32),
        "w": rng.random(512).astype(np.float32),
        "tail": rng.standard_normal((436, 8)).astype(np.float32),
        "small": rng.integers(0, 500, (32, 4)).astype(np.int32),
        "perm": rng.permutation(1001).astype(np.int32),
    }


CALLS = {
    "powerlaw_indices": lambda m, a: [m.powerlaw_indices(1000, 8, 1.15, 64, seed=3),
                                      m.powerlaw_indices(1000, 4, 0.0, 16, seed=4,
                                                         permutation=a["perm"])],
    "remap_indices": lambda m, a: [m.remap_indices(a["idx"], a["remap"])],
    "count_frequencies": lambda m, a: [m.count_frequencies(a["idx"], 500),
                                       m.count_frequencies(a["idx"], 500,
                                                           np.ones(500, np.int64))],
    "extract_row_ids_from_csr": lambda m, a: [m.extract_row_ids_from_csr(a["offsets"])],
    "transpose": lambda m, a: [x for x in m.transpose(a["idx"].reshape(-1), a["sid"],
                                                      a["w"], 500)]
    + [x for x in m.transpose(a["idx"].reshape(-1), a["sid"], None, 500)[:2]],
    "cold_counts": lambda m, a: [m.cold_counts(a["idx"], 64, 48)],
    "offload_prepare": lambda m, a: list(m.offload_prepare(a["small"], 64, a["tail"], 128)),
}


@pytest.fixture
def numpy_branch(monkeypatch):
    """Both bindings on their numpy fallbacks, whatever is built."""
    for m in (jnative, tnative):
        monkeypatch.setattr(m, "AVAILABLE", False)
        monkeypatch.setattr(m, "_HAS_OFFLOAD", False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.mark.parametrize("name", sorted(CALLS))
def test_fallbacks_match_jax(numpy_branch, name):
    a = _inputs()
    got, want = CALLS[name](tnative, a), CALLS[name](jnative, a)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_same_library_path_and_branch():
    assert os.path.realpath(tnative._LIB_PATHS[0]) == os.path.realpath(jnative._LIB_PATHS[0])
    assert tnative._LIB_PATHS[0] == str(ROOT / "native" / "libcuembed_host.so")
    assert tnative.AVAILABLE == jnative.AVAILABLE
    assert tnative._HAS_OFFLOAD == jnative._HAS_OFFLOAD


def test_offload_prepare_overflow_raises(numpy_branch):
    a = _inputs()
    for m in (tnative, jnative):
        with pytest.raises(ValueError, match="cold_cap"):
            m.offload_prepare(a["small"], 64, a["tail"], 2)


def test_fallback_notice_once(monkeypatch):
    """Without the library the first fallback call of a hot path warns
    once; CUEMBED_NATIVE=require turns it into an ImportError."""
    monkeypatch.setattr(tnative, "AVAILABLE", False)
    monkeypatch.setattr(tnative, "_HAS_OFFLOAD", False)
    monkeypatch.setattr(tnative, "_fallback_noticed", set())
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tnative.powerlaw_indices(100, 4, 1.05, 8, seed=1)
        tnative.powerlaw_indices(100, 4, 1.05, 8, seed=2)
    hits = [r for r in rec if "numpy fallback" in str(r.message)]
    assert len(hits) == 1 and "make -C native" in str(hits[0].message)
    monkeypatch.setenv("CUEMBED_NATIVE", "require")
    with pytest.raises(ImportError, match="make -C native"):
        tnative.offload_prepare(np.zeros(4, np.int32), 2, np.zeros((4, 8), np.float32), 4)


@pytest.fixture(scope="module")
def built_lib(tmp_path_factory):
    """A copy of the host library, built into a temporary directory."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build native/cuembed_host.cpp")
    out = tmp_path_factory.mktemp("native") / "libcuembed_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-fPIC", "-pthread", "-shared",
                    "-o", str(out), str(ROOT / "native" / "cuembed_host.cpp")],
                   check=True, capture_output=True, timeout=120)
    return tnative.load_library(str(out))


@pytest.fixture
def native_branch(monkeypatch, built_lib):
    monkeypatch.setattr(tnative, "_lib", built_lib)
    monkeypatch.setattr(tnative, "AVAILABLE", True)
    monkeypatch.setattr(tnative, "_HAS_OFFLOAD", True)


def _on_fallback(monkeypatch, fn):
    with monkeypatch.context() as m:
        m.setattr(tnative, "AVAILABLE", False)
        m.setattr(tnative, "_HAS_OFFLOAD", False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn()


@pytest.mark.parametrize("name", sorted(set(CALLS) - {"powerlaw_indices"}))
def test_built_library_matches_fallback(native_branch, monkeypatch, name):
    a = _inputs()
    got = CALLS[name](tnative, a)
    want = _on_fallback(monkeypatch, lambda: CALLS[name](tnative, a))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_built_library_powerlaw_and_abi(native_branch, built_lib):
    assert built_lib.cuembed_native_abi_version() == 2
    V, H, B = 10_000, 16, 2_000
    out = tnative.powerlaw_indices(V, H, 1.05, B, seed=7)
    assert out.shape == (B, H) and out.dtype == np.int32
    assert out.min() >= 1 and out.max() <= V
    assert all(np.unique(row).size == H for row in out[:100])
    assert np.mean(out < 100) > 0.3  # small ids dominate under alpha > 1
    np.testing.assert_array_equal(out, tnative.powerlaw_indices(V, H, 1.05, B, seed=7))
    perm = np.arange(V + 1, dtype=np.int32)[::-1].copy()
    np.testing.assert_array_equal(
        tnative.powerlaw_indices(V, H, 1.05, B, seed=7, permutation=perm), perm[out])
