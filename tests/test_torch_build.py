"""The kernel build and the wrappers' CPU route, without nvcc or a card.

The build is keyed by a hash of the sources, a failed build raises with
nvcc's output, and a wrapper given CPU tensors computes the plain version
without building or launching anything.
"""

import stat

import pytest
import torch

import cuembed_tpu_torch as tce
from cuembed_tpu_torch.ops import _build
from cuembed_tpu_torch.utils import trace


def _fake_sources(tmp_path, text):
    src = tmp_path / "csrc"
    src.mkdir(exist_ok=True)
    for name in _build.SOURCES + _build.HEADERS:
        (src / name).write_text(text)
    return src


def test_library_is_keyed_by_the_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "SOURCE_DIR", _fake_sources(tmp_path, "// a\n"))
    first = _build.library_path()
    assert first == _build.library_path()
    monkeypatch.setattr(_build, "SOURCE_DIR", _fake_sources(tmp_path, "// b\n"))
    second = _build.library_path()
    assert first != second
    assert first.parent == second.parent == _build.BUILD_DIR
    assert _build.build_log_path().suffix == ".log"


def test_failed_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'forward.cu(1): error: no such type' >&2\nexit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "SOURCE_DIR", _fake_sources(tmp_path, "broken\n"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="exit code 2(.|\n)*no such type"):
        _build.build()
    assert not _build.library_path().exists()
    assert not list((tmp_path / "build").glob("*.so"))


def test_cpu_tensors_never_build_or_launch(monkeypatch):
    """On the CPU the wrappers take the plain version, and only there."""
    def refuse():
        raise AssertionError("a CPU call tried to load the kernels")
    monkeypatch.setattr(_build, "load_library", refuse)
    k1 = trace.counters()["launch.k1"]
    k2 = trace.counters()["launch.k2"]
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((50, 12), generator=gen)
    idx = torch.randint(0, 50, (6, 3), generator=gen)
    offsets = torch.tensor([0, 2, 2, 7])
    flat = torch.randint(0, 50, (9,), generator=gen)
    for backend in ("auto", "pallas", "xla"):
        got = tce.embedding_lookup(table, idx, backend=backend)
        assert torch.equal(got, tce.embedding_forward_torch(table, idx))
        got = tce.embedding_lookup_csr(table, flat, offsets, backend=backend)
        assert torch.equal(got, tce.embedding_forward_torch(table, flat, offsets))
    assert trace.counters()["launch.k1"] == k1
    assert trace.counters()["launch.k2"] == k2
    # The backward, through autograd and the sparse optimizers, likewise.
    k3 = (trace.counters()["launch.k3_full"],
          trace.counters()["launch.k3_compressed"])
    leaf = table.clone().requires_grad_()
    tce.embedding_lookup(leaf, idx).sum().backward()
    tce.embedding_lookup_csr(leaf, flat, offsets).sum().backward()
    tce.rowwise_adagrad_sparse_update(table.clone(), tce.rowwise_adagrad_init(50, device="cpu"),
                                      idx,
                                      torch.ones((6, 12)), lr=0.1)
    assert leaf.grad is not None
    assert k3 == (trace.counters()["launch.k3_full"],
                  trace.counters()["launch.k3_compressed"])
