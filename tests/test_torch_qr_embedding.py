"""The port's ``QREmbeddingBag`` (an ``nn.Module``) against
``cuembed_tpu.models.QREmbeddingBag`` from the same numpy parameters: both
operations, SUM / MEAN / weighted SUM, fixed hotness and (for "add") CSR,
the gradients of both tables, and the errors.

Tolerances: "add" is two pooled lookups and an add, the same sums in both
packages: integer-valued tables bit for bit, random reals rtol = 1e-5,
atol = 1e-6 (``tests/test_qr_embedding.py``'s); "mult" pools with
``torch.sum`` against XLA's reduction, the same tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuembed_tpu.models import QREmbeddingBag as JQR
from cuembed_tpu.types import CombineMode as JMode

import cuembed_tpu_torch as tce
from cuembed_tpu_torch.models import QREmbeddingBag

TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(v, w, q, operation, mode="sum", seed=0, integer=False):
    j = JQR(v, w, q, operation=operation, mode=JMode(mode))
    params = jax.tree_util.tree_map(np.asarray, j.init(jax.random.key(seed)))
    if integer:
        rng = np.random.default_rng(seed)
        params = {k: rng.integers(-4, 5, p.shape).astype(np.float32)
                  for k, p in params.items()}
    t = QREmbeddingBag(v, w, q, operation=operation, mode=tce.CombineMode(mode),
                       device="cpu")
    t.import_params(params)
    return t, j, {k: jnp.asarray(p) for k, p in params.items()}


@pytest.mark.parametrize("operation", ["add", "mult"])
@pytest.mark.parametrize("mode", ["sum", "sum_w", "mean"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "real"])
def test_fixed_hotness_matches_jax(operation, mode, integer):
    rng = np.random.default_rng(1)
    V, W, Q, B, H = 1000, 16, 37, 24, 4
    t, j, jp = _pair(V, W, Q, operation, mode.removesuffix("_w"), integer=integer)
    assert (t.q.shape, t.r.shape) == (jp["q"].shape, jp["r"].shape)
    idx = rng.integers(0, V, (B, H)).astype(np.int32)
    w = rng.choice([-1.0, 0.5, 2.0], (B, H)).astype(np.float32) if mode == "sum_w" else None
    got = t(torch.from_numpy(idx), None if w is None else torch.from_numpy(w))
    want = j.apply(jp, jnp.asarray(idx), None if w is None else jnp.asarray(w))
    if integer and operation == "add":
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_csr_add_matches_jax(mode):
    rng = np.random.default_rng(2)
    V, W, Q, B = 300, 8, 11, 16
    t, j, jp = _pair(V, W, Q, "add", mode, seed=2)
    hots = rng.integers(0, 5, B)
    offs = np.concatenate([[0], np.cumsum(hots)]).astype(np.int32)
    vals = rng.integers(0, V, int(offs[-1]) + 3).astype(np.int32)
    got = t(torch.from_numpy(vals), offsets=torch.from_numpy(offs))
    want = j.apply(jp, jnp.asarray(vals), offsets=jnp.asarray(offs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("operation", ["add", "mult"])
def test_gradients_match_jax(operation):
    rng = np.random.default_rng(3)
    V, W, Q, B, H = 200, 8, 9, 8, 3
    t, j, jp = _pair(V, W, Q, operation, seed=3)
    idx = rng.integers(0, V, (B, H)).astype(np.int32)
    (t(torch.from_numpy(idx)) ** 2).sum().backward()
    want = jax.grad(lambda p: jnp.sum(j.apply(p, jnp.asarray(idx)) ** 2))(jp)
    for name in ("q", "r"):
        got = getattr(t, name).grad
        assert got.abs().sum() > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-5)


def test_errors_match_jax():
    for cls, mode in ((QREmbeddingBag, tce.CombineMode), (JQR, JMode)):
        with pytest.raises(ValueError, match="num_buckets"):
            cls(100, 8, 0)
        with pytest.raises(ValueError, match="num_buckets"):
            cls(10_000, 64, 1_000_000)
        with pytest.raises(ValueError, match="operation"):
            cls(100, 8, 10, operation="cat")
        with pytest.raises(ValueError, match="CONCAT"):
            cls(100, 8, 10, mode=mode.CONCAT)
    t = QREmbeddingBag(100, 8, 10, operation="mult", device="cpu")
    with pytest.raises(ValueError, match="fixed-hotness"):
        t(torch.zeros(4, dtype=torch.int32), offsets=torch.tensor([0, 1, 2, 3, 4]))
    t = QREmbeddingBag(100, 8, 10, operation="mult", mode=tce.CombineMode.MEAN,
                       device="cpu")
    with pytest.raises(ValueError, match="CombineMode.SUM"):
        t(torch.zeros((2, 2), dtype=torch.int32), torch.ones(2, 2))


def test_init_law_and_sizes():
    t = QREmbeddingBag(10_000_000, 4, 4096, device="cpu")
    assert t.num_quotients == -(-10_000_000 // 4096)
    assert t.q.shape[0] + t.r.shape[0] < 10_000_000 / 1000
    m = QREmbeddingBag(1000, 16, 37, operation="mult", device="cpu")
    m.reset_parameters(torch.Generator().manual_seed(0))
    assert float(m.q.detach().abs().max()) <= 1.0
    assert float((m.r.detach() - 1).abs().max()) <= 0.1 + 1e-6
