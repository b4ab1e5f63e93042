"""The forward slice as a whole: a table made by the JAX package, carried
across into the port's EmbeddingBag, serves the same lookups; the port's
datagen draws what the JAX package's draws."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuembed_tpu.models.embedding_bag import EmbeddingBag as JaxBag
from cuembed_tpu.types import CombineMode as JMode
from cuembed_tpu.utils import datagen as jax_datagen

from cuembed_tpu_torch import CombineMode, EmbeddingBag, power_law_indices
from cuembed_tpu_torch.utils import datagen
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)

V, W, B, H = 500, 40, 64, 8


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), np.maximum(e, -125) - 8)


@pytest.mark.parametrize(
    "gen_kw",
    [
        dict(num_categories=1000, hotness=8, alpha=1.15, permute=True),
        dict(num_categories=1000, hotness=8, alpha=1.15, shuffle=True),
        dict(num_categories=50, hotness=5, alpha=0.0),
        dict(num_categories=300, hotness=1, alpha=1.0),
        dict(num_categories=100, hotness=64, alpha=1.05, permute=True),
    ],
    ids=["permute", "shuffle", "uniform", "loguniform_h1", "dedup_heavy"],
)
@pytest.mark.parametrize("seed", [0, 7])
def test_datagen_matches_jax_draw_for_draw(gen_kw, seed):
    kw = dict(gen_kw)
    n, h, a = kw.pop("num_categories"), kw.pop("hotness"), kw.pop("alpha")
    mine = datagen.PowerLawGenerator(n, h, a, seed=seed, dtype=np.int64, **kw)
    ref = jax_datagen.PowerLawGenerator(n, h, a, seed=seed, dtype=np.int64, **kw)
    for batch in (33, 128):  # two draws from one generator: the same stream
        np.testing.assert_array_equal(mine.sample(batch), ref.sample(batch))
    if kw.get("permute"):
        np.testing.assert_array_equal(mine.permutation, ref.permutation)


def _csr_from_fixed(idx, rng):
    """Keep the first h_s ids of each sample, h_s ~ U{0..H}, and pad the
    capacity past offsets[-1] (the bench.py --csr recipe)."""
    per = rng.integers(0, idx.shape[1] + 1, idx.shape[0])
    per[[1, 5]] = 0
    offsets = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
    mask = np.arange(idx.shape[1])[None, :] < per[:, None]
    flat = np.zeros(idx.size, np.int64)
    flat[: offsets[-1]] = idx[mask]
    return flat, offsets


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_jax_table_carried_across_serves_the_same(dtype, mode):
    jdt = {"float32": jnp.float32, "float16": jnp.float16,
           "bfloat16": jnp.bfloat16}[dtype]
    jbag = JaxBag(V, W, mode=JMode(mode), dtype=jdt, layout="raw")
    jtable = jbag.init(jax.random.PRNGKey(3))
    exported = jbag.export_table(jtable)  # numpy; bf16 comes as ml_dtypes
    bag = EmbeddingBag.from_numpy(exported, mode=CombineMode(mode), device="cpu")
    assert bag.weight.dtype == getattr(torch, dtype)
    assert bag.weight.shape == (V, W)

    idx = power_law_indices(V - 1, B, H, alpha=1.15, seed=5, permute=True,
                            dtype=np.int64)
    rng = np.random.default_rng(6)
    flat, offsets = _csr_from_fixed(idx, rng)
    with torch.no_grad():
        got_fixed = bag(torch.from_numpy(idx)).float().numpy()
        got_csr = bag(torch.from_numpy(flat), offsets=torch.from_numpy(offsets))
    got_csr = got_csr.float().numpy()
    want_fixed = np.asarray(jbag.apply(jtable, jnp.asarray(idx.astype(np.int32))),
                            dtype=np.float32)
    want_csr = np.asarray(
        jbag.apply(jtable, jnp.asarray(flat.astype(np.int32)),
                   offsets=jnp.asarray(offsets.astype(np.int32))),
        dtype=np.float32,
    )
    assert not got_csr[[1, 5]].any()
    for got, want in ((got_fixed, want_fixed), (got_csr, want_csr)):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            # fp32 sums in two orders (1e-6), rounded once to the storage
            # dtype (1 ulp; bf16's ulp bounds fp16's).
            assert np.all(np.abs(got - want) <= _bf16_ulp(want) + 1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float16, ml_dtypes.bfloat16])
def test_export_table_round_trips(dtype):
    rng = np.random.default_rng(1)
    arr = rng.standard_normal((30, 6)).astype(dtype)
    bag = EmbeddingBag.from_numpy(arr, device="cpu")
    out = bag.export_table()
    np.testing.assert_array_equal(out, arr.astype(out.dtype))
    assert out.dtype == (np.float32 if dtype is ml_dtypes.bfloat16 else dtype)
    again = EmbeddingBag.from_numpy(out, dtype=bag.weight.dtype, device="cpu")
    assert torch.equal(again.weight, bag.weight)


def test_import_table_checks_shape():
    bag = EmbeddingBag(10, 4, device="cpu")
    with pytest.raises(ValueError, match=r"expected \[10, 4\]"):
        bag.import_table(np.zeros((10, 5), np.float32))


def test_default_device_is_cuda():
    """With no device the table goes to the card; without a card that
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert EmbeddingBag(10, 4).weight.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EmbeddingBag(10, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EmbeddingBag.from_numpy(np.zeros((3, 2), np.float32))


def test_layouts():
    padded = EmbeddingBag(10, 36, device="cpu", layout="padded")
    raw = EmbeddingBag(10, 36, device="cpu", layout="raw")
    assert padded.weight.shape == raw.weight.shape == (10, 36)
    # The packed layout keeps the JAX package's [ceil(V/k), k*W] storage.
    packed = EmbeddingBag(10, 32, device="cpu", layout="packed")
    assert packed.weight.shape == (3, 128)
    assert JaxBag(10, 32, layout="packed").init(jax.random.PRNGKey(0)).shape == (3, 128)
    assert EmbeddingBag(10, 36, device="cpu", layout="packed").weight.shape == (10, 36)
    with pytest.raises(ValueError, match="unknown layout"):
        EmbeddingBag(10, 32, device="cpu", layout="tiled")


def test_reset_parameters_law_and_generator():
    bag = EmbeddingBag(2000, 16, device="cpu")
    bound = 1.0 / 4.0
    assert bag.weight.abs().max() <= bound
    assert bag.weight.std() > 0.8 * bound / np.sqrt(3)
    bag.reset_parameters(torch.Generator().manual_seed(4))
    first = bag.weight.detach().clone()
    bag.reset_parameters(torch.Generator().manual_seed(4))
    assert torch.equal(first, bag.weight)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_from_torch_embedding_bag(mode):
    ref = torch.nn.EmbeddingBag(V, W, mode=mode)
    bag = EmbeddingBag.from_torch(ref)
    assert bag.mode == CombineMode(mode)
    assert bag.weight.device == ref.weight.device
    idx = torch.from_numpy(np.random.default_rng(2).integers(0, V, (B, H)))
    with torch.no_grad():
        torch.testing.assert_close(bag(idx), ref(idx), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="max"):
        EmbeddingBag.from_torch(torch.nn.EmbeddingBag(V, W, mode="max"))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_module_sgd_steps_match_jax(mode):
    """A few EmbeddingBag + torch.optim.SGD steps on the CPU take the table
    where the same steps with jax.grad take the JAX package's table."""
    rng = np.random.default_rng(9)
    table = rng.uniform(-0.5, 0.5, (V, W)).astype(np.float32)
    batches = [rng.integers(0, V, (B, H)) for _ in range(3)]
    lr = 0.05

    bag = EmbeddingBag.from_numpy(table, mode=CombineMode(mode), device="cpu")
    opt = torch.optim.SGD(bag.parameters(), lr=lr)
    jbag = JaxBag(V, W, mode=JMode(mode), layout="raw")
    jtable = jnp.asarray(table)
    loss = lambda out: (out ** 2).sum()  # noqa: E731
    for idx in batches:
        opt.zero_grad()
        loss(bag(torch.from_numpy(idx))).backward()
        opt.step()
        g = jax.grad(lambda t: loss(jbag.apply(t, jnp.asarray(idx.astype(np.int32)))))(jtable)
        jtable = jtable - lr * g
    # Sums of up to B * H rows in two orders, three steps: fp32 tolerance.
    np.testing.assert_allclose(bag.export_table(), np.asarray(jtable),
                               rtol=1e-5, atol=1e-6)
