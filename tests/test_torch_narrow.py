"""The port's line-packed narrow tables against ``cuembed_tpu.ops.narrow``
and the JAX ``EmbeddingBag(layout="packed")``: packing, the lookup (fixed,
CSR, CONCAT, with a ``tiered_cfg``), its gradient, the dispatcher's narrow
routes and the module's import and export.

Inputs are made with numpy from a seed; the JAX package runs on the CPU.
Packing moves bytes: compared exactly. Lookups of integer-valued tables
(weights in {-1, 0.5, 2}) have exact partial sums: compared exactly, except
MEAN over a hotness that is not a power of two (the JAX narrow path
multiplies each position by 1/h, the port scales the sum once). Random
reals: ``tests/test_narrow.py``'s rtol = 2e-5, atol = 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuembed_tpu as jce
from cuembed_tpu.models.embedding_bag import EmbeddingBag as JaxBag
from cuembed_tpu.ops import narrow as jnarrow
from cuembed_tpu.ops import tiered as jtiered

import cuembed_tpu_torch as tce
from cuembed_tpu_torch.ops import narrow as tnarrow
from cuembed_tpu_torch.ops.tiered import TieredConfig
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)

TOL = dict(rtol=2e-5, atol=1e-5)
CFG = dict(hot_rows=512, chunk_elems=64, cold_slots=48, mxu_head_rows=64, mid_slots=64)


@pytest.mark.parametrize("v,w", [(100, 32), (101, 16), (7, 64), (50, 128), (10, 48),
                                 (1, 8)])
def test_pack_unpack_match_jax(v, w):
    rng = np.random.default_rng(v * w)
    table = rng.standard_normal((v, w)).astype(np.float32)
    got = tnarrow.pack_narrow(torch.from_numpy(table))
    want = jnarrow.pack_narrow(jnp.asarray(table))
    assert tnarrow.packing_factor(w) == jnarrow.packing_factor(w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tnarrow.unpack_narrow(got, v, w)
    np.testing.assert_array_equal(back.numpy(), table)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jnarrow.unpack_narrow(want, v, w)))
    # The logical view shares the packed storage.
    view = tnarrow.logical_view(got, w)
    assert view.data_ptr() == got.data_ptr() and view.shape[1] == w


def _problem(rng, v, w, b, h, csr, weighted, integer):
    table = (rng.integers(-8, 9, (v, w)) if integer
             else rng.standard_normal((v, w))).astype(np.float32)
    offsets = None
    if csr:
        hots = rng.integers(0, h + 1, b)
        hots[1] = 0
        offsets = np.concatenate([[0], np.cumsum(hots)])
        idx = rng.integers(0, v, int(offsets[-1]) + 3)
    else:
        idx = np.minimum((rng.random((b, h)) ** 3 * v).astype(np.int64), v - 1)
    weights = None
    if weighted:
        weights = (rng.choice([-1.0, 0.5, 2.0], idx.shape) if integer
                   else rng.standard_normal(idx.shape)).astype(np.float32)
    return table, idx, offsets, weights


CASES = [  # (csr, mode, weighted, tiered)
    (False, "sum", False, False), (False, "mean", False, False),
    (False, "concat", False, False), (False, "sum", True, False),
    (True, "sum", True, False), (True, "mean", False, False),
    (False, "sum", False, True), (False, "mean", False, True),
    (False, "sum", True, True), (True, "sum", True, True),
]


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "reals"])
@pytest.mark.parametrize("width", [16, 32, 64])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    [("csr" if c[0] else "fixed"), c[1]] + (["w"] if c[2] else []) + (["tiered"] if c[3] else [])))
def test_narrow_lookup_matches_jax(case, width, integer):
    csr, mode, weighted, tiered = case
    rng = np.random.default_rng(width + 7 * len(mode))
    v, b, h = 2000, 24, 8
    table, idx, offsets, w = _problem(rng, v, width, b, h, csr, weighted, integer)
    cfg = TieredConfig(**CFG) if tiered else None
    packed = tnarrow.pack_narrow(torch.from_numpy(table))
    got = tnarrow.narrow_lookup(
        packed, v, width, torch.from_numpy(idx), None if w is None else torch.from_numpy(w),
        None if offsets is None else torch.from_numpy(offsets), mode=tce.CombineMode(mode),
        tiered_cfg=cfg)
    want = jnarrow.narrow_lookup(
        jnarrow.pack_narrow(jnp.asarray(table)), v, width, jnp.asarray(idx.astype(np.int32)),
        None if w is None else jnp.asarray(w),
        None if offsets is None else jnp.asarray(offsets.astype(np.int32)),
        mode=jce.CombineMode(mode),
        tiered_cfg=None if cfg is None else jtiered.TieredConfig(**CFG))
    if integer and not (mode == "mean" and csr):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("tiered", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_narrow_grad_matches_jax(weighted, tiered):
    """Gradients with respect to the packed table (and the weights): jax.grad
    through the JAX narrow_lookup, integer data, bit for bit."""
    rng = np.random.default_rng(13)
    v, b, h, width = 1200, 16, 4, 32
    table, idx, _, w = _problem(rng, v, width, b, h, False, weighted, True)
    gy = rng.integers(-3, 4, (b, width)).astype(np.float32)
    cfg = TieredConfig(**CFG) if tiered else None
    jcfg = jtiered.TieredConfig(**CFG) if tiered else None

    def jloss(p, ww):
        return jnp.sum(jnarrow.narrow_lookup(p, v, width, jnp.asarray(idx.astype(np.int32)),
                                             ww, tiered_cfg=jcfg) * gy)

    jg = jax.grad(jloss, argnums=(0, 1) if weighted else 0)(
        jnarrow.pack_narrow(jnp.asarray(table)), None if w is None else jnp.asarray(w))
    jg_p, jg_w = jg if weighted else (jg, None)
    packed = tnarrow.pack_narrow(torch.from_numpy(table)).requires_grad_()
    tw = None if w is None else torch.from_numpy(w).requires_grad_()
    out = tnarrow.narrow_lookup(packed, v, width, torch.from_numpy(idx), tw,
                                tiered_cfg=cfg)
    (out * torch.from_numpy(gy)).sum().backward()
    assert packed.grad.shape == packed.shape
    np.testing.assert_array_equal(packed.grad.numpy(), np.asarray(jg_p))
    if weighted:
        np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(jg_w))


def test_narrow_lookup_errors_match_jax():
    table = np.zeros((40, 32), np.float32)
    idx = np.zeros((4, 2), np.int32)
    for pkg, mod, t, i, o, ww in (
        (jce, jnarrow, jnp.asarray(table), jnp.asarray(idx), jnp.asarray(np.array([0, 4])),
         jnp.ones((4, 2))),
        (tce, tnarrow, torch.from_numpy(table), torch.from_numpy(idx),
         torch.tensor([0, 4]), torch.ones((4, 2))),
    ):
        packed = mod.pack_narrow(t)
        with pytest.raises(ValueError, match="weights are only"):
            mod.narrow_lookup(packed, 40, 32, i, ww, mode=pkg.CombineMode.MEAN)
        with pytest.raises(ValueError, match="CSR does not support CONCAT"):
            mod.narrow_lookup(packed, 40, 32, i.reshape(-1), None, o,
                              mode=pkg.CombineMode.CONCAT)


@pytest.mark.parametrize("backend,tiered", [("auto", False), ("narrow", False),
                                            ("tiered", True), ("auto", True)])
def test_dispatch_narrow_routes_match_jax(backend, tiered, monkeypatch):
    """A small raw narrow table through embedding_lookup under "auto",
    "narrow" and "tiered": the JAX dispatcher packs it inline for the call,
    the port hands the table as it stands to K1's wrapper (its plain
    version here); the result of each route equals JAX's."""
    from cuembed_tpu_torch.ops import cuda_forward

    rng = np.random.default_rng(21)
    v, b, h, width = 1500, 64, 8, 32
    table, idx, _, w = _problem(rng, v, width, b, h, False, True, True)
    cfg = TieredConfig(**CFG) if tiered else None
    t = torch.from_numpy(table)
    seen = []
    real = cuda_forward.embedding_forward_cuda

    def spy(tab, *args, **kwargs):
        seen.append(tab.data_ptr())
        return real(tab, *args, **kwargs)
    monkeypatch.setattr(cuda_forward, "embedding_forward_cuda", spy)
    got = tce.embedding_lookup(t, torch.from_numpy(idx), torch.from_numpy(w),
                               backend=backend, tiered_cfg=cfg)
    assert seen == [t.data_ptr()]
    want = jce.embedding_lookup(jnp.asarray(table), jnp.asarray(idx.astype(np.int32)),
                                jnp.asarray(w), backend=backend,
                                tiered_cfg=None if cfg is None
                                else jtiered.TieredConfig(**CFG))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["narrow", "tiered"])
def test_dispatch_narrow_keeps_the_chunking_error(backend):
    """A config whose chunk is no multiple of the hotness, on a small raw
    narrow table: the JAX engine raises under "narrow" and "tiered", and
    so does the port."""
    rng = np.random.default_rng(22)
    table, idx, _, _ = _problem(rng, 1500, 32, 64, 6, False, False, True)
    with pytest.raises(ValueError, match="multiple of hotness"):
        jce.embedding_lookup(jnp.asarray(table), jnp.asarray(idx.astype(np.int32)),
                             backend=backend, tiered_cfg=jtiered.TieredConfig(**CFG))
    with pytest.raises(ValueError, match="multiple of hotness"):
        tce.embedding_lookup(torch.from_numpy(table), torch.from_numpy(idx),
                             backend=backend, tiered_cfg=TieredConfig(**CFG))


# -- EmbeddingBag(layout="packed") ----------------------------------------------------

def test_embedding_bag_packed_round_trips():
    """A packed JAX table carries across unchanged (import_table, from_numpy
    with the logical size), exports back to the logical table, and the
    lookup equals the JAX module's and the padded layout's."""
    v, width = 300, 32
    jbag = JaxBag(v, width, layout="packed")
    stored = np.asarray(jbag.init(jax.random.key(0)))
    assert stored.shape == (75, 128)
    logical = jbag.export_table(jnp.asarray(stored))

    bag = tce.EmbeddingBag.from_numpy(stored, layout="packed", num_categories=v,
                                      width=width, device="cpu")
    assert tuple(bag.weight.shape) == (75, 128)
    np.testing.assert_array_equal(bag.weight.detach().numpy(), stored)
    np.testing.assert_array_equal(bag.export_table(), logical)
    again = tce.EmbeddingBag(v, width, layout="packed", device="cpu")
    again.import_table(logical)
    np.testing.assert_array_equal(again.weight.detach().numpy(), stored)
    with pytest.raises(ValueError, match="packed"):
        again.import_table(stored[:, :64])

    rng = np.random.default_rng(4)
    idx = rng.integers(0, v, (8, 4))
    got = bag(torch.from_numpy(idx))
    want = jbag.apply(jnp.asarray(stored), jnp.asarray(idx.astype(np.int32)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    padded = tce.EmbeddingBag.from_numpy(logical, device="cpu")
    assert torch.equal(got, padded(torch.from_numpy(idx)))


def test_embedding_bag_packed_from_torch_and_grad():
    """from_torch packs an nn.EmbeddingBag's weights; loss.backward() fills
    the packed parameter's gradient, equal to the padded layout's packed."""
    torch.manual_seed(0)
    module = torch.nn.EmbeddingBag(101, 16, mode="mean")
    bag = tce.EmbeddingBag.from_torch(module, layout="packed", device="cpu")
    assert tuple(bag.weight.shape) == (13, 128)
    np.testing.assert_array_equal(bag.export_table(), module.weight.detach().numpy())
    padded = tce.EmbeddingBag.from_torch(module, device="cpu")
    idx = torch.randint(0, 101, (10, 4))
    bag(idx).square().sum().backward()
    padded(idx).square().sum().backward()
    assert torch.equal(tnarrow.unpack_narrow(bag.weight.grad, 101, 16), padded.weight.grad)
    assert not bag.weight.grad.view(-1, 16)[101:].any()
    # The padding rows of a fresh packed table are zero, as in the JAX init.
    fresh = tce.EmbeddingBag(101, 16, layout="packed", device="cpu")
    assert not fresh.weight.detach().view(-1, 16)[101:].any()


def test_embedding_bag_packed_tiered_gate():
    """With a tiered_cfg, "auto" keeps the config only where the JAX gate
    would tier; the lookup's result does not change either way."""
    rng = np.random.default_rng(9)
    v, width = 3000, 32
    table = rng.integers(-4, 5, (v, width)).astype(np.float32)
    bag = tce.EmbeddingBag.from_numpy(table, layout="packed", device="cpu")
    jbag = JaxBag(v, width, layout="packed")
    stored = jbag.import_table(table)
    for b, h in ((8, 4), (4096, 8)):  # below and past the profitable region
        idx = rng.integers(0, v, (b, h))
        got = bag(torch.from_numpy(idx), tiered_cfg=TieredConfig(**CFG))
        want = jbag.apply(stored, jnp.asarray(idx.astype(np.int32)),
                          tiered_cfg=jtiered.TieredConfig(**CFG))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
