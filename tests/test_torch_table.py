"""The port's ``EmbeddingTable`` and ``resize_table`` against
``cuembed_tpu.table`` on the same table, imported from numpy.

Both packages are driven through the same calls (construction, observe,
calibrate, refresh_layout, use_natural_order, enable_int8_head, lookup),
and must agree on the state (counts, remap, the reordered storage bit for
bit, the ``TieredConfig`` field for field) and on every lookup: raw and
line-packed layouts, fixed hotness and CSR, SUM, MEAN and weighted SUM,
before and after the reorder, with the remap on the device and from the
host. The JAX lookups run as its own tests run them on the CPU, through its
plain path or, with its dispatcher told it is on a TPU, its tiered engine.

Tolerances: integer-valued tables with weights in {-1, 0.5, 2} and hotness
8 have exact partial sums: bit for bit. Random reals: ``tests/test_table.py``'s
rtol = atol = 2e-5. The int8 head: ``tests/test_torch_quant.py``'s 2e-5 for
fp32 tables.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuembed_tpu.ops import dispatch as jdispatch
from cuembed_tpu.table import EmbeddingTable as JTable
from cuembed_tpu.table import resize_table as jresize
from cuembed_tpu.types import CombineMode as JMode

import cuembed_tpu_torch as tce
from cuembed_tpu_torch.ops.tiered import TieredConfig
from cuembed_tpu_torch.table import EmbeddingTable, resize_table
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
V, B, H = 600, 64, 8
# A hot budget and untiered bound that make a test-sized table tiered.
SMALL = dict(hot_bytes=4096, vmem_table_bytes=1024)


def _table(rng, integer, width=32):
    if integer:
        return rng.integers(-8, 9, (V, width)).astype(np.float32)
    return rng.standard_normal((V, width)).astype(np.float32)


def _zipf(rng, batch=B, hotness=H, scramble=True):
    u = rng.random((batch, hotness))
    idx = np.minimum((u ** 3 * V).astype(np.int64), V - 1)
    return (rng.permutation(V)[idx] if scramble else idx).astype(np.int32)


def _pair(table, mode="sum", **kw):
    j = JTable(jnp.asarray(table), mode=JMode(mode), **kw)
    t = EmbeddingTable(torch.from_numpy(table.copy()), mode=tce.CombineMode(mode), **kw)
    return j, t


def _same_state(t, j):
    np.testing.assert_array_equal(t.counts, j.counts)
    np.testing.assert_array_equal(t.remap, j.remap)
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    if j.tiered_cfg is None:
        assert t.tiered_cfg is None
    else:
        assert dataclasses.asdict(t.tiered_cfg) == dataclasses.asdict(j.tiered_cfg)


def _check(got, want, exact):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


# (JAX engine, layout); the packed JAX table tiers only past 32768 positions.
ROUTES = [("plain", "raw"), ("plain", "auto"), ("tiered", "raw")]


@pytest.mark.parametrize("engine,layout", ROUTES, ids=["-".join(r) for r in ROUTES])
@pytest.mark.parametrize("mode", ["sum", "sum_w", "mean"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "real"])
def test_lookups_match_jax_across_calibrate(monkeypatch, engine, layout, mode, integer):
    """Lookups before and after calibrate (device remap and host remap),
    and the state calibrate leaves, equal the JAX table's."""
    if engine == "tiered":
        monkeypatch.setattr(jdispatch, "_on_tpu", lambda: True)
    rng = np.random.default_rng(len(mode) + 7 * integer)
    m = mode.removesuffix("_w")
    j, t = _pair(_table(rng, integer), m, layout=layout, **SMALL)
    assert t.table.shape == tuple(j.table.shape)
    idx = _zipf(rng)
    w = (rng.choice([-1.0, 0.5, 2.0], (B, H)).astype(np.float32)
         if mode == "sum_w" else None)
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    exact = integer
    _check(t.lookup(torch.from_numpy(idx), tw), j.lookup(jnp.asarray(idx), jw), exact)

    j.calibrate(idx)
    t.calibrate(idx)
    _same_state(t, j)
    want = j.lookup(jnp.asarray(idx), jw)
    _check(t.lookup(torch.from_numpy(idx), tw), want, exact)
    _check(t.lookup(idx, w), want, exact)  # numpy inputs move to the table
    rm = t.remap_indices(idx)
    np.testing.assert_array_equal(rm, j.remap_indices(idx))
    _check(t.lookup(torch.from_numpy(rm), tw, assume_remapped=True),
           j.lookup(jnp.asarray(j.remap_indices(idx)), jw, assume_remapped=True), exact)
    np.testing.assert_array_equal(t.remap_indices(torch.from_numpy(idx)).numpy(), rm)


def test_second_refresh_composes_as_jax():
    rng = np.random.default_rng(1)
    j, t = _pair(_table(rng, True), layout="raw", **SMALL)
    idx1, idx2 = _zipf(rng), _zipf(rng)
    before = t.lookup(torch.from_numpy(idx1))
    for tab in (j, t):
        tab.calibrate(idx1)
        tab.observe(idx2)
        tab.decay(0.5)
        tab.observe(idx2)
        tab.refresh_layout(idx2)
    _same_state(t, j)
    _check(t.lookup(torch.from_numpy(idx1)), before.numpy(), True)


@pytest.mark.parametrize("layout", ["raw", "auto"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_csr_lookups_and_live_calibration_match_jax(layout, mode):
    """CSR before and after calibrate with offsets: the live count sets the
    hotness, padding is ignored. MEAN over bags of 3 and 5 rounds 1/h: the
    JAX plain path scales each position, the port the sum (tolerance)."""
    rng = np.random.default_rng(31)
    j, t = _pair(_table(rng, True), mode, layout=layout, **SMALL)
    hots = rng.integers(0, 6, B)
    hots[:2] = (0, 8)
    offsets = np.concatenate([[0], np.cumsum(hots)]).astype(np.int32)
    flat = rng.integers(0, V, 8 * B).astype(np.int32)  # heavy padding
    flat[int(offsets[-1]):] = 0
    args = lambda lib: (lib(flat), None, lib(offsets))  # noqa: E731
    exact = mode == "sum"
    _check(t.lookup(*args(torch.from_numpy)), j.lookup(*args(jnp.asarray)), exact)
    j.calibrate(flat, offsets)
    t.calibrate(flat, offsets)
    _same_state(t, j)
    _check(t.lookup(*args(torch.from_numpy)), j.lookup(*args(jnp.asarray)), exact)


def test_gradient_through_lookup_matches_jax():
    rng = np.random.default_rng(3)
    j, t = _pair(_table(rng, False), layout="raw", **SMALL)
    idx = _zipf(rng, 32, 4)
    j.calibrate(idx)
    t.calibrate(idx)

    def jloss(tab):
        saved, j.table = j.table, tab
        try:
            out = j.lookup(jnp.asarray(idx))
        finally:
            j.table = saved
        return jnp.sum(out * out)

    want = jax.grad(jloss)(j.table)
    leaf = t.table.clone().requires_grad_()
    t.table = leaf
    (t.lookup(torch.from_numpy(idx)) ** 2).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), **TOL)
    assert leaf.grad.abs().sum() > 0


def test_natural_order_and_int8_head_match_jax(monkeypatch):
    """use_natural_order, the int8 head's config and bytes, the lossy lookup;
    a refresh drops the head, as in JAX."""
    monkeypatch.setattr(jdispatch, "_on_tpu", lambda: True)
    rng = np.random.default_rng(11)
    kw = dict(layout="raw", hot_bytes=16384, vmem_table_bytes=1024)
    j, t = _pair(_table(rng, False, width=128), **kw)
    idx = _zipf(rng, scramble=False)  # hot-first ids
    exact = t.lookup(torch.from_numpy(idx))
    for tab in (j, t):
        with pytest.raises(ValueError, match="first"):
            tab.enable_int8_head()
        tab.use_natural_order(calibration_indices=idx)
    assert dataclasses.asdict(t.tiered_cfg) == dataclasses.asdict(j.tiered_cfg)
    assert t.remap is None and t._natural_order
    _check(t.lookup(torch.from_numpy(idx)), exact.numpy(), True)
    for calib in (idx, None):
        j.enable_int8_head(calibration_indices=calib)
        t.enable_int8_head(calibration_indices=calib)
        assert dataclasses.asdict(t._q_cfg) == dataclasses.asdict(j._q_cfg)
        np.testing.assert_array_equal(t._q_head.data.numpy(), np.asarray(j._q_head.data))
        _check(t.lookup(torch.from_numpy(idx), use_int8_head=True),
               j.lookup(jnp.asarray(idx), use_int8_head=True), False)
    for tab, lib in ((t, torch.from_numpy), (j, jnp.asarray)):
        with pytest.raises(ValueError, match="fixed-hotness"):
            tab.lookup(lib(idx.reshape(-1)), offsets=lib(np.arange(B + 1) * H),
                       use_int8_head=True)
        with pytest.raises(ValueError, match="already reordered"):
            tab.calibrate(idx)
            tab.use_natural_order()
        assert tab._q_head is None
        with pytest.raises(ValueError, match="enable_int8_head"):
            tab.lookup(lib(idx), use_int8_head=True)


def test_int8_weights_need_sum():
    rng = np.random.default_rng(12)
    t = EmbeddingTable(torch.from_numpy(_table(rng, False, width=128)),
                       mode=tce.CombineMode.MEAN, layout="raw", hot_bytes=16384,
                       vmem_table_bytes=1024)
    idx = _zipf(rng, scramble=False)
    t.use_natural_order(calibration_indices=idx)
    t.enable_int8_head()
    with pytest.raises(ValueError, match="CombineMode.SUM"):
        t.lookup(idx, np.ones((B, H), np.float32), use_int8_head=True)


def test_layout_choice_and_errors_match_jax():
    rng = np.random.default_rng(4)
    for width, layout in ((32, "auto"), (32, "raw"), (32, "packed"), (48, "auto"),
                          (256, "auto")):
        tab = _table(rng, False, width)
        j, t = _pair(tab, layout=layout)
        assert t.table.shape == tuple(j.table.shape)
        assert (t.num_categories, t.width) == (V, width)
        np.testing.assert_array_equal(t.logical_table().numpy(), tab)
        assert t.tiered_cfg is None and t.remap is None
    for kw, msg in ((dict(layout="lines"), "unknown layout"),
                    (dict(layout="packed"), "packed")):
        for cls, lib in ((JTable, jnp.asarray), (EmbeddingTable, torch.from_numpy)):
            with pytest.raises(ValueError, match=msg):
                cls(lib(_table(rng, False, 48)), **kw)
    j, t = _pair(_table(rng, False, 32), layout="packed", **SMALL)
    idx = _zipf(rng)
    for tab in (j, t):
        with pytest.raises(ValueError, match="observe"):
            tab.refresh_layout()
        tab.calibrate(idx)
        with pytest.raises(ValueError, match="wide tables"):
            tab.enable_int8_head()
    _same_state(t, j)


def test_create_and_natural_order_then_refresh():
    gen = torch.Generator().manual_seed(0)
    t = EmbeddingTable.create(gen, 400, 16, device="cpu", layout="raw",
                              dtype=torch.bfloat16, **SMALL)
    assert t.table.dtype == torch.bfloat16 and t.table.shape == (400, 16)
    assert float(t.table.float().abs().max()) <= 0.25
    t.use_natural_order(hotness=4)
    assert t._natural_order and t.tiered_cfg is not None
    t.calibrate(np.random.default_rng(10).integers(0, 400, (32, 4)))
    assert not t._natural_order and t.remap is not None


def test_create_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingTable.create(None, 10, 8)


@pytest.mark.parametrize("accum_shape", [None, (), (16,)])
def test_resize_table_matches_jax(accum_shape):
    rng = np.random.default_rng(0)
    tab = rng.standard_normal((100, 16)).astype(np.float32)
    acc = None if accum_shape is None else rng.random((100, *accum_shape)).astype(np.float32)
    tt, ta = torch.from_numpy(tab), None if acc is None else torch.from_numpy(acc)
    jt, ja = jnp.asarray(tab), None if acc is None else jnp.asarray(acc)
    for n in (150, 60, 100):
        got = resize_table(tt, n, accum=ta)
        want = jresize(jt, n, accum=ja)
        if acc is None:
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    big = resize_table(tt, 150, torch.Generator().manual_seed(1), accum=ta)
    grown = big if acc is None else big[0]
    np.testing.assert_array_equal(grown[:100].numpy(), tab)
    assert grown[100:].abs().max() <= 0.25 and grown[100:].abs().sum() > 0
    if acc is not None:
        assert not big[1][100:].any()


def test_state_round_trip(tmp_path):
    """A table's storage, counts, remap and config through torch.save and
    torch.load (plain tensors and a dict): lookups and an AdaGrad update on
    the restored table give the same bits."""
    rng = np.random.default_rng(8)
    t = EmbeddingTable(torch.from_numpy(_table(rng, False)), layout="raw", **SMALL)
    idx = _zipf(rng)
    t.calibrate(idx)
    accum = torch.zeros(V)
    path = tmp_path / "table.pt"
    torch.save({"table": t.table, "counts": torch.from_numpy(t.counts),
                "remap": torch.from_numpy(t.remap), "accum": accum,
                "tiered_cfg": dataclasses.asdict(t.tiered_cfg)}, path)
    state = torch.load(path)
    r = EmbeddingTable(state["table"], layout="raw", **SMALL)
    r.counts, r.remap = state["counts"].numpy(), state["remap"].numpy()
    r.tiered_cfg = TieredConfig(**state["tiered_cfg"])
    assert r.tiered_cfg == t.tiered_cfg
    ids = torch.from_numpy(idx)
    assert torch.equal(r.lookup(ids), t.lookup(ids))
    gy = torch.from_numpy(rng.standard_normal((B, 32)).astype(np.float32))
    rm = torch.from_numpy(t.remap_indices(idx))
    for tab, acc in ((t, accum), (r, state["accum"])):
        tce.rowwise_adagrad_sparse_update(tab.table, acc, rm, gy, lr=0.1)
    assert torch.equal(r.table, t.table) and torch.equal(state["accum"], accum)
    assert torch.equal(r.lookup(ids), t.lookup(ids))
