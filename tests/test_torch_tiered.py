"""The port's tiered engine against ``cuembed_tpu.ops.tiered`` and
``cuembed_tpu.ops.head``: the configs, the forward, the head backward, the
compressed tiered gradient, autograd with a ``tiered_cfg``, the dispatcher's
tiered routes and ``csr_to_fixed``.

Inputs are made with numpy from a seed; the JAX package runs on the CPU.

Tolerances. Configs, ``csr_to_fixed`` and every integer-valued problem are
compared exactly: there every partial sum is exact, so the JAX engine's
reassociated sums (hot positions first, cold after, one-hot matmuls) equal
the port's position-order sums bit for bit. The exceptions are MEAN over
hotnesses that are not a power of two, where the JAX engine multiplies each
position by ``1/h`` and the port scales the sum once: those, and random
reals, are held to ``tests/test_tiered.py``'s rtol = atol = 2e-5 (fp32) and
2e-2 (bf16 tables).
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuembed_tpu as jce
from cuembed_tpu.ops import head as jhead
from cuembed_tpu.ops import lookup_xla as jlx
from cuembed_tpu.ops import tiered as jtiered
from cuembed_tpu.ops.pallas_forward import csr_to_fixed as j_csr_to_fixed
from cuembed_tpu.utils.chip import V5E_DEFAULTS

import cuembed_tpu_torch as tce
from cuembed_tpu_torch.ops import head as thead
from cuembed_tpu_torch.ops import lookup_torch as tlt
from cuembed_tpu_torch.ops import tiered as ttiered
from cuembed_tpu_torch.ops.transforms import csr_to_fixed
from cuembed_tpu_torch.utils import chip as tchip
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)

SENT = 2**31 - 1
TOL = dict(rtol=2e-5, atol=2e-5)


def jcfg(cfg):
    """The JAX package's TieredConfig with the same fields."""
    return jtiered.TieredConfig(**dataclasses.asdict(cfg))


# -- configs ------------------------------------------------------------------

def test_layout_defaults_are_the_jax_fallback():
    """The port's constants and its fallback record are the JAX package's
    built-in fallback, and the flagship call gives the numbers the JAX
    package gives on the CPU (no card, no record: the fallback)."""
    assert ttiered.DEFAULT_HOT_BYTES == V5E_DEFAULTS["hot_bytes"] == 113246208
    assert tchip.V5E_DEFAULTS["vmem_table_bytes"] == jtiered.VMEM_TABLE_BYTES
    assert tchip.V5E_DEFAULTS == V5E_DEFAULTS
    cfg = ttiered.auto_config(10_000_000, 256, 2, 64)
    assert (cfg.hot_rows, cfg.chunk_elems, cfg.cold_slots, cfg.mxu_head_rows,
            cfg.mid_slots, cfg.csr_chunk_samples) == (221184, 2048, 632, 256, 744, 128)


@pytest.mark.parametrize("num_categories", [1000, 100_000, 3_000_000, 30_000_000])
def test_auto_config_matches_jax(num_categories):
    for width in (16, 32, 128, 256):
        for itemsize in (2, 4):
            for hotness in (0, 1, 7, 64, 4096):
                for fracs in ((0.25, 0.45), (0.05, 0.9), (0.6, 0.1)):
                    for budget in (None, 1 << 20):
                        kw = dict(cold_fraction=fracs[0], head_fraction=fracs[1],
                                  hot_bytes=budget, vmem_table_bytes=budget)
                        got = ttiered.auto_config(num_categories, width, itemsize,
                                                  hotness, **kw)
                        want = jtiered.auto_config(num_categories, width, itemsize,
                                                   hotness, **kw)
                        assert (got is None) == (want is None)
                        if got is not None:
                            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_csr_combine_config_and_gates_match_jax():
    for v in (10, 10_000_000):
        for h in (0, 1, 3.5, 8, 16, 64, 300):
            for chunk in (64, 2048):
                for live in (0, 5000):
                    got = ttiered.csr_combine_config(v, h, chunk_elems=chunk, live_cap=live)
                    want = jtiered.csr_combine_config(v, h, chunk_elems=chunk,
                                                      live_cap=live)
                    assert (got is None) == (want is None)
                    if got is not None:
                        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for positions in (0, 16384, 32767, 32768, 10**6):
        for hot in (1, 3.9, 4, 64):
            assert ttiered.tiering_profitable(positions, hot) == \
                jtiered.tiering_profitable(positions, hot)
    for chunk in (1, 16, 64, 2048, 4096):
        for p in (0.0, 1e-4, 0.1, 0.25, 0.5, 0.99, 1.0, 2.0):
            assert ttiered._capacity(chunk, p) == jtiered._capacity(chunk, p)


def test_nonhead_capacity_matches_jax():
    for cfg in (ttiered.TieredConfig(hot_rows=100),
                ttiered.TieredConfig(hot_rows=100, chunk_elems=64, mid_slots=20,
                                     cold_slots=8),
                ttiered.TieredConfig(hot_rows=100, nonhead_frac=0.37),
                ttiered.TieredConfig(hot_rows=100, nonhead_frac=1.5),
                ttiered.auto_config(10_000_000, 256, 2, 64)):
        for n in (0, 1, 8, 999, 4_194_304):
            assert thead.nonhead_capacity(cfg, n) == jhead.nonhead_capacity(jcfg(cfg), n)


# -- the forward ----------------------------------------------------------------

def _mixed_indices(rng, shape, hot_rows, num_categories, cold_p):
    hot = rng.integers(0, hot_rows, shape)
    cold = rng.integers(hot_rows, num_categories, shape)
    return np.where(rng.random(shape) < cold_p, cold, hot)


PATHS = {  # path -> (csr, config)
    "3tier": (False, ttiered.TieredConfig(hot_rows=100, chunk_elems=64, cold_slots=32,
                                          mxu_head_rows=16, mid_slots=40)),
    "3tier_overflow": (False, ttiered.TieredConfig(hot_rows=100, chunk_elems=64,
                                                   cold_slots=8, mxu_head_rows=16,
                                                   mid_slots=8)),
    "2tier": (False, ttiered.TieredConfig(hot_rows=100, chunk_elems=64, cold_slots=32,
                                          mxu_head_rows=0)),
    "csr_combine": (True, ttiered.TieredConfig(hot_rows=100, chunk_elems=64,
                                               cold_slots=40, mxu_head_rows=0,
                                               csr_chunk_samples=24)),
    "csr_segsum": (True, ttiered.TieredConfig(hot_rows=100, chunk_elems=64,
                                              cold_slots=40, mxu_head_rows=0)),
    "csr_live_cap": (True, ttiered.TieredConfig(hot_rows=500, chunk_elems=64,
                                                cold_slots=0, mxu_head_rows=0,
                                                mid_slots=0, csr_chunk_samples=24,
                                                csr_live_cap=100)),
}


def _forward_problem(rng, csr, weighted, integer, batch=37, hotness=8, V=500, W=24):
    table = (rng.integers(-8, 9, (V, W)) if integer
             else rng.standard_normal((V, W))).astype(np.float32)
    if csr:
        hots = rng.integers(0, 2 * hotness + 1, batch)
        hots[3] = 0
        offsets = np.concatenate([[0], np.cumsum(hots)])
        idx = _mixed_indices(rng, int(offsets[-1]) + 13, 100, V, 0.3)
    else:
        offsets = None
        idx = _mixed_indices(rng, (batch, hotness), 100, V, 0.3)
    w = None
    if weighted:
        w = (rng.choice([-1.0, 0.5, 2.0], idx.shape) if integer
             else rng.standard_normal(idx.shape)).astype(np.float32)
    return table, idx, offsets, w


def _both(fn_t, fn_j, table, idx, offsets, w, **kw):
    got = fn_t(torch.from_numpy(table), torch.from_numpy(idx),
               None if offsets is None else torch.from_numpy(offsets),
               None if w is None else torch.from_numpy(w), **kw)
    jkw = {k: jcfg(v) if k == "cfg" else v for k, v in kw.items()}
    jkw["mode"] = jce.CombineMode(kw["mode"].value)
    want = fn_j(jnp.asarray(table), jnp.asarray(idx.astype(np.int32)),
                None if offsets is None else jnp.asarray(offsets.astype(np.int32)),
                None if w is None else jnp.asarray(w), **jkw)
    return got.float().numpy(), np.asarray(want).astype(np.float32)


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "reals"])
@pytest.mark.parametrize("mode", ["sum", "mean", "sum_w"])
@pytest.mark.parametrize("path", list(PATHS))
def test_tiered_forward_matches_jax(path, mode, integer):
    csr, cfg = PATHS[path]
    rng = np.random.default_rng(zlib.crc32(f"{path} {mode}".encode()))
    table, idx, offsets, w = _forward_problem(rng, csr, mode == "sum_w", integer)
    got, want = _both(tce.tiered_forward, jtiered.tiered_forward, table, idx, offsets,
                      w, mode=tce.CombineMode(mode.removesuffix("_w")), cfg=cfg)
    if integer and not (mode == "mean" and csr):
        # fixed hotness 8: 1/8 per position is exact
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("path", ["3tier", "csr_combine"])
def test_tiered_forward_bf16_and_int64(path):
    csr, cfg = PATHS[path]
    rng = np.random.default_rng(5)
    table, idx, offsets, _ = _forward_problem(rng, csr, False, False)
    tb = torch.from_numpy(table).bfloat16()
    got = tce.tiered_forward(tb, torch.from_numpy(idx.astype(np.int64)),
                             None if offsets is None else torch.from_numpy(offsets),
                             cfg=cfg)
    want = jtiered.tiered_forward(jnp.asarray(table).astype(jnp.bfloat16),
                                  jnp.asarray(idx.astype(np.int32)),
                                  None if offsets is None
                                  else jnp.asarray(offsets.astype(np.int32)),
                                  cfg=jcfg(cfg))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


BAD = {  # name -> (kwargs, csr, message)
    "concat": (dict(mode="concat"), False, "pure gather"),
    "weighted_mean": (dict(mode="mean", weighted=True), False, "weights are only"),
    "pack_k_csr": (dict(pack_k=2), True, "pack_k > 1"),
    "pack_k_2tier": (dict(pack_k=2, cfg=PATHS["2tier"][1]), False, "pack_k > 1"),
    "q_head_csr": (dict(q_head=True), True, "q_head"),
    "q_head_2tier": (dict(q_head=True, cfg=PATHS["2tier"][1]), False, "q_head"),
    "q_head_width": (dict(q_head="narrow"), False, "q_head width"),
    "chunking": (dict(cfg=dataclasses.replace(PATHS["3tier"][1], chunk_elems=60)), False,
                 "multiple of hotness"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_tiered_forward_errors_match_jax(case):
    from cuembed_tpu.ops import quant as jquant

    from cuembed_tpu_torch.ops import quant as tquant

    kw, csr, msg = BAD[case]
    rng = np.random.default_rng(1)
    table, idx, offsets, w = _forward_problem(rng, csr, kw.get("weighted", False), True,
                                              W=128)
    cfg = kw.get("cfg", PATHS["3tier"][1])
    mode = kw.get("mode", "sum")
    qh = {"jax": None, "torch": None}
    if "q_head" in kw:  # an int8 head of the table's width, or of half of it
        cols = (64 if kw["q_head"] == "narrow" else 128) + 128
        qh = {"jax": jquant.QuantizedHead(jnp.zeros((200, cols), jnp.int8)),
              "torch": tquant.QuantizedHead(torch.zeros((200, cols), dtype=torch.int8))}
    for pkg, tiered_forward, table_, idx_, off_, w_, conv, q in (
        ("jax", jtiered.tiered_forward, jnp.asarray(table), jnp.asarray(idx.astype(np.int32)),
         None if offsets is None else jnp.asarray(offsets.astype(np.int32)),
         None if w is None else jnp.asarray(w), jcfg, qh["jax"]),
        ("torch", tce.tiered_forward, torch.from_numpy(table), torch.from_numpy(idx),
         None if offsets is None else torch.from_numpy(offsets),
         None if w is None else torch.from_numpy(w), lambda c: c, qh["torch"]),
    ):
        m = (jce if pkg == "jax" else tce).CombineMode(mode)
        with pytest.raises(ValueError, match=msg):
            tiered_forward(table_, idx_, off_, w_, mode=m, cfg=conv(cfg),
                           pack_k=kw.get("pack_k", 1), q_head=q)


# -- dispatch -------------------------------------------------------------------

@pytest.mark.parametrize("csr", [False, True], ids=["fixed", "csr"])
def test_backend_tiered_matches_jax_and_auto(csr):
    """backend="tiered" with the automatic config (a table past the JAX hot
    budget, given a small budget through an explicit config) and with an
    explicit one: the JAX tiered result, and the port's "auto" bit for bit."""
    rng = np.random.default_rng(17)
    table, idx, offsets, w = _forward_problem(rng, csr, True, True)
    cfg = PATHS["csr_combine" if csr else "3tier"][1]
    t = torch.from_numpy(table)
    ti, tw = torch.from_numpy(idx), torch.from_numpy(w)
    ji, jw = jnp.asarray(idx.astype(np.int32)), jnp.asarray(w)
    if csr:
        to, jo = torch.from_numpy(offsets), jnp.asarray(offsets.astype(np.int32))
        got = tce.embedding_lookup_csr(t, ti, to, tw, backend="tiered", tiered_cfg=cfg)
        auto = tce.embedding_lookup_csr(t, ti, to, tw, tiered_cfg=cfg)
        want = jce.embedding_lookup_csr(jnp.asarray(table), ji, jo, jw, backend="tiered",
                                        tiered_cfg=jcfg(cfg))
    else:
        got = tce.embedding_lookup(t, ti, tw, backend="tiered", tiered_cfg=cfg)
        auto = tce.embedding_lookup(t, ti, tw, tiered_cfg=cfg)
        want = jce.embedding_lookup(jnp.asarray(table), ji, jw, backend="tiered",
                                    tiered_cfg=jcfg(cfg))
    assert torch.equal(got, auto)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


DISPATCH_ERRORS = {  # name -> (table shape, backend, mode, message)
    "narrow_unpackable": ((50, 48), "narrow", "sum", "backend='narrow' needs"),
    "tiered_raw_narrow": ((300_000, 32), "tiered", "sum", "raw narrow table"),
    "tiered_small_table": ((50, 256), "tiered", "sum", "fits the VMEM budget"),
    "tiered_concat": ((50, 256), "tiered", "concat", "never tiered"),
    "unknown": ((50, 256), "gpu", "sum", "unknown backend"),
}


@pytest.mark.parametrize("case", list(DISPATCH_ERRORS))
def test_dispatch_errors_match_jax(case):
    from cuembed_tpu.ops import dispatch as jdispatch

    from cuembed_tpu_torch.ops import dispatch as tdispatch

    shape, backend, mode, msg = DISPATCH_ERRORS[case]
    idx = np.zeros((4, 2), np.int32)
    with pytest.raises(ValueError, match=msg):
        jdispatch.forward(jax.ShapeDtypeStruct(shape, jnp.float32), jnp.asarray(idx),
                          None, None, mode=jce.CombineMode(mode), backend=backend)
    with pytest.raises(ValueError, match=msg):
        tdispatch.forward(torch.empty(shape, device="meta"), torch.from_numpy(idx), None,
                          None, mode=tce.CombineMode(mode), backend=backend)


# -- the backward ------------------------------------------------------------------

def _bwd_problem(rng, batch, hotness, V, head, integer):
    idx = rng.integers(0, V, (batch, hotness))
    idx = np.where(rng.random((batch, hotness)) < 0.5,
                   rng.integers(0, head, (batch, hotness)), idx)
    if integer:
        gy = rng.integers(-5, 6, (batch, 8)).astype(np.float32)
        coeff = rng.integers(0, 4, (batch, hotness)).astype(np.float32)
    else:
        gy = rng.standard_normal((batch, 8)).astype(np.float32)
        coeff = rng.standard_normal((batch, hotness)).astype(np.float32)
    return idx, gy, coeff


def _coo(idx, coeff, head=None):
    flat = idx.reshape(-1).astype(np.int64)
    if head is not None:
        flat = np.where(flat < head, SENT, flat)
    order = np.argsort(flat, kind="stable")
    sid = (np.arange(idx.size) // idx.shape[1]).astype(np.int32)[order]
    return flat[order], sid, coeff.reshape(-1)[order]


def _jcoo(coo):
    return tuple(jnp.asarray(a.astype(np.int32) if a.dtype.kind == "i" else a)
                 for a in coo)


def _tcoo(coo):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in coo)


@pytest.mark.parametrize("weighted", [False, True])
def test_head_matrix_and_grad_match_jax(weighted):
    rng = np.random.default_rng(3)
    idx, gy, coeff = _bwd_problem(rng, 40, 6, 300, 16, integer=False)
    c = coeff if weighted else None
    m_t, app_t = thead.head_matrix(torch.from_numpy(idx), None if c is None
                                   else torch.from_numpy(c), 16, torch.float32,
                                   return_appeared=True)
    m_j, app_j = jhead.head_matrix(jnp.asarray(idx.astype(np.int32)),
                                   None if c is None else jnp.asarray(c), 16,
                                   jnp.float32, return_appeared=True)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), **TOL)
    np.testing.assert_array_equal(app_t.numpy(), np.asarray(app_j))
    g_t = thead.head_grad(torch.from_numpy(idx), None if c is None
                          else torch.from_numpy(c), torch.from_numpy(gy), 16,
                          torch.float32)
    g_j = jhead.head_grad(jnp.asarray(idx.astype(np.int32)),
                          None if c is None else jnp.asarray(c), jnp.asarray(gy), 16,
                          jnp.float32)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **TOL)
    f_t = thead.head_forward(torch.from_numpy(idx), None, torch.from_numpy(gy[:16]), 16,
                             torch.float32)
    f_j = jhead.head_forward(jnp.asarray(idx.astype(np.int32)), None,
                             jnp.asarray(gy[:16]), 16, jnp.float32)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **TOL)


def test_head_product_refuses_tf32(monkeypatch):
    """The head product runs at "highest" fp32 matmul precision whatever the
    caller set, and the caller's setting comes back after."""
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(torch.get_float32_matmul_precision())
        return real(a, b)

    monkeypatch.setattr(thead.torch, "matmul", spy)
    saved = torch.get_float32_matmul_precision()
    try:
        for setting in ("high", "medium"):
            torch.set_float32_matmul_precision(setting)
            thead.head_grad(torch.zeros((4, 2), dtype=torch.int64), None,
                            torch.ones((4, 3)), 2, torch.float32)
            assert seen[-1] == "highest"
            assert torch.get_float32_matmul_precision() == setting
    finally:
        torch.set_float32_matmul_precision(saved)
    assert len(seen) == 2


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "reals"])
def test_tiered_backward_coo_matches_jax(integer):
    rng = np.random.default_rng(2)
    V, HEAD = 300, 8
    cfg = ttiered.TieredConfig(hot_rows=64, chunk_elems=32, cold_slots=16,
                               mxu_head_rows=HEAD, mid_slots=16)
    idx, gy, coeff = _bwd_problem(rng, 48, 4, V, HEAD, integer)
    masked = _coo(idx, coeff, head=HEAD)
    got = thead.tiered_backward_coo(torch.from_numpy(gy), V, torch.from_numpy(idx),
                                    torch.from_numpy(coeff), *_tcoo(masked), cfg)
    want = jhead.tiered_backward_coo(jnp.asarray(gy), V, jnp.asarray(idx.astype(np.int32)),
                                     jnp.asarray(coeff), *_jcoo(masked), jcfg(cfg))
    plain = jlx.embedding_backward_xla(jnp.asarray(gy), V, *_jcoo(_coo(idx, coeff)))
    if integer:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(plain))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


COMPRESSED = {  # name -> (integer, config overrides, unique_cap)
    "integer": (True, {}, None),
    "reals": (False, {}, None),
    "undersized_slots": (True, dict(cold_slots=4, mid_slots=4), None),
    "mxu_segment": (True, dict(bwd_seg_chunk=32, bwd_seg_slots=64, bwd_run_frac=0.5), None),
    "mxu_segment_reals": (False, dict(bwd_seg_chunk=32, bwd_seg_slots=8,
                                      bwd_run_frac=0.5), None),
    "unique_cap": (True, {}, 40),
    "no_head_traffic": (True, {}, None),
}


@pytest.mark.parametrize("case", list(COMPRESSED))
def test_compressed_tiered_matches_jax(case):
    """Same num_unique, indices, rows and padding (sentinel indices, zero
    rows) as the JAX function; the head block first."""
    integer, over, unique_cap = COMPRESSED[case]
    rng = np.random.default_rng(len(case))
    V, HEAD = 500, 16
    cfg = dataclasses.replace(ttiered.TieredConfig(
        hot_rows=100, chunk_elems=64, cold_slots=32, mxu_head_rows=HEAD, mid_slots=32),
        **over)
    idx, gy, coeff = _bwd_problem(rng, 64, 8, V, HEAD, integer)
    if case == "no_head_traffic":
        idx = rng.integers(HEAD, V, idx.shape)
    masked = _coo(idx, coeff, head=HEAD)
    got = tlt.embedding_backward_compressed_tiered(
        torch.from_numpy(gy), V, torch.from_numpy(idx), torch.from_numpy(coeff),
        *_tcoo(masked), cfg, unique_cap=unique_cap)
    want = jlx.embedding_backward_compressed_tiered(
        jnp.asarray(gy), V, jnp.asarray(idx.astype(np.int32)), jnp.asarray(coeff),
        *_jcoo(masked), jcfg(cfg), unique_cap=unique_cap)
    assert int(got.num_unique) == int(want.num_unique)
    assert got.rows.shape == want.rows.shape
    np.testing.assert_array_equal(got.unique_indices.numpy(), np.asarray(want.unique_indices))
    if integer:
        np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    else:
        np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows), **TOL)


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "reals"])
@pytest.mark.parametrize("mode", ["sum", "mean", "sum_w"])
def test_autograd_with_tiered_cfg_matches_jax(mode, integer):
    """The table (and weights) gradient through embedding_lookup with a
    tiered_cfg against jax.grad through the JAX package's."""
    rng = np.random.default_rng(21)
    V, W, batch, hotness = 600, 32, 48, 8
    table = (rng.integers(-4, 5, (V, W)) if integer
             else rng.standard_normal((V, W))).astype(np.float32)
    idx = _mixed_indices(rng, (batch, hotness), 150, V, 0.3)
    w = None
    if mode == "sum_w":
        w = (rng.choice([0.5, 1.0], idx.shape) if integer
             else rng.standard_normal(idx.shape)).astype(np.float32)
    ct = (rng.integers(-3, 4, (batch, W)) if integer
          else rng.standard_normal((batch, W))).astype(np.float32)
    cfg = ttiered.TieredConfig(hot_rows=150, chunk_elems=64, cold_slots=48,
                               mxu_head_rows=64, mid_slots=48)
    m = mode.removesuffix("_w")

    def jloss(t, ww):
        return jnp.sum(jce.embedding_lookup(t, jnp.asarray(idx.astype(np.int32)), ww,
                                            mode=jce.CombineMode(m), backend="tiered",
                                            tiered_cfg=jcfg(cfg)) * ct)

    jg = jax.grad(jloss, argnums=(0, 1) if w is not None else 0)(
        jnp.asarray(table), None if w is None else jnp.asarray(w))
    jg_t, jg_w = jg if w is not None else (jg, None)
    tt = torch.from_numpy(table).requires_grad_()
    tw = None if w is None else torch.from_numpy(w).requires_grad_()
    out = tce.embedding_lookup(tt, torch.from_numpy(idx), tw, mode=tce.CombineMode(m),
                               backend="tiered", tiered_cfg=cfg)
    (out * torch.from_numpy(ct)).sum().backward()
    check = (np.testing.assert_array_equal if integer
             else lambda a, b: np.testing.assert_allclose(a, b, **TOL))
    check(tt.grad.numpy(), np.asarray(jg_t))
    if w is not None:
        check(tw.grad.numpy(), np.asarray(jg_w))


def test_csr_live_cap_backward_matches_jax():
    """A CSR lookup with a csr_live_cap: the live capacity bounds the work
    and changes no gradient."""
    rng = np.random.default_rng(8)
    table, idx, offsets, w = _forward_problem(rng, True, True, True)
    cfg = PATHS["csr_live_cap"][1]
    ct = rng.integers(-3, 4, (len(offsets) - 1, table.shape[1])).astype(np.float32)
    jg = jax.grad(lambda t: jnp.sum(jce.embedding_lookup_csr(
        t, jnp.asarray(idx.astype(np.int32)), jnp.asarray(offsets.astype(np.int32)),
        jnp.asarray(w), tiered_cfg=jcfg(cfg)) * ct))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    (tce.embedding_lookup_csr(tt, torch.from_numpy(idx), torch.from_numpy(offsets),
                              torch.from_numpy(w), tiered_cfg=cfg)
     * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(jg))


# -- csr_to_fixed -------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_csr_to_fixed_matches_jax(mode, weighted):
    if weighted and mode == "mean":
        weighted = False  # MEAN folds 1/h into unit coefficients
    rng = np.random.default_rng(4)
    batch = 19
    hots = rng.integers(0, 7, batch)
    hots[[0, 5]] = 0
    offsets = np.concatenate([[0], np.cumsum(hots)])
    idx = rng.integers(1, 1000, int(offsets[-1]) + 6)
    w = rng.standard_normal(idx.shape).astype(np.float32) if weighted else None
    got_i, got_c = csr_to_fixed(torch.from_numpy(idx), torch.from_numpy(offsets),
                                None if w is None else torch.from_numpy(w),
                                mode=tce.CombineMode(mode))
    want_i, want_c = j_csr_to_fixed(jnp.asarray(idx.astype(np.int32)),
                                    jnp.asarray(offsets.astype(np.int32)),
                                    None if w is None else jnp.asarray(w),
                                    mode=jce.CombineMode(mode))
    assert got_i.dtype == torch.int32 and got_c.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    # The dense problem looks up what the CSR one does.
    t = torch.from_numpy(rng.integers(-4, 5, (1000, 8)).astype(np.float32))
    dense = tce.embedding_lookup(t, got_i.long(), got_c)
    csr = tce.embedding_lookup_csr(t, torch.from_numpy(idx), torch.from_numpy(offsets),
                                   None if w is None else torch.from_numpy(w),
                                   mode=tce.CombineMode(mode))
    if mode == "sum":
        np.testing.assert_allclose(dense.numpy(), csr.numpy(), **TOL)
