"""The port's chip constants (``cuembed_tpu_torch.utils.chip``) against
``cuembed_tpu.utils.chip``, and the decisions they feed in both packages.

The first nine cases are ``tests/test_chip_constants.py``'s on the port.
Then ``derive_chip_constants`` is held to the JAX function, equal dicts, on
the JAX package's committed v5 lite record and on generated records; and,
with ``CUEMBED_CHIP_CONSTANTS`` pointed at that record in both packages,
``auto_config``, ``tiering_profitable`` and the narrow inline-pack bound of
``backend="tiered"`` agree. Each package caches its constants after the
first load, so every case that sets the variable resets both caches before
and after.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

import cuembed_tpu as jce
from cuembed_tpu.ops import tiered as jtiered
from cuembed_tpu.utils import chip as jchip

import torch

import cuembed_tpu_torch as tce
from cuembed_tpu_torch.ops import tiered as ttiered
from cuembed_tpu_torch.utils.chip import (
    V5E_DEFAULTS,
    _reset_cache_for_tests,
    chip_constants,
    derive_chip_constants,
    kind_slug,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5_LITE = os.path.join(REPO, "cuembed_tpu", "data", "chip_constants_tpu_v5_lite.json")
PORT_DATA = os.path.join(REPO, "cuembed_tpu_torch", "data")
DERIVED = ("hot_bytes", "vmem_table_bytes", "narrow_inline_pack_bytes",
           "tiering_min_hotness", "tiering_min_positions")
TOL = dict(rtol=2e-5, atol=1e-5)  # the narrow route's (tests/test_torch_narrow.py)


def _reset_both():
    _reset_cache_for_tests()
    jchip._reset_cache_for_tests()


@pytest.fixture
def record_env(monkeypatch):
    """Point both packages at a record; reset both caches around the case."""
    def use(path):
        monkeypatch.setenv("CUEMBED_CHIP_CONSTANTS", str(path))
        _reset_both()
    _reset_both()
    yield use
    monkeypatch.delenv("CUEMBED_CHIP_CONSTANTS", raising=False)
    _reset_both()


# -- tests/test_chip_constants.py on the port ------------------------------------

def test_derive_vmem_budget_from_gather_curve():
    meas = {
        "vmem_gather": [
            {"mb": 4, "mrows_per_s": 350.0},
            {"mb": 16, "mrows_per_s": 340.0},
            {"mb": 48, "mrows_per_s": 330.0},
            {"mb": 96, "mrows_per_s": 310.0},
            {"mb": 112, "mrows_per_s": 300.0},
            {"mb": 144, "mrows_per_s": 80.0},
        ]
    }
    c = derive_chip_constants(meas)
    assert c["hot_bytes"] == 112 * 1024 * 1024
    assert c["vmem_table_bytes"] == 112 * 1024 * 1024


def test_derive_narrow_pack_bound():
    c = derive_chip_constants({"pack_relayout_gbps": 320.0})
    assert c["narrow_inline_pack_bytes"] == int(320e9 * 100e-6)


def test_derive_narrow_pack_bound_clamped():
    hi = derive_chip_constants({"pack_relayout_gbps": 2976.0})
    assert hi["narrow_inline_pack_bytes"] == 64 << 20
    lo = derive_chip_constants({"pack_relayout_gbps": 0.001})
    assert lo["narrow_inline_pack_bytes"] == 1 << 20


def test_derive_tiering_law():
    ab = []
    for h in (1, 2, 4, 8):
        for p in (8192, 16384, 32768, 65536):
            win = h >= 4 and p >= 32768
            ab.append({"positions": p, "hotness": h,
                       "tiered_ms": 1.0 if win else 3.0, "xla_ms": 2.0})
    c = derive_chip_constants({"tiering_ab": ab})
    assert c["tiering_min_hotness"] == 4
    assert c["tiering_min_positions"] == 32768


def test_derive_tiering_law_never_profitable():
    ab = [{"positions": p, "hotness": h, "tiered_ms": 3.0, "xla_ms": 2.0}
          for h in (1, 4) for p in (8192, 65536)]
    c = derive_chip_constants({"tiering_ab": ab})
    assert c["tiering_min_hotness"] == V5E_DEFAULTS["tiering_min_hotness"]
    assert c["tiering_min_positions"] == V5E_DEFAULTS["tiering_min_positions"]


def test_missing_sections_keep_fallbacks():
    c = derive_chip_constants({})
    for k in DERIVED:
        assert c[k] == V5E_DEFAULTS[k]


def test_env_override_roundtrip(tmp_path, record_env):
    rec = {
        "device_kind": "synthetic-test-chip",
        "vmem_gather": [
            {"mb": 4, "mrows_per_s": 100.0},
            {"mb": 64, "mrows_per_s": 95.0},
            {"mb": 128, "mrows_per_s": 20.0},
        ],
        "pack_relayout_gbps": 100.0,
    }
    path = tmp_path / "chip.json"
    path.write_text(json.dumps(rec))
    record_env(path)
    c = chip_constants(refresh=True)
    assert c["device_kind"] == "synthetic-test-chip"
    assert c["hot_bytes"] == 64 * 1024 * 1024
    assert c["narrow_inline_pack_bytes"] == int(100e9 * 100e-6)


def test_committed_record_when_present():
    """Every record the port commits parses and derives values within the
    JAX test's bounds; the H100's is among them."""
    names = [n for n in os.listdir(PORT_DATA) if n.startswith("chip_constants_")]
    assert "chip_constants_nvidia_h100_80gb_hbm3.json" in names
    for name in names:
        with open(os.path.join(PORT_DATA, name)) as f:
            rec = json.load(f)
        c = derive_chip_constants(rec)
        assert 16 * 2**20 <= c["hot_bytes"] <= 2**31
        assert 2**20 <= c["narrow_inline_pack_bytes"] <= 2**30
        assert 1 <= c["tiering_min_hotness"] <= 64
        assert 1024 <= c["tiering_min_positions"] <= 2**22
        assert name == f"chip_constants_{kind_slug(rec['device_kind'])}.json"
        assert c == jchip.derive_chip_constants(rec)


def test_constants_feed_dispatch():
    """tiering_profitable reads the active record."""
    _reset_cache_for_tests()
    try:
        c = chip_constants(refresh=True)
        h, p = c["tiering_min_hotness"], c["tiering_min_positions"]
        assert ttiered.tiering_profitable(p, h)
        assert not ttiered.tiering_profitable(p - 1, h)
        assert not ttiered.tiering_profitable(p, h - 1)
    finally:
        _reset_cache_for_tests()


# -- against the JAX package -----------------------------------------------------

def test_no_card_resolves_the_fallback():
    """Without a card the kind is "" (the JAX package's is "cpu" here):
    neither package finds a record, both take the v5e fallback."""
    assert os.environ.get("CUEMBED_CHIP_CONSTANTS") is None
    _reset_both()
    try:
        if not torch.cuda.is_available():
            assert chip_constants(refresh=True) == V5E_DEFAULTS
            assert jchip.chip_constants(refresh=True) == jchip.V5E_DEFAULTS
        assert V5E_DEFAULTS == jchip.V5E_DEFAULTS
    finally:
        _reset_both()


def test_derive_matches_jax_on_the_v5_lite_record():
    with open(V5_LITE) as f:
        rec = json.load(f)
    got = derive_chip_constants(rec)
    assert got == jchip.derive_chip_constants(rec)
    assert got["hot_bytes"] == 112 * 2**20 and got["narrow_inline_pack_bytes"] == 23_617_000


_GATHER = st.lists(st.fixed_dictionaries({
    "mb": st.integers(1, 512),
    "mrows_per_s": st.floats(0.1, 5000, allow_nan=False)}), max_size=8)
_AB = st.lists(st.fixed_dictionaries({
    "positions": st.sampled_from([1024, 8192, 16384, 32768, 65536]),
    "hotness": st.sampled_from([1, 2, 4, 8, 16]),
    "tiered_ms": st.floats(0.01, 10, allow_nan=False),
    "xla_ms": st.floats(0.01, 10, allow_nan=False)}), max_size=20)


@settings(max_examples=200, deadline=None)
@given(gather=_GATHER, rate=st.one_of(st.none(), st.floats(1e-4, 1e5)), ab=_AB,
       kind=st.one_of(st.none(), st.text(max_size=12)))
def test_derive_matches_jax_on_generated_records(gather, rate, ab, kind):
    rec = {"vmem_gather": gather, "pack_relayout_gbps": rate, "tiering_ab": ab}
    if kind is not None:
        rec["device_kind"] = kind
    assert derive_chip_constants(rec) == jchip.derive_chip_constants(rec)


@pytest.mark.parametrize("call", [(10_000_000, 256, 2, 64), (1_000_000, 128, 4, 8),
                                  (300_000, 128, 4, 1), (60_000, 512, 4, 16)])
def test_auto_config_matches_jax_under_a_record(call, record_env):
    """Under the v5 lite record (a 112 MiB budget) both packages give the
    same config; the port's constants alone gave hot_rows 221,184 against
    JAX's 229,376 at the first call."""
    record_env(V5_LITE)
    got, want = ttiered.auto_config(*call), jtiered.auto_config(*call)
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if call == (10_000_000, 256, 2, 64):
        assert got.hot_rows == 229_376


def test_tiering_profitable_matches_jax_under_a_record(tmp_path, record_env):
    """Under the v5 lite record and under one whose law differs from the
    fallback, on a grid."""
    ab = [{"positions": p, "hotness": h, "tiered_ms": 1.0 if h >= 2 and p >= 16384 else 3.0,
           "xla_ms": 2.0} for h in (1, 2, 4) for p in (8192, 16384, 65536)]
    other = tmp_path / "law.json"
    other.write_text(json.dumps({"device_kind": "law", "tiering_ab": ab}))
    for path, law in ((V5_LITE, (4, 32768)), (other, (2, 16384))):
        record_env(path)
        c = chip_constants()
        assert (c["tiering_min_hotness"], c["tiering_min_positions"]) == law
        for positions in (0, 8192, 16383, 16384, 32767, 32768, 10**6):
            for hot in (1, 1.5, 2, 3.9, 4, 64):
                assert ttiered.tiering_profitable(positions, hot) == \
                    jtiered.tiering_profitable(positions, hot)


def test_tiered_raw_narrow_bound_matches_jax(record_env):
    """A raw narrow table of 12 MiB lane-padded (24,576 x 32 fp32) under
    backend="tiered": past the fallback's 8 MiB both packages refuse it;
    under the v5 lite record (23,617,000 bytes) both serve it, with results
    within the narrow route's tolerance."""
    rng = np.random.default_rng(31)
    v, width, b, h = 24_576, 32, 64, 8
    assert v * 128 * 4 == 12 * 2**20
    table = rng.standard_normal((v, width)).astype(np.float32)
    idx = rng.integers(0, v, (b, h)).astype(np.int32)

    def port():
        return tce.embedding_lookup(torch.from_numpy(table), torch.from_numpy(idx),
                                    backend="tiered")

    def jax_package():
        return jce.embedding_lookup(jnp.asarray(table), jnp.asarray(idx), backend="tiered")

    for lookup in (port, jax_package):
        with pytest.raises(ValueError, match="repack"):
            lookup()
    record_env(V5_LITE)
    np.testing.assert_allclose(port().numpy(), np.asarray(jax_package()), **TOL)


# -- calibrate_chip's steps, on the CPU at a tiny size ----------------------------

def test_calibrate_chip_steps_on_the_cpu():
    """The steps ``calibrate_chip`` chains on the card: the gather (K1's
    plain version here, summing bags of ``GATHER_HOTNESS`` rows) and the
    pack probe carry the sum of squares of what they computed; the tiered and the plain lookup carry the same probe.
    ``measure`` needs the card."""
    from cuembed_tpu_torch.ops.narrow import pack_narrow
    from cuembed_tpu_torch.utils import calibrate_chip as cal

    gen = torch.Generator().manual_seed(0)
    x0 = (torch.tensor(0, dtype=torch.int32), torch.tensor(0.0))
    src = torch.randn((64, 256), generator=gen)
    idx = torch.randint(0, 64, (5 * cal.GATHER_HOTNESS,), generator=gen, dtype=torch.int32)
    i, probe = cal._gather_step(x0, src, idx)
    assert int(i) == 1
    bags = src[idx.long()].view(5, cal.GATHER_HOTNESS, 256).sum(1)
    torch.testing.assert_close(probe, (bags ** 2).sum(), rtol=1e-5, atol=0)

    raw = torch.randn((40, 32), generator=gen)
    scale = 1.0 + torch.arange(128, dtype=torch.float32)[None] / 128
    _, probe = cal._pack_step(x0, raw, scale)
    torch.testing.assert_close(probe, ((pack_narrow(raw) * scale) ** 2).sum(), rtol=1e-5,
                               atol=0)

    table = torch.randn((500, 128), generator=gen)
    ids = torch.randint(0, 500, (32, 8), generator=gen)
    cfg = ttiered.TieredConfig(hot_rows=64, chunk_elems=64, cold_slots=64, mid_slots=64)
    _, tiered = cal._lookup_step("tiered", cfg)(x0, table, ids)
    _, plain = cal._lookup_step("xla", None)(x0, table, ids)
    assert torch.equal(tiered, plain)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cal.measure(quick=True)
