"""The port's ``EmbeddingCollection`` and ``TableConfig`` against
``cuembed_tpu.collection`` on the same tables, imported from numpy.

Covered: the per-table tiered configs (the hot-budget split), apply (fixed,
weighted, CSR, with the tiered configs), counts, reorder, head-hit rates,
the sparse SGD and AdaGrad updates, the feature-level entry points on
shared tables, the state round trip through ``torch.save``,
``plan_placement`` (the plan equal to JAX's on the same counts), and the
sharded entry points on a one-rank mesh.

Tolerances: integer-valued tables and gradients with lr = 0.5 keep every
sum exact: pooled outputs and SGD tables bit for bit. AdaGrad divides by a
square root (XLA may take ``a * rsqrt(b)``): rtol = 1e-5, atol = 1e-6.
Random reals: rtol = atol = 2e-5 (``tests/test_table.py``'s).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuembed_tpu.collection import EmbeddingCollection as JColl
from cuembed_tpu.collection import TableConfig as JConfig
from cuembed_tpu.types import CombineMode as JMode

import cuembed_tpu_torch as tce
from cuembed_tpu_torch.collection import EmbeddingCollection, TableConfig
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
ADA_TOL = dict(rtol=1e-5, atol=1e-6)
B = 24
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _configs(**fields):
    """Port and JAX configs of the same tables."""
    specs = fields.get("specs") or [
        dict(name="ads", num_categories=500, width=16, hotness=4, traffic_share=3.0),
        dict(name="user", num_categories=300, width=32, mode="mean", hotness=2),
    ]
    tcs, jcs = [], []
    for s in specs:
        s = dict(s)
        mode = s.pop("mode", "sum")
        dtype = s.pop("dtype", torch.float32)
        tcs.append(TableConfig(mode=tce.CombineMode(mode), dtype=dtype, **s))
        jcs.append(JConfig(mode=JMode(mode), dtype=DTYPES[dtype], **s))
    return tcs, jcs


def _pair(**kw):
    tcs, jcs = _configs(specs=kw.pop("specs", None))
    return EmbeddingCollection(tcs, **kw), JColl(jcs, **kw)


def _tables(rng, coll, integer=True):
    out = {}
    for name, c in coll.configs.items():
        shape = (c.num_categories, c.width)
        out[name] = (rng.integers(-8, 9, shape) if integer
                     else rng.standard_normal(shape)).astype(np.float32)
    return out


def _idx(rng, coll, batch=B):
    return {name: rng.integers(0, c.num_categories, (batch, c.hotness)).astype(np.int32)
            for name, c in coll.configs.items()}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _eq(got, want, tol=None):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].detach().float().numpy(), np.asarray(want[k], np.float32)
        if tol is None:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **tol)


@pytest.mark.parametrize("hot_bytes_total", [None, 20_000])
def test_tiered_configs_match_jax(hot_bytes_total):
    specs = [
        dict(name="big", num_categories=10_000_000, width=256, dtype=torch.bfloat16,
             hotness=64, traffic_share=3.0),
        dict(name="mid", num_categories=20_000, width=64, hotness=8),
        dict(name="small", num_categories=1_000, width=16),
    ]
    kw = {} if hot_bytes_total is None else {"hot_bytes_total": hot_bytes_total}
    t, j = _pair(specs=specs, **kw)
    assert t.feature_to_table == j.feature_to_table
    for name in j.tiered:
        want = j.tiered[name]
        got = t.tiered[name]
        assert (got is None) == (want is None), name
        if want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if hot_bytes_total is None:  # the small table fits its share of 108 MiB
        assert (t.tiered["big"] is not None) and (t.tiered["small"] is None)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "real"])
@pytest.mark.parametrize("tiered", [False, True])
def test_apply_matches_jax(integer, tiered):
    rng = np.random.default_rng(1)
    t, j = _pair(hot_bytes_total=8192)
    assert all(cfg is not None for cfg in t.tiered.values())
    tables, idx = _tables(rng, t, integer), _idx(rng, t)
    w = {"ads": rng.choice([-1.0, 0.5, 2.0], (B, 4)).astype(np.float32)}
    tol = None if integer else TOL
    _eq(t.apply(_t(tables), _t(idx), tiered=tiered),
        j.apply(_j(tables), _j(idx), backend="xla", tiered=tiered), tol)
    _eq(t.apply(_t(tables), _t(idx), _t(w), tiered=tiered),
        j.apply(_j(tables), _j(idx), _j(w), backend="xla", tiered=tiered), tol)
    hots = rng.integers(0, 5, B)
    offsets = np.concatenate([[0], np.cumsum(hots)]).astype(np.int32)
    flat = {"ads": rng.integers(0, 500, 5 * B).astype(np.int32)}
    flat["ads"][int(offsets[-1]):] = 0
    off = {"ads": offsets}
    _eq(t.apply(_t(tables), _t(flat), offsets=_t(off), tiered=tiered),
        j.apply(_j(tables), _j(flat), offsets=_j(off), backend="xla", tiered=tiered), tol)


def test_counts_reorder_and_hit_rates_match_jax():
    rng = np.random.default_rng(3)
    specs = [dict(name="a", num_categories=4000, width=16, hotness=4, traffic_share=2.0),
             dict(name="b", num_categories=3000, width=200, hotness=2)]
    t, j = _pair(specs=specs)
    tables = _tables(rng, t, integer=False)
    idx = {n: np.minimum((rng.random((512, c.hotness)) ** 3 * c.num_categories)
                         .astype(np.int64), c.num_categories - 1).astype(np.int32)
           for n, c in t.configs.items()}
    tc = t.update_counts(t.init_counts(), idx)
    jc = j.update_counts(j.init_counts(), idx)
    for n in jc:
        np.testing.assert_array_equal(tc[n], jc[n])
    t.update_counts(tc, _t(idx))  # tensors count too
    j.update_counts(jc, idx)
    new_t, rm_t = t.reorder(_t(tables), tc)
    new_j, rm_j = j.reorder(_j(tables), jc)
    _eq(new_t, new_j)
    for n in rm_j:
        np.testing.assert_array_equal(rm_t[n], rm_j[n])
    for budget in (1 << 20, 60_000):
        got = t.head_hit_rates(tc, hot_bytes_total=budget)
        assert got == j.head_hit_rates(jc, hot_bytes_total=budget)
    assert t.head_hit_rates(tc, hot_bytes_total=60_000)  # some table has evidence
    # the lookup of the reordered table at the remapped ids is unchanged
    before = t.apply(_t(tables), _t(idx))
    after = t.apply(new_t, {n: torch.from_numpy(rm_t[n][v]) for n, v in idx.items()})
    _eq(after, {n: v.numpy() for n, v in before.items()})


def test_sparse_updates_match_jax():
    rng = np.random.default_rng(5)
    t, j = _pair()
    tables, idx = _tables(rng, t), _idx(rng, t)
    gy = {n: rng.integers(-4, 5, (B, c.width)).astype(np.float32)
          for n, c in t.configs.items()}
    got = t.sgd_update(_t(tables), _t(idx), _t(gy), lr=0.5)
    _eq(got, j.sgd_update(_j(tables), _j(idx), _j(gy), lr=0.5))
    # AdaGrad: state made on the CPU, updated in place and returned.
    acc = t.adagrad_init(device="cpu")
    for n, c in t.configs.items():
        assert acc[n].shape == (c.num_categories,) and acc[n].dtype == torch.float32
    real = _tables(rng, t, integer=False)
    gy = {n: rng.standard_normal((B, c.width)).astype(np.float32)
          for n, c in t.configs.items()}
    tt = _t(real)
    got_t, got_a = t.adagrad_update(tt, acc, _t(idx), _t(gy), lr=0.1)
    assert got_t["ads"] is tt["ads"] and got_a["ads"] is acc["ads"]
    want_t, want_a = j.adagrad_update(_j(real), j.adagrad_init(), _j(idx), _j(gy), lr=0.1)
    _eq(got_t, want_t, ADA_TOL)
    _eq(got_a, want_a, ADA_TOL)


def _shared(rng):
    specs = [dict(name="video", num_categories=500, width=16, hotness=4,
                  feature_names=("watched", "liked")),
             dict(name="user", num_categories=200, width=16, hotness=2)]
    t, j = _pair(specs=specs)
    tables = _tables(rng, t, integer=False)
    idx = {"watched": rng.integers(0, 500, (B, 4)).astype(np.int32),
           "liked": rng.integers(0, 500, (B, 3)).astype(np.int32),
           "user": rng.integers(0, 200, (B, 2)).astype(np.int32)}
    return t, j, tables, idx


def test_feature_entry_points_match_jax():
    rng = np.random.default_rng(2)
    t, j, tables, idx = _shared(rng)
    assert t.feature_to_table == j.feature_to_table
    _eq(t.apply_features(_t(tables), _t(idx)),
        j.apply_features(_j(tables), _j(idx), backend="xla"), TOL)
    tc = t.update_counts_features(t.init_counts(), idx)
    jc = j.update_counts_features(j.init_counts(), idx)
    for n in jc:
        np.testing.assert_array_equal(tc[n], jc[n])
    gys = {f: rng.standard_normal((B, 16)).astype(np.float32) for f in idx}
    w = {"liked": rng.random((B, 3)).astype(np.float32)}
    _eq(t.sgd_update_features(_t(tables), _t(idx), _t(gys), lr=0.1, weights=_t(w)),
        j.sgd_update_features(_j(tables), _j(idx), _j(gys), lr=0.1, weights=_j(w)), TOL)
    got_t, got_a = t.adagrad_update_features(_t(tables), t.adagrad_init(device="cpu"),
                                             _t(idx), _t(gys), lr=0.1)
    want_t, want_a = j.adagrad_update_features(_j(tables), j.adagrad_init(), _j(idx),
                                               _j(gys), lr=0.1)
    _eq(got_t, want_t, ADA_TOL)
    _eq(got_a, want_a, ADA_TOL)


def test_features_with_mean_and_csr_match_jax():
    rng = np.random.default_rng(6)
    specs = [dict(name="video", num_categories=300, width=8, mode="mean", hotness=4,
                  feature_names=("a", "b"))]
    t, j = _pair(specs=specs)
    tables = _tables(rng, t, integer=False)
    hots = rng.integers(0, 6, B)
    offsets = np.concatenate([[0], np.cumsum(hots)]).astype(np.int32)
    idx = {"a": rng.integers(0, 300, (B, 4)).astype(np.int32),
           "b": rng.integers(0, 300, 6 * B).astype(np.int32)}
    idx["b"][int(offsets[-1]):] = 0
    off = {"b": offsets}
    gys = {f: rng.standard_normal((B, 8)).astype(np.float32) for f in idx}
    _eq(t.apply_features(_t(tables), _t(idx), offsets=_t(off)),
        j.apply_features(_j(tables), _j(idx), offsets=_j(off), backend="xla"), TOL)
    got = t.adagrad_update_features(_t(tables), t.adagrad_init(device="cpu"), _t(idx),
                                    _t(gys), lr=0.1, offsets=_t(off))
    want = j.adagrad_update_features(_j(tables), j.adagrad_init(), _j(idx), _j(gys),
                                     lr=0.1, offsets=_j(off))
    for g, w in zip(got, want):
        _eq(g, w, ADA_TOL)


def test_errors_match_jax():
    for cls, cfg in ((EmbeddingCollection, TableConfig), (JColl, JConfig)):
        with pytest.raises(ValueError, match="claimed by both"):
            cls([cfg("a", 100, 8, feature_names=("x", "y")),
                 cfg("b", 100, 8, feature_names=("y",))])
        with pytest.raises(ValueError, match="unique"):
            cls([cfg("a", 100, 8), cfg("a", 50, 8)])
    t = EmbeddingCollection([TableConfig("c", 100, 8, mode=tce.CombineMode.CONCAT)])
    with pytest.raises(ValueError, match="CONCAT"):
        t.sgd_update_features({"c": torch.zeros(100, 8)},
                              {"c": torch.zeros((4, 2), dtype=torch.int32)},
                              {"c": torch.zeros(8, 8)}, lr=0.1)


PARALLEL_CALLS = ("plan_placement", "shard", "adagrad_init_sharded", "apply_sharded",
             "sgd_update_sharded", "adagrad_update_sharded")


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    """A (data, model) = (1, 1) mesh over a one-rank gloo group in this
    process, taken down after the module."""
    import torch.distributed as dist
    from cuembed_tpu_torch.parallel import make_mesh

    store = tmp_path_factory.mktemp("one_rank") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", sorted(PARALLEL_CALLS))
def test_parallel_entry_points(name, one_rank_mesh):
    """``plan_placement`` gives JAX's plan on the same counts (each table's
    placement, sizes, comm estimate and head-hit rate; the cost model the
    JAX package's, with a small replication limit); the sharded entry
    points run on the parallel layer, and on one rank equal the
    single-device methods bit for bit (the routed sums take the same rows
    in the same order; the multi-rank cases are in
    tests/test_torch_multitable_sharded.py and tests/test_torch_planner.py)."""
    coll, jcoll = _pair()
    if name == "plan_placement":
        from cuembed_tpu.parallel import CostModel as JCost
        from cuembed_tpu_torch.parallel import CostModel

        rng = np.random.default_rng(6)
        seen = {"ads": np.minimum(rng.zipf(1.3, 20_000) - 1, 499),
                "user": rng.integers(0, 300, 20_000)}
        fields = dataclasses.asdict(JCost(replicate_bytes_max=16 * 1024))
        kw = dict(batch=64, hot_bytes_total=64 * 1024)
        got = coll.plan_placement(4, counts=coll.update_counts(coll.init_counts(), seen),
                                  cost=CostModel(**fields), **kw)
        want = jcoll.plan_placement(4, counts=jcoll.update_counts(jcoll.init_counts(), seen),
                                    cost=JCost(**fields), **kw)
        assert got.summary() == want.summary()
        assert (got.n_shards, got.bytes_per_device, got.budget_bytes) == (
            want.n_shards, want.bytes_per_device, want.budget_bytes)
        for k, tp in got.tables.items():
            assert dataclasses.asdict(tp) == dataclasses.asdict(want.tables[k])
        assert got.tables["ads"].placement == "row_sharded"
        return
    rng = np.random.default_rng(5)
    mesh = one_rank_mesh
    tables, idx = _t(_tables(rng, coll, integer=False)), _t(_idx(rng, coll))
    gys = {k: torch.from_numpy(rng.standard_normal((B, c.width)).astype(np.float32))
           for k, c in coll.configs.items()}
    shard = coll.shard(tables, mesh)
    if name == "shard":
        _eq(shard, tables)
    elif name == "adagrad_init_sharded":
        _eq(coll.adagrad_init_sharded(mesh, device="cpu"), coll.adagrad_init(device="cpu"))
    elif name == "apply_sharded":
        _eq(coll.apply_sharded(shard, idx, mesh=mesh), coll.apply(tables, idx))
    elif name == "sgd_update_sharded":
        _eq(coll.sgd_update_sharded(shard, idx, gys, mesh=mesh, lr=0.1),
            coll.sgd_update({k: v.clone() for k, v in tables.items()}, idx, gys, lr=0.1))
    else:
        acc = coll.adagrad_init(device="cpu")
        got = coll.adagrad_update_sharded(shard, coll.adagrad_init_sharded(mesh, device="cpu"),
                                          idx, gys, mesh=mesh, lr=0.1)
        want = coll.adagrad_update({k: v.clone() for k, v in tables.items()}, acc, idx, gys,
                                   lr=0.1)
        _eq(got[0], want[0])
        _eq(got[1], want[1])


def test_init_is_the_jax_law_on_the_requested_device(monkeypatch):
    coll = EmbeddingCollection([TableConfig("a", 1000, 16),
                                TableConfig("b", 500, 64, dtype=torch.bfloat16)])
    tables = coll.init(torch.Generator().manual_seed(0), device="cpu")
    for name, c in coll.configs.items():
        tab = tables[name]
        assert tab.shape == (c.num_categories, c.width) and tab.dtype == c.dtype
        assert float(tab.float().abs().max()) <= 1.0 / c.width ** 0.5
        assert float(tab.float().std()) > 0.5 / c.width ** 0.5 / 3 ** 0.5
    again = coll.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(tables[n], again[n]) for n in tables)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coll.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coll.adagrad_init()


def test_collection_state_roundtrip(tmp_path):
    """Tables, AdaGrad state and counts through torch.save / torch.load as
    plain dicts (the JAX suite's orbax round trip): the restored state gives
    the same lookups and the same update, bit for bit."""
    rng = np.random.default_rng(9)
    coll = EmbeddingCollection([TableConfig("a", 100, 8), TableConfig("b", 50, 4)])
    tables = coll.init(torch.Generator().manual_seed(1), device="cpu")
    accums = coll.adagrad_init(device="cpu")
    counts = coll.update_counts(coll.init_counts(),
                                {"a": np.array([1, 2, 2]), "b": np.array([3])})
    idx = {"a": torch.from_numpy(rng.integers(0, 100, (8, 1))),
           "b": torch.from_numpy(rng.integers(0, 50, (8, 1)))}
    gy = {"a": torch.randn(8, 8), "b": torch.randn(8, 4)}
    coll.adagrad_update(tables, accums, idx, gy, lr=0.1)
    path = tmp_path / "ckpt.pt"
    torch.save({"tables": tables, "accums": accums,
                "counts": {k: torch.from_numpy(v) for k, v in counts.items()}}, path)
    state = torch.load(path)
    for k in tables:
        assert torch.equal(state["tables"][k], tables[k])
        assert torch.equal(state["accums"][k], accums[k])
    np.testing.assert_array_equal(state["counts"]["a"].numpy(), counts["a"])
    out = coll.apply(state["tables"], idx)
    want = coll.apply(tables, idx)
    assert all(torch.equal(out[k], want[k]) for k in want)
    coll.adagrad_update(tables, accums, idx, gy, lr=0.1)
    coll.adagrad_update(state["tables"], state["accums"], idx, gy, lr=0.1)
    for k in tables:
        assert torch.equal(state["tables"][k], tables[k])
        assert torch.equal(state["accums"][k], accums[k])
