"""The port's placement planner (``cuembed_tpu_torch.parallel.planner``)
against ``cuembed_tpu.parallel.planner``: the 19 tests of
``tests/test_planner.py``.

Decisions (no ranks): the port's :class:`Plan` equals JAX's field for field
(each table's placement, ``bytes_per_device``, ``comm_bytes_per_step``,
``hot_rows`` and ``head_hit_rate``; the plan's ``bytes_per_device``,
``budget_bytes`` and ``col_shards``; ``summary()``) and the refusals raise
JAX's ``PlanError`` messages (module names aside), under cost models built
from ``cuembed_tpu.parallel.CostModel()`` with the JAX tests' overrides
(the JAX package's defaults, passed to the port explicitly).

End to end: 8 gloo ranks spawned once for the file (``tests/torch_dist.py``)
as a ``(data, model) = (2, 4)`` mesh, the JAX tests' mesh, on which JAX runs
8 virtual CPU devices. The ranks run every case and return their blocks,
which are put back together (``parallel/sharding.py::assemble``: replicas
equal bit for bit) and held to the JAX planner's result on its mesh and to
JAX's single-device lookup or update. The grid CSR case runs on the same
(2, 4) mesh; JAX's runs on a (model, data) = (4, 2) one (the same axis
sizes).

Tolerances: the JAX tests' own (lookups rtol = atol = 1e-5; updates 1e-4
and 1e-5; replicated CSR updates 1e-5 and 1e-6). Replicated tables equal
bit for bit on every rank.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_dist import run_ranks

from cuembed_tpu_torch import CombineMode
from cuembed_tpu_torch.collection import EmbeddingCollection, TableConfig
from cuembed_tpu_torch.parallel import (
    CostModel,
    PlanError,
    apply_plan,
    assemble,
    local_block,
    make_mesh,
    plan,
    planned_adagrad_init,
    planned_adagrad_update,
    planned_lookup,
    planned_sgd_update,
    shard_csr,
)
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)

WORLD = 8
SHAPE = (2, 4)  # (data, model)
LR = 0.1
LOOKUP_TOL = dict(rtol=1e-5, atol=1e-5)
UPDATE_TOL = dict(rtol=1e-4, atol=1e-5)
CSR_TOL = dict(rtol=1e-5, atol=1e-6)

# The JAX tests' cost-model overrides (tests/test_planner.py), applied to
# the JAX package's CostModel() in both packages.
TEST_COST = dict(hbm_bytes=1 << 30, replicate_bytes_max=64 * 1024, column_rows_max=4096,
                 hybrid_min_hit_rate=0.5)
MIXED_COST = dict(hbm_bytes=1 << 30, replicate_bytes_max=64 * 1024, column_rows_max=1024,
                  hybrid_min_hit_rate=0.5)
GRID_COST = dict(hbm_bytes=1 << 30, replicate_bytes_max=64 * 1024, grid_bytes_min=1 << 20)
SMALL_GRID_COST = dict(hbm_bytes=1 << 30, replicate_bytes_max=64 * 1024,
                       grid_bytes_min=1 << 16)


def _jax_fields(**overrides):
    """The JAX package's CostModel() with ``overrides``, as a dict."""
    from cuembed_tpu.parallel import CostModel as JCost

    return dataclasses.asdict(JCost(**overrides))


def _both(cost_overrides):
    """The cost model in both packages: (port, JAX), the same fields."""
    from cuembed_tpu.parallel import CostModel as JCost

    fields = _jax_fields(**cost_overrides)
    return CostModel(**fields), JCost(**fields)


def _jcfg(c: TableConfig):
    """The JAX package's TableConfig for a port config (fp32 tables)."""
    from cuembed_tpu.collection import TableConfig as JConfig

    assert c.dtype == torch.float32
    return JConfig(c.name, c.num_categories, c.width, hotness=c.hotness,
                   traffic_share=c.traffic_share)


def _same_plan(got, want):
    assert (got.n_shards, got.bytes_per_device, got.budget_bytes, got.col_shards) == (
        want.n_shards, want.bytes_per_device, want.budget_bytes, want.col_shards)
    assert list(got.tables) == list(want.tables)
    for name, tp in got.tables.items():
        jp = want.tables[name]
        assert (tp.name, tp.placement, tp.bytes_per_device, tp.comm_bytes_per_step,
                tp.hot_rows, tp.head_hit_rate) == (
            jp.name, jp.placement, jp.bytes_per_device, jp.comm_bytes_per_step,
            jp.hot_rows, jp.head_hit_rate), name
    assert got.summary() == want.summary()


def _plans(configs, n, cost_overrides, **kw):
    """plan() in both packages on the same configs; asserts them equal and
    returns the port's."""
    from cuembed_tpu.parallel import plan as jplan

    cost, jcost = _both(cost_overrides)
    got = plan(configs, n, cost=cost, **kw)
    _same_plan(got, jplan([_jcfg(c) for c in configs], n, cost=jcost, **kw))
    return got


def _same_error(call, jcall, match):
    from cuembed_tpu.parallel import PlanError as JPlanError

    with pytest.raises(PlanError, match=match) as got:
        call()
    with pytest.raises(JPlanError, match=match) as want:
        jcall()
    assert str(got.value).replace("cuembed_tpu_torch.", "cuembed_tpu.") == str(want.value)


# ---------------------------------------------------------------------------
# Decision logic (no ranks)
# ---------------------------------------------------------------------------


def test_plan_placements():
    configs = [
        TableConfig("small", 64, 16),                       # 64*128*4 = 32 KB
        TableConfig("big", 100_000, 64, hotness=4),          # 51 MB padded
        TableConfig("wide", 2048, 128 * 8),                  # few rows, wide
        TableConfig("skewed", 100_000, 64, hotness=4),
    ]
    p = _plans(configs, 8, TEST_COST, batch=65536, head_hit_rate={"skewed": 0.8},
               column_ok=True, hot_bytes_total=4 * 512 * 1024)
    assert p.tables["small"].placement == "replicated"
    assert p.tables["big"].placement == "row_sharded"
    assert p.tables["wide"].placement == "column_sharded"
    assert p.tables["skewed"].placement == "hybrid"
    assert p.tables["skewed"].hot_rows >= 1024
    assert p.tables["skewed"].hot_rows % 8 == 0
    assert p.tables["skewed"].comm_bytes_per_step < p.tables["big"].comm_bytes_per_step
    assert "plan over 8 shards" in p.summary()


def test_plan_no_hybrid_without_stats():
    p = _plans([TableConfig("t", 100_000, 64, hotness=4)], 8, TEST_COST, batch=256)
    assert p.tables["t"].placement == "row_sharded"


def test_plan_column_needs_opt_in():
    p = _plans([TableConfig("wide", 2048, 128 * 8)], 8, TEST_COST, batch=256,
               column_ok=False)
    assert p.tables["wide"].placement == "row_sharded"


def test_plan_over_budget_raises():
    from cuembed_tpu.parallel import plan as jplan

    configs = [TableConfig("huge", 40_000_000, 256)]
    cost, jcost = _both(TEST_COST)
    _same_error(lambda: plan(configs, 8, batch=256, cost=cost),
                lambda: jplan([_jcfg(c) for c in configs], 8, batch=256, cost=jcost),
                "huge")
    with pytest.raises(PlanError, match="n_shards"):
        plan(configs, 0, batch=256, cost=cost)


def test_plan_single_shard_replicates():
    p = _plans([TableConfig("t", 100_000, 64)], 1, TEST_COST, batch=256)
    assert p.tables["t"].placement == "replicated"
    assert p.tables["t"].comm_bytes_per_step == 0


def _zipf_counts(coll, jcoll, rng):
    counts = {"uniform": rng.integers(0, 100_000, 100_000),
              "zipf": np.minimum(rng.zipf(1.3, 100_000) - 1, 99_999).astype(np.int64)}
    return (coll.update_counts(coll.init_counts(), counts),
            jcoll.update_counts(jcoll.init_counts(), counts))


def test_collection_plan_placement_from_counts():
    """Collection -> counts -> hit rates -> plan: the skewed table goes
    hybrid from measured stats, the uniform one stays row-sharded; the
    port's plan equals JAX's on the same counts."""
    from cuembed_tpu.collection import EmbeddingCollection as JColl

    rng = np.random.default_rng(4)
    configs = [TableConfig("uniform", 100_000, 64, hotness=4),
               TableConfig("zipf", 100_000, 64, hotness=4)]
    coll, jcoll = EmbeddingCollection(configs), JColl([_jcfg(c) for c in configs])
    counts, jcounts = _zipf_counts(coll, jcoll, rng)
    hits = coll.head_hit_rates(counts, hot_bytes_total=2 * 512 * 1024)
    assert hits == jcoll.head_hit_rates(jcounts, hot_bytes_total=2 * 512 * 1024)
    assert hits["zipf"] > 0.7 > 0.2 > hits["uniform"]
    cost, jcost = _both(TEST_COST)
    kw = dict(batch=65536, hot_bytes_total=2 * 512 * 1024)
    p = coll.plan_placement(8, counts=counts, cost=cost, **kw)
    _same_plan(p, jcoll.plan_placement(8, counts=jcounts, cost=jcost, **kw))
    assert p.tables["zipf"].placement == "hybrid"
    assert p.tables["uniform"].placement == "row_sharded"
    # without stats nothing goes hybrid
    p2 = coll.plan_placement(8, batch=65536, cost=cost)
    _same_plan(p2, jcoll.plan_placement(8, batch=65536, cost=jcost))
    assert all(tp.placement == "row_sharded" for tp in p2.tables.values())


def test_head_hit_rates_requires_evidence():
    """A uniform table calibrated on a sample smaller than the head must NOT
    masquerade as skewed; with plenty of evidence the honest (low) rate comes
    through. The same rates as JAX's."""
    from cuembed_tpu.collection import EmbeddingCollection as JColl

    rng = np.random.default_rng(9)
    cfg = TableConfig("uniform", 200_000, 64, hotness=4)
    coll, jcoll = EmbeddingCollection([cfg]), JColl([_jcfg(cfg)])
    sample = {"uniform": rng.integers(0, 200_000, 1024)}
    counts = coll.update_counts(coll.init_counts(), sample)
    jcounts = jcoll.update_counts(jcoll.init_counts(), sample)
    hits = coll.head_hit_rates(counts, hot_bytes_total=2 * 2**20)
    assert hits == jcoll.head_hit_rates(jcounts, hot_bytes_total=2 * 2**20)
    assert "uniform" not in hits
    more = {"uniform": rng.integers(0, 200_000, 400_000)}
    counts, jcounts = coll.update_counts(counts, more), jcoll.update_counts(jcounts, more)
    hits = coll.head_hit_rates(counts, hot_bytes_total=2 * 2**20)
    assert hits == jcoll.head_hit_rates(jcounts, hot_bytes_total=2 * 2**20)
    assert 0.0 < hits["uniform"] < 0.1


def test_plan_grid_needs_opt_in_and_eligibility():
    from cuembed_tpu.parallel import plan as jplan

    big_wide = TableConfig("bw", 100_000, 256, hotness=4)
    p = _plans([big_wide], 4, GRID_COST, batch=1024)
    assert p.tables["bw"].placement == "row_sharded"
    row_bytes = p.tables["bw"].bytes_per_device
    p = _plans([big_wide], 4, GRID_COST, batch=1024, grid_ok=True, col_shards=2)
    assert p.tables["bw"].placement == "grid_sharded"
    assert p.col_shards == 2
    assert p.tables["bw"].bytes_per_device == -(-row_bytes // 2)
    # narrow table: a 128-wide row can't split into full lane tiles
    narrow = TableConfig("n", 100_000, 128, hotness=4)
    p = _plans([narrow], 4, GRID_COST, batch=1024, grid_ok=True, col_shards=2)
    assert p.tables["n"].placement == "row_sharded"
    cost, jcost = _both(GRID_COST)
    _same_error(lambda: plan([big_wide], 4, batch=1024, cost=cost, grid_ok=True),
                lambda: jplan([_jcfg(big_wide)], 4, batch=1024, cost=jcost, grid_ok=True),
                "col_shards")


def test_plan_hybrid_wins_over_grid():
    """Measured skew evidence (head-hit rate) beats grid: hybrid routes a
    fraction of the traffic, grid always routes all of it."""
    cfg = TableConfig("t", 100_000, 256, hotness=4)
    p = _plans([cfg], 4, GRID_COST, batch=65536, head_hit_rate={"t": 0.9}, grid_ok=True,
               col_shards=2, hot_bytes_total=2048 * 256 * 4)
    assert p.tables["t"].placement == "hybrid"
    p2 = _plans([cfg], 4, GRID_COST, batch=65536, grid_ok=True, col_shards=2)
    assert p2.tables["t"].placement == "grid_sharded"


# ---------------------------------------------------------------------------
# End to end on 8 ranks: the problems (numpy, shared by the ranks and JAX)
# ---------------------------------------------------------------------------

MIXED = [
    TableConfig("small", 64, 16, hotness=4),
    TableConfig("big", 4096, 32, hotness=4),
    TableConfig("wide", 512, 512, hotness=2),
    TableConfig("skewed", 4096, 32, hotness=4),
]
MIXED_KW = dict(batch=8192, head_hit_rate={"skewed": 0.75}, column_ok=True,
                hot_bytes_total=4 * 1024 * 128 * 4)
SMALL = [TableConfig("small", 64, 16, hotness=4)]
GRID_CFG = TableConfig("bw", 512, 256, hotness=4)
GRID_CSR_CFG = TableConfig("bw", 4096, 512, hotness=4)

# This rank's block of each array, by placement: the batch, the pooled
# output's gradient (and the output), the table, the accumulator.
IDX_SPEC = {"column_sharded": ("data", None)}
GY_SPEC = {"column_sharded": ("data", "model"), "grid_sharded": ("model", "data")}
OUT_SPEC = {"column_sharded": ("data", None)}
TABLE_SPEC = {"replicated": (), "row_sharded": ("model", None),
              "column_sharded": (None, "model"), "grid_sharded": ("model", "data")}
ACC_SPEC = {"replicated": (), "row_sharded": ("model",), "column_sharded": (),
            "grid_sharded": ("model",)}


def _mixed_arrays(seed, hot_rows):
    """The tables, batches (64 samples; the skewed table's drawn toward its
    head) and pooled-output gradients of the mixed collection."""
    rng = np.random.default_rng(seed)
    tables = {c.name: rng.standard_normal((c.num_categories, c.width)).astype(np.float32)
              for c in MIXED}
    idx = {}
    for c in MIXED:
        if c.name == "skewed":
            lo = rng.integers(0, hot_rows, (48, c.hotness))
            hi = rng.integers(0, c.num_categories, (16, c.hotness))
            idx[c.name] = np.concatenate([lo, hi]).astype(np.int32)
        else:
            idx[c.name] = rng.integers(0, c.num_categories, (64, c.hotness)).astype(np.int32)
    gys = {c.name: rng.standard_normal((64, c.width)).astype(np.float32) for c in MIXED}
    return tables, idx, gys


def _small_csr(seed):
    """A 64 x 16 table, a CSR batch of 16 samples (hotness U{0..4}) and its
    pooled-output gradient."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((64, 16)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(rng.integers(0, 5, 16))]).astype(np.int32)
    vals = rng.integers(0, 64, max(int(offs[-1]), 1)).astype(np.int32)
    gy = rng.standard_normal((16, 16)).astype(np.float32)
    return table, vals, offs, gy


def _grid_arrays():
    rng = np.random.default_rng(7)
    V, W, B, H = 512, 256, 64, 4
    return (rng.standard_normal((V, W)).astype(np.float32),
            rng.integers(0, V, (B, H)).astype(np.int32),
            rng.standard_normal((B, W)).astype(np.float32))


def _grid_csr_arrays():
    rng = np.random.default_rng(41)
    V, W, B = 4096, 512, 64
    table = rng.standard_normal((V, W)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(rng.integers(0, 5, B))]).astype(np.int32)
    vals = rng.integers(0, V, max(int(offs[-1]), 1)).astype(np.int32)
    gy = rng.standard_normal((B, W)).astype(np.float32)
    return table, vals, offs, gy


# -- the ranks ----------------------------------------------------------------

def ranks(rank, world, tmp):
    costs = {k: CostModel(**v) for k, v in json.loads((tmp / "costs.json").read_text()).items()}
    mesh = make_mesh(n_model=4, device_type="cpu")
    t = torch.from_numpy

    def blk(x, spec):
        return local_block(t(x), mesh, spec)

    res = {}
    # The mixed collection: one placement of each kind but grid.
    p = plan(MIXED, 4, cost=costs["mixed"], **MIXED_KW)
    res["mixed/plan"] = p
    for seed, kind in ((0, "lookup"), (1, "sgd"), (2, "adagrad")):
        tables, idx, gys = _mixed_arrays(seed, p.tables["skewed"].hot_rows)
        placed = apply_plan(p, {k: t(v) for k, v in tables.items()}, mesh)
        pl = {k: tp.placement for k, tp in p.tables.items()}
        ib = {k: blk(v, IDX_SPEC.get(pl[k], ("model", None))) for k, v in idx.items()}
        gb = {k: blk(v, GY_SPEC.get(pl[k], ("model", None))) for k, v in gys.items()}
        if kind == "lookup":
            res["mixed/hybrid_is_pair"] = isinstance(placed["skewed"], tuple)
            res["mixed/lookup"] = planned_lookup(p, placed, ib, mesh=mesh)
            # The replicated table's gradient: the global loss's, summed over
            # the model axis the batch is sharded on.
            small = placed["small"].clone().requires_grad_()
            out = planned_lookup(p, {"small": small}, {"small": ib["small"]}, mesh=mesh)
            (out["small"] * blk(gys["small"], ("model", None))).sum().backward()
            res["mixed/small_grad"] = small.grad
        elif kind == "sgd":
            res["mixed/sgd"] = planned_sgd_update(p, placed, ib, gb, mesh=mesh, lr=LR)
        else:
            accums = planned_adagrad_init(p, placed, mesh)
            res["mixed/adagrad"] = planned_adagrad_update(p, placed, accums, ib, gb,
                                                          mesh=mesh, lr=LR)

    # A replicated table: replicas after an update.
    rng = np.random.default_rng(3)
    table = rng.standard_normal((64, 16)).astype(np.float32)
    idx = rng.integers(0, 64, (64, 4)).astype(np.int32)
    gy = rng.standard_normal((64, 16)).astype(np.float32)
    ps = plan(SMALL, 4, batch=64, cost=costs["test"])
    placed = apply_plan(ps, {"small": t(table)}, mesh)
    res["replicas/sgd"] = planned_sgd_update(
        ps, placed, {"small": blk(idx, ("model", None))},
        {"small": blk(gy, ("model", None))}, mesh=mesh, lr=LR)["small"]

    # Replicated tables under sharded-CSR blocks: the lookup, SGD and AdaGrad.
    for seed, kind in ((5, "lookup"), (6, "update")):
        table, vals, offs, gy = _small_csr(seed)
        ib, ob, _ = shard_csr(vals, offs, 4)
        args = dict(indices={"small": blk(ib, ("model", None))},
                    offsets={"small": blk(ob, ("model", None))}, mesh=mesh)
        placed = apply_plan(ps, {"small": t(table)}, mesh)
        if kind == "lookup":
            res["csr/lookup"] = planned_lookup(ps, placed, **args)["small"]
            continue
        gys = {"small": blk(gy, ("model", None))}
        res["csr/sgd"] = planned_sgd_update(ps, {"small": placed["small"].clone()},
                                            grads_y=gys, lr=LR, **args)["small"]
        accums = planned_adagrad_init(ps, placed, mesh)
        res["csr/adagrad"] = planned_adagrad_update(ps, placed, accums, grads_y=gys, lr=LR,
                                                    **args)

    # The refusals: a plan for another axis size, a grid plan for another
    # column count.
    errors = []
    for cfg, n, cost, kw in ((TableConfig("t", 4096, 32), 8, "test", {}),
                             (TableConfig("bw", 4096, 512, hotness=4), 4, "grid",
                              dict(grid_ok=True, col_shards=4))):
        pe = plan([cfg], n, batch=1024 if kw else 64, cost=costs[cost], **kw)
        try:
            apply_plan(pe, {cfg.name: torch.zeros((cfg.num_categories, cfg.width))}, mesh)
        except PlanError as e:
            errors.append(str(e))
    res["errors"] = errors

    # The grid placement, fixed hotness and sharded CSR.
    pg = plan([GRID_CFG], 4, batch=8192, cost=costs["small_grid"], grid_ok=True,
              col_shards=2)
    table, idx, gy = _grid_arrays()
    ib, gb = {"bw": blk(idx, ("model", None))}, {"bw": blk(gy, ("model", "data"))}
    placed = apply_plan(pg, {"bw": t(table)}, mesh)
    res["grid/plan"] = pg
    res["grid/lookup"] = planned_lookup(pg, placed, ib, mesh=mesh)["bw"]
    res["grid/sgd"] = planned_sgd_update(pg, {"bw": placed["bw"].clone()}, ib, gb,
                                         mesh=mesh, lr=LR)["bw"]
    res["grid/adagrad"] = planned_adagrad_update(
        pg, placed, planned_adagrad_init(pg, placed, mesh), ib, gb, mesh=mesh, lr=LR)
    pc = plan([GRID_CSR_CFG], 4, batch=1024, cost=costs["grid"], grid_ok=True, col_shards=2)
    table, vals, offs, gy = _grid_csr_arrays()
    ib, ob, _ = shard_csr(vals, offs, 4)
    args = dict(offsets={"bw": blk(ob, ("model", None))}, mesh=mesh)
    ib, gb = {"bw": blk(ib, ("model", None))}, {"bw": blk(gy, ("model", "data"))}
    placed = apply_plan(pc, {"bw": t(table)}, mesh)
    res["grid_csr/plan"] = pc
    res["grid_csr/lookup"] = planned_lookup(pc, placed, ib, **args)["bw"]
    res["grid_csr/sgd"] = planned_sgd_update(pc, {"bw": placed["bw"].clone()}, ib, gb, lr=LR,
                                             **args)["bw"]
    res["grid_csr/adagrad"] = planned_adagrad_update(
        pc, placed, planned_adagrad_init(pc, placed, mesh), ib, gb, lr=LR, **args)
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("planner")
    (tmp / "costs.json").write_text(json.dumps({
        "test": _jax_fields(**TEST_COST), "mixed": _jax_fields(**MIXED_COST),
        "grid": _jax_fields(**GRID_COST), "small_grid": _jax_fields(**SMALL_GRID_COST)}))
    return run_ranks(Path(__file__), "ranks", WORLD, tmp, timeout=180.0)


@pytest.fixture(scope="module")
def jmesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:WORLD]).reshape(SHAPE), ("data", "model"))


def _glob(port, get, spec):
    return assemble([np.asarray(get(r)) for r in port], spec, SHAPE)


def _assembled(port, key, p, name, what="table"):
    """Table ``name`` (``what`` = "table" or "acc") after the update ``key``,
    put back together from the ranks' blocks and cut to its rows."""
    placement = p.tables[name].placement
    rows = next(c.num_categories for c in MIXED + SMALL + [GRID_CFG, GRID_CSR_CFG]
                if c.name == name)

    def get(r):
        v = r[key]
        if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], dict):
            v = v[0] if what == "table" else v[1]
        return v[name] if isinstance(v, dict) else v

    if placement == "hybrid":
        spec = ("model", None) if what == "table" else ("model",)
        head = _glob(port, lambda r: get(r)[0], ())
        tail = _glob(port, lambda r: get(r)[1], spec)
        return np.concatenate([head, tail])[:rows]
    spec = TABLE_SPEC[placement] if what == "table" else ACC_SPEC[placement]
    return _glob(port, get, spec)[:rows]


def _jnp(d):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in d.items()}


def _jplan_mixed():
    from cuembed_tpu.parallel import plan as jplan

    _, jcost = _both(MIXED_COST)
    return jplan([_jcfg(c) for c in MIXED], 4, cost=jcost, **MIXED_KW)


def _mixed_jax(jmesh, seed):
    """JAX's plan, placed tables and inputs for the mixed case ``seed``."""
    from cuembed_tpu.parallel import apply_plan as japply

    jp = _jplan_mixed()
    tables, idx, gys = _mixed_arrays(seed, jp.tables["skewed"].hot_rows)
    return jp, tables, idx, gys, japply(jp, _jnp(tables), jmesh)


# -- the JAX side ---------------------------------------------------------------

def test_planned_lookup_matches_single_chip(port, jmesh):
    import jax
    from cuembed_tpu import embedding_lookup as jl
    from cuembed_tpu.parallel import planned_lookup as jpl

    jp, tables, idx, gys, jplaced = _mixed_jax(jmesh, 0)
    _same_plan(port[0]["mixed/plan"], jp)
    assert {tp.placement for tp in jp.tables.values()} == {
        "replicated", "row_sharded", "column_sharded", "hybrid"}
    assert all(r["mixed/hybrid_is_pair"] for r in port)
    jout = jpl(jp, jplaced, _jnp(idx), mesh=jmesh)
    for c in MIXED:
        spec = OUT_SPEC.get(jp.tables[c.name].placement, ("model", None))
        got = _glob(port, lambda r: r["mixed/lookup"][c.name], spec)
        want = np.asarray(jl(_jnp(tables)[c.name], _jnp(idx)[c.name], backend="xla"))
        np.testing.assert_allclose(got, want, **LOOKUP_TOL, err_msg=c.name)
        np.testing.assert_allclose(got, np.asarray(jout[c.name]), **LOOKUP_TOL,
                                   err_msg=c.name)
    # The replicated table's gradient (every rank the same bits) is the
    # single-device one of the global loss.
    grad = jax.grad(lambda t: (jl(t, _jnp(idx)["small"], backend="xla")
                               * _jnp(gys)["small"]).sum())(_jnp(tables)["small"])
    np.testing.assert_allclose(_glob(port, lambda r: r["mixed/small_grad"], ()),
                               np.asarray(grad), **LOOKUP_TOL)


def test_planned_sgd_matches_single_chip(port, jmesh):
    from cuembed_tpu.parallel import planned_sgd_update as jsgd
    from cuembed_tpu.train import sgd_sparse_update

    jp, tables, idx, gys, jplaced = _mixed_jax(jmesh, 1)
    jnew = jsgd(jp, jplaced, _jnp(idx), _jnp(gys), mesh=jmesh, lr=LR)
    for c in MIXED:
        tp = jp.tables[c.name]
        got = _assembled(port, "mixed/sgd", jp, c.name)
        want = sgd_sparse_update(_jnp(tables)[c.name], _jnp(idx)[c.name],
                                 _jnp(gys)[c.name], lr=LR)
        np.testing.assert_allclose(got, np.asarray(want), **UPDATE_TOL,
                                   err_msg=f"{c.name} ({tp.placement})")
        jgot = jnew[c.name]
        jgot = (np.concatenate([np.asarray(x) for x in jgot]) if isinstance(jgot, tuple)
                else np.asarray(jgot))[: c.num_categories]
        np.testing.assert_allclose(got, jgot, **UPDATE_TOL, err_msg=c.name)


def test_planned_adagrad_matches_single_chip(port, jmesh):
    import jax.numpy as jnp
    from cuembed_tpu.parallel import planned_adagrad_init as jinit
    from cuembed_tpu.parallel import planned_adagrad_update as jada
    from cuembed_tpu.train import rowwise_adagrad_sparse_update

    jp, tables, idx, gys, jplaced = _mixed_jax(jmesh, 2)
    jt, ja = jada(jp, jplaced, jinit(jp, jplaced, jmesh), _jnp(idx), _jnp(gys), mesh=jmesh,
                  lr=LR)
    for c in MIXED:
        want_t, want_a = rowwise_adagrad_sparse_update(
            _jnp(tables)[c.name], jnp.zeros((c.num_categories,), jnp.float32),
            _jnp(idx)[c.name], _jnp(gys)[c.name], lr=LR)
        got_t = _assembled(port, "mixed/adagrad", jp, c.name)
        got_a = _assembled(port, "mixed/adagrad", jp, c.name, "acc")
        np.testing.assert_allclose(got_t, np.asarray(want_t), **UPDATE_TOL, err_msg=c.name)
        np.testing.assert_allclose(got_a, np.asarray(want_a), **UPDATE_TOL, err_msg=c.name)
        for got, j in ((got_t, jt[c.name]), (got_a, ja[c.name])):
            j = (np.concatenate([np.asarray(x) for x in j]) if isinstance(j, tuple)
                 else np.asarray(j))[: c.num_categories]
            np.testing.assert_allclose(got, j, **UPDATE_TOL, err_msg=c.name)


def test_planned_replicated_replicas_stay_identical(port, jmesh):
    """After an update, every rank's replica of a replicated table is bit
    for bit the same (the all-gathered COO makes the update deterministic),
    and equals JAX's planned update."""
    import jax.numpy as jnp
    from cuembed_tpu.parallel import apply_plan as japply, plan as jplan
    from cuembed_tpu.parallel import planned_sgd_update as jsgd

    blocks = [r["replicas/sgd"] for r in port]
    for b in blocks[1:]:
        assert torch.equal(b, blocks[0])
    rng = np.random.default_rng(3)
    table = rng.standard_normal((64, 16)).astype(np.float32)
    idx = rng.integers(0, 64, (64, 4)).astype(np.int32)
    gy = rng.standard_normal((64, 16)).astype(np.float32)
    _, jcost = _both(TEST_COST)
    jp = jplan([_jcfg(c) for c in SMALL], 4, batch=64, cost=jcost)
    assert jp.tables["small"].placement == "replicated"
    want = jsgd(jp, japply(jp, {"small": jnp.asarray(table)}, jmesh),
                {"small": jnp.asarray(idx)}, {"small": jnp.asarray(gy)}, mesh=jmesh, lr=LR)
    np.testing.assert_allclose(blocks[0].numpy(), np.asarray(want["small"]), **UPDATE_TOL)


def test_apply_plan_wrong_mesh_raises(port, jmesh):
    """A plan for 8 shards on a 4-rank model axis: JAX's message."""
    import jax.numpy as jnp
    from cuembed_tpu.parallel import PlanError as JPlanError
    from cuembed_tpu.parallel import apply_plan as japply, plan as jplan

    _, jcost = _both(TEST_COST)
    jp = jplan([_jcfg(TableConfig("t", 4096, 32))], 8, batch=64, cost=jcost)
    with pytest.raises(JPlanError, match="mesh axis") as want:
        japply(jp, {"t": jnp.zeros((4096, 32))}, jmesh)
    assert all(r["errors"][0] == str(want.value) for r in port)


def test_planned_lookup_replicated_accepts_csr_blocks(port, jmesh):
    """One CSR batch layout serves every placement: the replicated branch
    takes the shard_csr blocks the routed tables need and returns the same
    [n, local_batch, W] block convention."""
    import jax.numpy as jnp
    from cuembed_tpu import embedding_lookup_csr as jlc
    from cuembed_tpu.parallel import apply_plan as japply, plan as jplan
    from cuembed_tpu.parallel import planned_lookup as jpl, shard_csr as jshard

    table, vals, offs, _ = _small_csr(5)
    got = _glob(port, lambda r: r["csr/lookup"], ("model", None, None))
    assert got.shape == (4, 4, 16)
    want = jlc(jnp.asarray(table), jnp.asarray(vals), jnp.asarray(offs))
    np.testing.assert_allclose(got.reshape(16, 16), np.asarray(want), **LOOKUP_TOL)
    _, jcost = _both(TEST_COST)
    jp = jplan([_jcfg(c) for c in SMALL], 4, batch=64, cost=jcost)
    ib, ob, _ = jshard(vals, offs, 4)
    jout = jpl(jp, japply(jp, {"small": jnp.asarray(table)}, jmesh),
               {"small": jnp.asarray(ib)}, offsets={"small": jnp.asarray(ob)}, mesh=jmesh)
    np.testing.assert_allclose(got, np.asarray(jout["small"]), **LOOKUP_TOL)


def test_planned_updates_replicated_csr_blocks(port, jmesh):
    """Replicated-table sparse SGD and AdaGrad take the same shard_csr blocks
    as routed tables; the result equals the single-chip CSR update, and the
    JAX planner's, and the replicas stay identical."""
    import jax.numpy as jnp
    from cuembed_tpu.parallel import apply_plan as japply, plan as jplan
    from cuembed_tpu.parallel import planned_adagrad_init as jinit
    from cuembed_tpu.parallel import planned_adagrad_update as jada
    from cuembed_tpu.parallel import planned_sgd_update as jsgd, shard_csr as jshard
    from cuembed_tpu.train import rowwise_adagrad_init, rowwise_adagrad_sparse_update
    from cuembed_tpu.train import sgd_sparse_update

    table, vals, offs, gy = _small_csr(6)
    jt, jv, jo, jg = (jnp.asarray(x) for x in (table, vals, offs, gy))
    sgd = _glob(port, lambda r: r["csr/sgd"], ())  # replicas equal bit for bit
    np.testing.assert_allclose(sgd, np.asarray(sgd_sparse_update(jt, jv, jg, lr=LR,
                                                                 offsets=jo)), **CSR_TOL)
    got_t = _glob(port, lambda r: r["csr/adagrad"][0]["small"], ())
    got_a = _glob(port, lambda r: r["csr/adagrad"][1]["small"], ())
    want_t, want_a = rowwise_adagrad_sparse_update(jt, rowwise_adagrad_init(64), jv, jg,
                                                   lr=LR, offsets=jo)
    np.testing.assert_allclose(got_t, np.asarray(want_t), **CSR_TOL)
    np.testing.assert_allclose(got_a, np.asarray(want_a), **CSR_TOL)

    _, jcost = _both(TEST_COST)
    jp = jplan([_jcfg(c) for c in SMALL], 4, batch=64, cost=jcost)
    ib, ob, _ = jshard(vals, offs, 4)
    args = dict(indices={"small": jnp.asarray(ib)}, offsets={"small": jnp.asarray(ob)},
                mesh=jmesh)
    placed = japply(jp, {"small": jt}, jmesh)
    js = jsgd(jp, placed, grads_y={"small": jg}, lr=LR, **args)["small"]
    np.testing.assert_allclose(sgd, np.asarray(js), **CSR_TOL)
    jt2, ja2 = jada(jp, placed, jinit(jp, placed, jmesh), grads_y={"small": jg}, lr=LR,
                    **args)
    np.testing.assert_allclose(got_t, np.asarray(jt2["small"]), **CSR_TOL)
    np.testing.assert_allclose(got_a, np.asarray(ja2["small"]), **CSR_TOL)


def test_apply_plan_grid_mesh_mismatch_raises(port, jmesh):
    """A grid plan for 4 column shards on a 2-rank data axis: JAX's message."""
    import jax.numpy as jnp
    from cuembed_tpu.parallel import PlanError as JPlanError
    from cuembed_tpu.parallel import apply_plan as japply, plan as jplan

    _, jcost = _both(GRID_COST)
    jp = jplan([_jcfg(GRID_CSR_CFG)], 4, batch=1024, cost=jcost, grid_ok=True, col_shards=4)
    assert jp.tables["bw"].placement == "grid_sharded"
    with pytest.raises(JPlanError, match="column shards") as want:
        japply(jp, {"bw": jnp.zeros((4096, 512), jnp.float32)}, jmesh)
    assert all(r["errors"][1] == str(want.value) for r in port)


def test_planned_grid_lookup_and_updates_match_single_chip(port, jmesh):
    import jax.numpy as jnp
    from cuembed_tpu import embedding_lookup as jl
    from cuembed_tpu.parallel import apply_plan as japply, plan as jplan
    from cuembed_tpu.parallel import planned_adagrad_init as jinit
    from cuembed_tpu.parallel import planned_adagrad_update as jada
    from cuembed_tpu.parallel import planned_lookup as jpl, planned_sgd_update as jsgd
    from cuembed_tpu.train import rowwise_adagrad_sparse_update, sgd_sparse_update

    V = GRID_CFG.num_categories
    _, jcost = _both(SMALL_GRID_COST)
    jp = jplan([_jcfg(GRID_CFG)], 4, batch=8192, cost=jcost, grid_ok=True, col_shards=2)
    assert jp.tables["bw"].placement == "grid_sharded"
    _same_plan(port[0]["grid/plan"], jp)
    table, idx, gy = _grid_arrays()
    jt, ji, jg = jnp.asarray(table), jnp.asarray(idx), jnp.asarray(gy)
    placed = japply(jp, {"bw": jt}, jmesh)

    got = _glob(port, lambda r: r["grid/lookup"], ("model", None))
    np.testing.assert_allclose(got, np.asarray(jl(jt, ji, backend="xla")), **LOOKUP_TOL)
    np.testing.assert_allclose(got, np.asarray(jpl(jp, placed, {"bw": ji}, mesh=jmesh)["bw"]),
                               **LOOKUP_TOL)

    new = _glob(port, lambda r: r["grid/sgd"], ("model", "data"))[:V]
    np.testing.assert_allclose(new, np.asarray(sgd_sparse_update(jt, ji, jg, lr=LR)),
                               **LOOKUP_TOL)
    js = jsgd(jp, placed, {"bw": ji}, {"bw": jg}, mesh=jmesh, lr=LR)["bw"]
    np.testing.assert_allclose(new, np.asarray(js)[:V], **LOOKUP_TOL)

    got_t = _glob(port, lambda r: r["grid/adagrad"][0]["bw"], ("model", "data"))[:V]
    got_a = _glob(port, lambda r: r["grid/adagrad"][1]["bw"], ("model",))[:V]
    want_t, want_a = rowwise_adagrad_sparse_update(jt, jnp.zeros((V,), jnp.float32), ji, jg,
                                                   lr=LR)
    np.testing.assert_allclose(got_t, np.asarray(want_t), **UPDATE_TOL)
    np.testing.assert_allclose(got_a, np.asarray(want_a), **UPDATE_TOL)
    jt2, ja2 = jada(jp, placed, jinit(jp, placed, jmesh), {"bw": ji}, {"bw": jg},
                    mesh=jmesh, lr=LR)
    np.testing.assert_allclose(got_t, np.asarray(jt2["bw"])[:V], **UPDATE_TOL)
    np.testing.assert_allclose(got_a, np.asarray(ja2["bw"])[:V], **UPDATE_TOL)


def test_planned_grid_csr_lookup_and_update(port):
    """CSR-trained tables keep the grid placement: sharded-CSR blocks flow
    through the planned grid lookup and sparse updates, matching the
    single-chip CSR semantics and JAX's planner on its (4, 2) mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from cuembed_tpu.ops.api import embedding_lookup_csr as jlc
    from cuembed_tpu.parallel import apply_plan as japply, plan as jplan
    from cuembed_tpu.parallel import planned_adagrad_init as jinit
    from cuembed_tpu.parallel import planned_adagrad_update as jada
    from cuembed_tpu.parallel import planned_lookup as jpl, planned_sgd_update as jsgd
    from cuembed_tpu.parallel import shard_csr as jshard
    from cuembed_tpu.train import rowwise_adagrad_sparse_update, sgd_sparse_update

    V, W, B = GRID_CSR_CFG.num_categories, GRID_CSR_CFG.width, 64
    _, jcost = _both(GRID_COST)
    jp = jplan([_jcfg(GRID_CSR_CFG)], 4, batch=1024, cost=jcost, grid_ok=True, col_shards=2)
    assert jp.tables["bw"].placement == "grid_sharded"
    _same_plan(port[0]["grid_csr/plan"], jp)
    table, vals, offs, gy = _grid_csr_arrays()
    jt, jv, jo, jg = (jnp.asarray(x) for x in (table, vals, offs, gy))

    got = _glob(port, lambda r: r["grid_csr/lookup"], ("model", None, None)).reshape(B, W)
    np.testing.assert_allclose(got, np.asarray(jlc(jt, jv, jo, backend="xla")), **LOOKUP_TOL)
    new = _glob(port, lambda r: r["grid_csr/sgd"], ("model", "data"))[:V]
    np.testing.assert_allclose(new, np.asarray(sgd_sparse_update(jt, jv, jg, lr=LR,
                                                                 offsets=jo)), **UPDATE_TOL)
    got_t = _glob(port, lambda r: r["grid_csr/adagrad"][0]["bw"], ("model", "data"))[:V]
    got_a = _glob(port, lambda r: r["grid_csr/adagrad"][1]["bw"], ("model",))[:V]
    want_t, want_a = rowwise_adagrad_sparse_update(jt, jnp.zeros((V,), jnp.float32), jv, jg,
                                                   lr=LR, offsets=jo)
    np.testing.assert_allclose(got_t, np.asarray(want_t), **UPDATE_TOL)
    np.testing.assert_allclose(got_a, np.asarray(want_a), **UPDATE_TOL)

    m = Mesh(np.array(jax.devices()[:WORLD]).reshape(4, 2), ("model", "data"))
    ib, ob, _ = jshard(vals, offs, 4)
    sh = NamedSharding(m, P("model", None))
    ibs, obs = jax.device_put(jnp.asarray(ib), sh), jax.device_put(jnp.asarray(ob), sh)
    gys = jax.device_put(jg, NamedSharding(m, P("model", "data")))
    placed = japply(jp, {"bw": jt}, m)
    jout = jpl(jp, placed, {"bw": ibs}, offsets={"bw": obs}, mesh=m)["bw"]
    np.testing.assert_allclose(got, np.asarray(jout).reshape(B, W), **LOOKUP_TOL)
    js = jsgd(jp, placed, {"bw": ibs}, {"bw": gys}, offsets={"bw": obs}, mesh=m, lr=LR)
    np.testing.assert_allclose(new, np.asarray(js["bw"])[:V], **UPDATE_TOL)
    jt2, ja2 = jada(jp, placed, jinit(jp, placed, m), {"bw": ibs}, {"bw": gys},
                    offsets={"bw": obs}, mesh=m, lr=LR)
    np.testing.assert_allclose(got_t, np.asarray(jt2["bw"])[:V], **UPDATE_TOL)
    np.testing.assert_allclose(got_a, np.asarray(ja2["bw"])[:V], **UPDATE_TOL)
