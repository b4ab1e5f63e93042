"""The port's sharded multi-table entry points (``EmbeddingCollection.shard``,
``adagrad_init_sharded``, ``apply_sharded``, ``sgd_update_sharded``,
``adagrad_update_sharded``; ``fused_sharded_lookup``,
``fused_sharded_sgd_update``, ``fused_sharded_adagrad_update``) against
``cuembed_tpu``'s on the same numpy tables and batches, the cases of
``tests/test_collection.py::test_collection_sharded_flow``,
``tests/test_fused.py::test_fused_sharded_matches_per_table`` and
``tests/test_multitable_sharded.py``.

The port runs on 4 spawned gloo ranks routing over a 4-rank ``model`` axis
(one spawn for the file, ``tests/torch_dist.py``); JAX on 4 of its 8 virtual
CPU devices. Also: the fused group's routed lookup and AdaGrad update equal
the per-table routed calls bit for bit on the plain path (the same rows
reach each owner in the same order; on the card K3 adds a run's pieces at
tile edges, which fall elsewhere in the fused stream, so there
``chip_smoke.py`` holds the updates to the float64 step), and one training
step of 8 routed tables with a dense
layer (each rank's loss its share of the global mean) equals the
single-device step.

Tolerances: the JAX tests' (rtol = atol = 1e-5; AdaGrad tables 1e-4 and
1e-5, accumulators 1e-5 and 1e-6).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_dist import run_ranks

import cuembed_tpu_torch as tce
from cuembed_tpu_torch import CombineMode, EmbeddingCollection, TableConfig
from cuembed_tpu_torch.parallel import (
    alltoall_row_sharded_lookup,
    assemble,
    local_block,
    make_mesh,
    pad_table_for_shards,
    sharded_rowwise_adagrad_sparse_update,
)

WORLD = 4
SHAPE = (1, 4)
TOL = dict(rtol=1e-5, atol=1e-5)
LR = 0.1
N_TABLES, V8, W8, B8, H8 = 8, 512, 16, 64, 4


def _coll_problem():
    rng = np.random.default_rng(0)
    tables = {"a": rng.standard_normal((777, 16)).astype(np.float32),
              "b": rng.standard_normal((512, 32)).astype(np.float32)}
    idx = {"a": rng.integers(0, 777, (64, 4)).astype(np.int32),
           "b": rng.integers(0, 512, (64, 2)).astype(np.int32)}
    gy = {k: rng.standard_normal((64, tables[k].shape[1])).astype(np.float32) for k in idx}
    return tables, idx, gy


def _fused_problem():
    rng = np.random.default_rng(9)
    sizes, hotness = [64, 128, 32, 96], [4, 2, 4, 3]
    names = [f"t{i}" for i in range(4)]
    tables = {n: rng.standard_normal((v, 16)).astype(np.float32)
              for n, v in zip(names, sizes)}
    hot = dict(zip(names, hotness))
    idx = {n: rng.integers(0, v, (32, hot[n])).astype(np.int32)
           for n, v in zip(names, sizes)}
    gys = {n: rng.standard_normal((32, 16)).astype(np.float32) for n in names}
    return names, tables, hot, idx, gys


def _step_problem():
    rng = np.random.default_rng(0)
    tables = [rng.standard_normal((V8, W8)).astype(np.float32) for _ in range(N_TABLES)]
    idx = [rng.integers(0, V8, (B8, H8)).astype(np.int32) for _ in range(N_TABLES)]
    dense_w = rng.standard_normal((N_TABLES * W8, 1)).astype(np.float32)
    labels = rng.integers(0, 2, B8).astype(np.float32)
    return tables, idx, dense_w, labels


def _coll():
    return EmbeddingCollection([TableConfig("a", 777, 16), TableConfig("b", 512, 32)])


def _bce_sum(logits, labels):
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).sum()


# -- the ranks ----------------------------------------------------------------

def ranks(rank, world, tmp):
    mesh = make_mesh(n_model=4, device_type="cpu")
    t = torch.from_numpy

    def rows(x):
        return local_block(t(x), mesh, ("model", None)).contiguous()

    res = {}
    # The collection's flow.
    coll = _coll()
    tables, idx, gy = _coll_problem()
    st = coll.shard({k: t(v) for k, v in tables.items()}, mesh)
    sa = coll.adagrad_init_sharded(mesh, device="cpu")
    sidx = {k: rows(v) for k, v in idx.items()}
    sgy = {k: rows(v) for k, v in gy.items()}
    res["coll/apply"] = coll.apply_sharded(st, sidx, mesh=mesh)
    st_sgd = coll.sgd_update_sharded({k: v.clone() for k, v in st.items()}, sidx, sgy,
                                     mesh=mesh, lr=LR)
    res["coll/sgd"] = st_sgd
    res["coll/adagrad"] = coll.adagrad_update_sharded(st, sa, sidx, sgy, mesh=mesh, lr=LR)

    # The fused group, SUM and MEAN.
    names, tabs, hot, fidx, gys = _fused_problem()
    fused, spec = tce.fuse_tables({n: t(v) for n, v in tabs.items()}, hot)
    fs = local_block(pad_table_for_shards(fused, 4), mesh, ("model", None)).contiguous()
    fi = {n: rows(v) for n, v in fidx.items()}
    fg = {n: rows(v) for n, v in gys.items()}
    for mode in (CombineMode.SUM, CombineMode.MEAN):
        m = mode.value
        res[f"fused/lookup/{m}"] = tce.fused_sharded_lookup(fs, spec, fi, mesh=mesh, mode=mode)
        res[f"fused/sgd/{m}"] = tce.fused_sharded_sgd_update(fs.clone(), spec, fi, fg,
                                                             mesh=mesh, lr=LR, mode=mode)
        res[f"fused/adagrad/{m}"] = tce.fused_sharded_adagrad_update(
            fs.clone(), torch.zeros(fs.shape[0]), spec, fi, fg, mesh=mesh, lr=LR, mode=mode)

    # The fused group against the per-table routed calls, bit for bit (one
    # hotness: no coefficients on either side).
    same = {n: 4 for n in names}
    fused4, spec4 = tce.fuse_tables({n: t(v) for n, v in tabs.items()}, same)
    f4 = local_block(pad_table_for_shards(fused4, 4), mesh, ("model", None)).contiguous()
    ids4 = {n: rows(np.random.default_rng(i).integers(0, tabs[n].shape[0], (32, 4))
                    .astype(np.int32)) for i, n in enumerate(names)}
    got = tce.fused_sharded_lookup(f4, spec4, ids4, mesh=mesh)
    pieces = tce.unfuse_table(fused4, spec4)
    per_blocks = {n: local_block(pad_table_for_shards(pieces[n], 4), mesh,
                                 ("model", None)).contiguous() for n in names}
    want = {n: alltoall_row_sharded_lookup(
        per_blocks[n], ids4[n] + 0, mesh=mesh) for n in names}
    res["fused/bits/lookup"] = all(torch.equal(got[n], want[n]) for n in names)
    gys4 = {n: rows(np.random.default_rng(10 + i).standard_normal((32, 16))
                    .astype(np.float32)) for i, n in enumerate(names)}
    res["fused/bits/adagrad"] = tce.fused_sharded_adagrad_update(
        f4.clone(), torch.zeros(f4.shape[0]), spec4, ids4, gys4, mesh=mesh, lr=LR)
    res["per/bits/adagrad"] = {n: sharded_rowwise_adagrad_sparse_update(
        per_blocks[n].clone(), torch.zeros(per_blocks[n].shape[0]), ids4[n], gys4[n],
        mesh=mesh, lr=LR) for n in names}

    # One training step of 8 routed tables and a dense layer.
    tables8, idx8, dense_w, labels = _step_problem()
    tl = [rows(x).requires_grad_() for x in tables8]
    dw = t(dense_w).requires_grad_()
    pooled = [alltoall_row_sharded_lookup(a, rows(i), mesh=mesh) for a, i in zip(tl, idx8)]
    logits = (torch.cat(pooled, dim=1) @ dw)[:, 0]
    # This rank's share of the global mean: the shares sum to the loss.
    loss = _bce_sum(logits, rows(labels[:, None])[:, 0]) / B8
    loss.backward()
    res["step/loss"] = loss.detach()
    res["step/tables"] = [(a - LR * a.grad).detach() for a in tl]
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks(Path(__file__), "ranks", WORLD, tmp_path_factory.mktemp("multi"))


def _rows(port, get):
    return assemble([get(r).numpy() for r in port], ("model", None), SHAPE)


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:WORLD]), ("model",))


# -- the JAX side ---------------------------------------------------------------

def test_collection_sharded_flow(port):
    """shard, apply_sharded and adagrad_update_sharded equal JAX's (and JAX's
    single-chip collection); sgd_update_sharded equals JAX's single-chip
    sgd_update."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from cuembed_tpu.collection import EmbeddingCollection as JColl
    from cuembed_tpu.collection import TableConfig as JConfig

    mesh = _jax_mesh()
    coll = JColl([JConfig("a", 777, 16), JConfig("b", 512, 32)])
    tables, idx, gy = _coll_problem()
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    st = coll.shard(jt, mesh)
    sh2 = NamedSharding(mesh, P("model", None))
    sidx = {k: jax.device_put(jnp.asarray(v), sh2) for k, v in idx.items()}
    sgy = {k: jax.device_put(jnp.asarray(v), sh2) for k, v in gy.items()}
    want_out = coll.apply_sharded(st, sidx, mesh=mesh)
    want_t, want_a = coll.adagrad_update_sharded(st, coll.adagrad_init_sharded(mesh), sidx,
                                                 sgy, mesh=mesh, lr=LR)
    one_t = coll.sgd_update(jt, {k: jnp.asarray(v) for k, v in idx.items()},
                            {k: jnp.asarray(v) for k, v in gy.items()}, lr=LR)
    for k in idx:
        V = tables[k].shape[0]
        np.testing.assert_allclose(_rows(port, lambda r: r["coll/apply"][k]),
                                   np.asarray(want_out[k]), **TOL)
        got_t = _rows(port, lambda r: r["coll/adagrad"][0][k])
        got_a = assemble([r["coll/adagrad"][1][k].numpy() for r in port], ("model",), SHAPE)
        assert got_t.shape[0] == got_a.shape[0] == -(-V // 4) * 4  # padded rows
        np.testing.assert_allclose(got_t[:V], np.asarray(want_t[k])[:V], **TOL)
        np.testing.assert_allclose(got_a[:V], np.asarray(want_a[k])[:V], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_rows(port, lambda r: r["coll/sgd"][k])[:V],
                                   np.asarray(one_t[k]), **TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_fused_sharded_matches_per_table(port, mode):
    import jax.numpy as jnp
    from cuembed_tpu import embedding_lookup as jl, fuse_tables as jfuse
    from cuembed_tpu import fused_adagrad_update as jada, fused_sgd_update as jsgd
    from cuembed_tpu.types import CombineMode as J

    jm = J(mode)
    names, tables, hot, idx, gys = _fused_problem()
    jt = {n: jnp.asarray(v) for n, v in tables.items()}
    ji = {n: jnp.asarray(v) for n, v in idx.items()}
    jg = {n: jnp.asarray(v) for n, v in gys.items()}
    for n in names:
        got = _rows(port, lambda r: r[f"fused/lookup/{mode}"][n])
        np.testing.assert_allclose(got, np.asarray(jl(jt[n], ji[n], mode=jm, backend="xla")),
                                   **TOL, err_msg=n)
    fused, spec = jfuse(jt, hot)
    rows = spec.total_rows
    want = np.asarray(jsgd(fused, spec, ji, jg, lr=LR, mode=jm))
    np.testing.assert_allclose(_rows(port, lambda r: r[f"fused/sgd/{mode}"])[:rows], want,
                               **TOL)
    want_t, want_a = jada(fused, jnp.zeros((rows,), jnp.float32), spec, ji, jg, lr=LR,
                          mode=jm)
    got_t = _rows(port, lambda r: r[f"fused/adagrad/{mode}"][0])[:rows]
    got_a = assemble([r[f"fused/adagrad/{mode}"][1].numpy() for r in port], ("model",),
                     SHAPE)[:rows]
    np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_a, np.asarray(want_a), rtol=1e-4, atol=1e-5)


def test_fused_sharded_lookup_matches_jax_sharded(port):
    """The port's fused routed lookup against JAX's ``fused_sharded_lookup``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from cuembed_tpu import fuse_tables as jfuse, fused_sharded_lookup as jfsl
    from cuembed_tpu.parallel import pad_table_for_shards as jpad

    mesh = _jax_mesh()
    names, tables, hot, idx, _ = _fused_problem()
    fused, spec = jfuse({n: jnp.asarray(v) for n, v in tables.items()}, hot)
    fs = jax.device_put(jpad(fused, 4), NamedSharding(mesh, P("model", None)))
    want = jfsl(fs, spec, {n: jnp.asarray(v) for n, v in idx.items()}, mesh=mesh)
    for n in names:
        np.testing.assert_allclose(_rows(port, lambda r: r["fused/lookup/sum"][n]),
                                   np.asarray(want[n]), **TOL)


def test_fused_sharded_equals_per_table_bits(port):
    """The fused group's routed lookup and AdaGrad update equal the
    per-table routed calls bit for bit (tables and accumulators) on the
    plain path, which adds each row's terms one by one in stream order."""
    assert all(r["fused/bits/lookup"] for r in port)
    names, tables, _, _, _ = _fused_problem()
    fused = _rows(port, lambda r: r["fused/bits/adagrad"][0])
    acc = assemble([r["fused/bits/adagrad"][1].numpy() for r in port], ("model",), SHAPE)
    base = 0
    for n in names:
        V = tables[n].shape[0]
        np.testing.assert_array_equal(fused[base:base + V],
                                      _rows(port, lambda r: r["per/bits/adagrad"][n][0])[:V])
        np.testing.assert_array_equal(acc[base:base + V], assemble(
            [r["per/bits/adagrad"][n][1].numpy() for r in port], ("model",), SHAPE)[:V])
        base += V


def test_eight_sharded_tables_alltoall_train_step(port):
    """One step through 8 routed tables and a dense layer: the loss and the
    SGD-updated tables equal the single-device step's."""
    import jax
    import jax.numpy as jnp
    from cuembed_tpu import embedding_lookup as jl

    tables, idx, dense_w, labels = _step_problem()

    def loss_single(params):
        tabs, dw = params
        feats = jnp.concatenate([jl(t, i, backend="xla") for t, i in zip(tabs, idx)], axis=1)
        logits = (feats @ dw)[:, 0]
        return jnp.mean(jnp.maximum(logits, 0) - logits * labels
                        + jnp.log1p(jnp.exp(-jnp.abs(logits))))

    loss_ref, grads = jax.value_and_grad(loss_single)(
        ([jnp.asarray(t) for t in tables], jnp.asarray(dense_w)))
    loss = sum(float(r["step/loss"]) for r in port)
    np.testing.assert_allclose(loss, float(loss_ref), rtol=1e-5)
    for i, (t, g) in enumerate(zip(tables, grads[0])):
        got = _rows(port, lambda r: r["step/tables"][i])
        np.testing.assert_allclose(got, t - LR * np.asarray(g), rtol=1e-4, atol=1e-5)
