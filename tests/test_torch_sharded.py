"""The port's row- and column-sharded lookups (``cuembed_tpu_torch.parallel.
sharded_lookup``) and the mesh helpers against ``cuembed_tpu.parallel`` on
the same numpy inputs.

The port runs on 4 spawned gloo ranks as a ``(data, model) = (2, 2)`` mesh
(one spawn for the whole file, ``tests/torch_dist.py``); JAX runs the same
mesh on 4 of its 8 virtual CPU devices. Each rank's blocks are put back
together (replicas must agree bit for bit) and held to the JAX result.

Covered: row sharding under SUM (weighted), MEAN and CONCAT, flat CSR
(replicated) and sharded CSR (``shard_csr`` blocks over ``data``), with a
local tiered config; column sharding with and without the all-gather, and
flat CSR; the table and weights gradients of both against JAX's sharded
gradient and the single-device gradient (a wrong factor from a collective
shows on this multi-axis mesh); ``make_mesh``'s shapes, ``local_block``,
``pad_table_for_shards`` and ``shard_csr``; the multi-rank dry run
(``parallel/dryrun.py``) and ``examples/train_dlrm_sharded_torch.py`` on 4
ranks against one.

Tolerances: integer-valued tables with power-of-two weights keep every sum
exact: bit for bit. Random reals: the JAX tests' (``tests/test_sharded.py``:
rtol = atol = 1e-6 forward, 1e-5 gradients; ``tests/test_csr_sharded.py``:
2e-5 for sharded CSR).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_dist import run_ranks

from cuembed_tpu_torch import CombineMode
from cuembed_tpu_torch.parallel import (
    assemble,
    batch_sharding,
    column_sharded_lookup,
    local_block,
    make_mesh,
    pad_table_for_shards,
    row_sharded_lookup,
    shard_csr,
    table_sharding,
)
from cuembed_tpu_torch.parallel.sharding import mesh_shape
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)

SHAPE = (2, 2)  # (data, model)
WORLD = 4
FWD = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)
CSR = dict(rtol=2e-5, atol=2e-5)
MODES = {"sum": CombineMode.SUM, "mean": CombineMode.MEAN, "concat": CombineMode.CONCAT}


def _fixed(seed, integer):
    rng = np.random.default_rng(seed)
    if integer:
        table = rng.integers(-8, 9, (1000, 32)).astype(np.float32)
    else:
        table = rng.standard_normal((1000, 32)).astype(np.float32)
    idx = rng.integers(0, 1000, size=(64, 8)).astype(np.int32)
    w = np.where(rng.random((64, 8)) < 0.5, 0.5, 0.25).astype(np.float32)
    return table, idx, w


def _csr(seed, batch=16, V=512, W=32, max_hot=6, weighted=False):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, W)).astype(np.float32)
    hots = rng.integers(0, max_hot + 1, batch)
    offsets = np.concatenate([[0], np.cumsum(hots)]).astype(np.int32)
    nnz = int(offsets[-1])
    idx = rng.integers(0, V, nnz).astype(np.int32)
    w = rng.choice([0.5, 0.25, 1.0], nnz).astype(np.float32) if weighted else None
    return table, idx, offsets, w


def _flat_csr(seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((512, 16)).astype(np.float32)
    per = rng.integers(0, 6, 64)
    offsets = np.concatenate([[0], np.cumsum(per)]).astype(np.int32)
    cap = int(offsets[-1]) + 8 - int(offsets[-1]) % 8
    idx = rng.integers(0, 512, cap).astype(np.int32)
    return table, idx, offsets


def _tiered_problem():
    rng = np.random.default_rng(40)
    V, W, B, H = 4096, 128, 64, 8
    table = rng.standard_normal((V, W)).astype(np.float32)
    r = rng.random((B, H))
    idx = np.minimum((r ** 4 * V).astype(np.int32), V - 1)
    return table, idx


TIERED = dict(hot_rows=512, chunk_elems=64, cold_slots=64, mxu_head_rows=64, mid_slots=64)
ROW_CASES = [(m, i) for m in ("sum", "mean", "concat") for i in (False, True)]
CSR_CASES = [("sum", False), ("sum", True), ("mean", False)]


# -- the ranks ----------------------------------------------------------------

def ranks(rank, world, tmp):
    """Every case of the file on this rank; returns {case: block}."""
    mesh = make_mesh(n_model=SHAPE[1], device_type="cpu")
    t = torch.from_numpy
    res = {"mesh": (mesh.size(0), mesh.size(1))}
    row_spec, col_spec = table_sharding(mesh), table_sharding(mesh, column=True)
    bspec = batch_sharding(mesh) + (None,)

    def block(x, spec):
        return local_block(t(x), mesh, spec).contiguous()

    for mode, integer in ROW_CASES:
        table, idx, w = _fixed(0, integer)
        weights = block(w, bspec) if mode == "sum" else None
        res[f"row/{mode}/{integer}"] = row_sharded_lookup(
            block(pad_table_for_shards(table, SHAPE[1]), row_spec), block(idx, bspec),
            weights, mesh=mesh, mode=MODES[mode])

    # Gradients: the table's and the weights', loss sum(out ** 2).
    table, idx, w = _fixed(0, False)
    tl = block(pad_table_for_shards(table, SHAPE[1]), row_spec).requires_grad_()
    wl = block(w, bspec).requires_grad_()
    (row_sharded_lookup(tl, block(idx, bspec), wl, mesh=mesh) ** 2).sum().backward()
    res["row/grad/table"], res["row/grad/w"] = tl.grad, wl.grad
    tc = block(table, col_spec).requires_grad_()
    wc = block(w, bspec).requires_grad_()
    (column_sharded_lookup(tc, block(idx, bspec), wc, mesh=mesh) ** 2).sum().backward()
    res["col/grad/table"], res["col/grad/w"] = tc.grad, wc.grad

    table, idx, offsets = _flat_csr(1)
    res["row/flat_csr"] = row_sharded_lookup(
        block(table, row_spec), t(idx), None, t(offsets), mesh=mesh,
        mode=CombineMode.MEAN)
    res["col/flat_csr"] = column_sharded_lookup(
        block(table, col_spec), t(idx), None, t(offsets), mesh=mesh,
        mode=CombineMode.MEAN)

    for mode, weighted in CSR_CASES:
        table, idx, offsets, w = _csr(2, weighted=weighted)
        ib, ob, wb = shard_csr(idx, offsets, SHAPE[0], w)
        res[f"row/sharded_csr/{mode}/{weighted}"] = row_sharded_lookup(
            block(table, row_spec), block(ib, bspec),
            None if wb is None else block(wb, bspec), block(ob, bspec),
            mesh=mesh, mode=MODES[mode])

    table, idx, _ = _fixed(3, False)
    for gather in (True, False):
        res[f"col/{gather}"] = column_sharded_lookup(
            block(table, col_spec), block(idx, bspec), mesh=mesh, gather_output=gather)

    from cuembed_tpu_torch.ops.tiered import TieredConfig

    table, idx = _tiered_problem()
    res["row/tiered"] = row_sharded_lookup(
        block(table, row_spec), block(idx, bspec), mesh=mesh,
        tiered_cfg=TieredConfig(**TIERED))

    from cuembed_tpu_torch.parallel import dryrun, multihost

    multihost.initialize()  # a no-op: the group is up
    pod = multihost.pod_mesh(device_type="cpu")
    res["pod_mesh"] = (pod.size(0), pod.size(1), pod.mesh_dim_names)

    res["dryrun"] = dryrun.step(torch.device("cpu"))
    example = _example()
    res["example"] = example.train(example.parse_args(EXAMPLE_ARGS), torch.device("cpu"),
                                   record=EXAMPLE_RECORD)
    return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in res.items()}


EXAMPLE_ARGS = ["--steps", "3", "--categories", "1000", "--batch", "64", "--device", "cpu"]
EXAMPLE_RECORD = (0, 2)  # the steps whose blocks the ranks return


def _example():
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "examples" / "train_dlrm_sharded_torch.py"
    spec = importlib.util.spec_from_file_location("train_dlrm_sharded_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks(Path(__file__), "ranks", WORLD, tmp_path_factory.mktemp("sharded"))


def _blocks(port, key):
    return [r[key].numpy() for r in port]


# -- the JAX side ---------------------------------------------------------------

def _jax_mesh():
    import jax
    from cuembed_tpu.parallel import make_mesh as jmake

    return jmake(n_model=SHAPE[1], devices=jax.devices()[:WORLD])


def _jmode(mode):
    from cuembed_tpu.types import CombineMode as J

    return J(MODES[mode].value)


def _put(x, mesh, spec):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(x, NamedSharding(mesh, P(*spec)))


@pytest.mark.parametrize("mode,integer", ROW_CASES)
def test_row_sharded_matches_jax(port, mode, integer):
    from cuembed_tpu.parallel import pad_table_for_shards as jpad, row_sharded_lookup as jrow

    m = _jax_mesh()
    table, idx, w = _fixed(0, integer)
    got = assemble(_blocks(port, f"row/{mode}/{integer}"), ("data", None), SHAPE)
    want = np.asarray(jrow(_put(jpad(table, SHAPE[1]), m, ("model", None)),
                           _put(idx, m, ("data", None)),
                           _put(w, m, ("data", None)) if mode == "sum" else None,
                           mesh=m, mode=_jmode(mode)))
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **FWD)


@pytest.mark.parametrize("layout", ["row", "col"])
def test_sharded_grads_match_single_device(port, layout):
    """Table and weights gradients equal JAX's sharded gradient and the
    single-device gradient, so neither the all-reduce over ``model`` nor the
    data replicas of the shard add a factor."""
    import jax
    import jax.numpy as jnp
    from cuembed_tpu import embedding_lookup as jlookup
    from cuembed_tpu.parallel import column_sharded_lookup as jcol, row_sharded_lookup as jrow

    m = _jax_mesh()
    table, idx, w = _fixed(0, False)
    tspec = ("model", None) if layout == "row" else (None, "model")
    fn = jrow if layout == "row" else jcol
    idx_s, w_s = _put(idx, m, ("data", None)), _put(w, m, ("data", None))
    jt, jw = jax.grad(lambda t, w_: jnp.sum(fn(t, idx_s, w_, mesh=m) ** 2),
                      argnums=(0, 1))(_put(table, m, tspec), w_s)
    st, sw = jax.grad(lambda t, w_: jnp.sum(jlookup(t, idx, w_, backend="xla") ** 2),
                      argnums=(0, 1))(jnp.asarray(table), jnp.asarray(w))
    got_t = assemble(_blocks(port, f"{layout}/grad/table"), tspec, SHAPE)
    got_w = assemble(_blocks(port, f"{layout}/grad/w"), ("data", None), SHAPE)
    for want in (np.asarray(jt), np.asarray(st)):
        np.testing.assert_allclose(got_t, want, **GRAD)
    for want in (np.asarray(jw), np.asarray(sw)):
        np.testing.assert_allclose(got_w, want, **GRAD)


@pytest.mark.parametrize("layout", ["row", "col"])
def test_flat_csr_matches_jax(port, layout):
    from cuembed_tpu.parallel import column_sharded_lookup as jcol, row_sharded_lookup as jrow
    from cuembed_tpu.types import CombineMode as J

    m = _jax_mesh()
    table, idx, offsets = _flat_csr(1)
    fn, tspec = (jrow, ("model", None)) if layout == "row" else (jcol, (None, "model"))
    want = np.asarray(fn(_put(table, m, tspec), idx, None, offsets, mesh=m, mode=J.MEAN))
    got = assemble(_blocks(port, f"{layout}/flat_csr"), (None, None), SHAPE)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode,weighted", CSR_CASES)
def test_row_sharded_csr_data_axis(port, mode, weighted):
    from cuembed_tpu.parallel import row_sharded_lookup as jrow, shard_csr as jshard

    m = _jax_mesh()
    table, idx, offsets, w = _csr(2, weighted=weighted)
    ib, ob, wb = jshard(idx, offsets, SHAPE[0], w)
    want = np.asarray(jrow(_put(table, m, ("model", None)), _put(ib, m, ("data", None)),
                           None if wb is None else _put(wb, m, ("data", None)),
                           _put(ob, m, ("data", None)), mesh=m, mode=_jmode(mode)))
    got = assemble(_blocks(port, f"row/sharded_csr/{mode}/{weighted}"),
                   ("data", None, None), SHAPE)
    np.testing.assert_allclose(got, want, **CSR)


@pytest.mark.parametrize("gather", [True, False])
def test_column_sharded_matches_jax(port, gather):
    from cuembed_tpu.parallel import column_sharded_lookup as jcol

    m = _jax_mesh()
    table, idx, _ = _fixed(3, False)
    want = np.asarray(jcol(_put(table, m, (None, "model")), _put(idx, m, ("data", None)),
                           mesh=m, gather_output=gather))
    spec = ("data", None) if gather else ("data", "model")
    np.testing.assert_allclose(assemble(_blocks(port, f"col/{gather}"), spec, SHAPE),
                               want, **FWD)


def test_row_sharded_tiered_local_engine(port):
    from cuembed_tpu.ops.tiered import TieredConfig as JT
    from cuembed_tpu.parallel import row_sharded_lookup as jrow

    m = _jax_mesh()
    table, idx = _tiered_problem()
    want = np.asarray(jrow(_put(table, m, ("model", None)), _put(idx, m, ("data", None)),
                           mesh=m, tiered_cfg=JT(**TIERED)))
    np.testing.assert_allclose(assemble(_blocks(port, "row/tiered"), ("data", None),
                                        SHAPE), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_make_mesh_shapes(port, n):
    """``mesh_shape`` gives JAX's ``make_mesh`` factorization, and the
    ranks built that mesh."""
    import jax
    from cuembed_tpu.parallel.sharding import make_mesh as jmake

    if n <= len(jax.devices()):
        jm = jmake(devices=jax.devices()[:n])
        assert mesh_shape(n) == (jm.shape["data"], jm.shape["model"])
    else:  # JAX's rule, written out: model takes the larger half of 2^k
        assert mesh_shape(n) == (4, 4)
    assert all(r["mesh"] == SHAPE for r in port)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_shape(6, n_model=4)


def test_shard_csr_and_padding_match_jax():
    import jax.numpy as jnp
    from cuembed_tpu.parallel import pad_table_for_shards as jpad, shard_csr as jshard

    _, idx, offsets, w = _csr(5, batch=24, weighted=True)
    for got, want in zip(shard_csr(idx, offsets, 4, w), jshard(idx, offsets, 4, w)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="divide evenly"):
        shard_csr(idx, offsets, 5)
    table = np.arange(30, dtype=np.float32).reshape(10, 3)
    np.testing.assert_array_equal(pad_table_for_shards(table, 4),
                                  np.asarray(jpad(jnp.asarray(table), 4)))
    np.testing.assert_array_equal(pad_table_for_shards(torch.from_numpy(table), 4).numpy(),
                                  pad_table_for_shards(table, 4))


def test_dryrun_step(port):
    """``parallel/dryrun.py``: one DLRM step row-sharded over the (2, 2)
    mesh, finite and equal on every rank, and the routed lookup's forward
    and gradient equal to the unsharded ones."""
    res = [r["dryrun"] for r in port]
    assert all(r == res[0] for r in res)
    assert res[0]["mesh"] == SHAPE and np.isfinite(res[0]["loss"])
    assert res[0]["device"] == "cpu"
    assert res[0]["forward_err"] <= 1e-5 and res[0]["grad_err"] <= 1e-4


def test_sharded_example_matches_one_rank(port, tmp_path):
    """``examples/train_dlrm_sharded_torch.py`` on 4 ranks takes the losses
    of the same run on one rank: the first bit for bit, the others within
    rtol 1e-3 (the routed sums and the dense gradients' all-reduce add in
    another order, and the towers round their operands to bf16, where a
    last-bit change of a weight can flip a rounding)."""
    import torch.distributed as dist

    example = _example()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        one = example.train(example.parse_args(EXAMPLE_ARGS), torch.device("cpu"))
    finally:
        dist.destroy_process_group()
    four = [r["example"]["losses"] for r in port]
    assert all(f == four[0] for f in four)
    assert four[0][0] == one["losses"][0]
    np.testing.assert_allclose(four[0], one["losses"], rtol=1e-3)
    assert len(one["losses"]) == 3 and np.isfinite(one["losses"]).all()


@pytest.mark.parametrize("step", EXAMPLE_RECORD)
def test_sharded_example_step_replays_on_one_table(port, step):
    """A step of ``examples/train_dlrm_sharded_torch.py`` on 4 ranks, its
    blocks put back together and replayed on one table per embedding table
    on the plain path (``embedding_lookup`` and
    ``rowwise_adagrad_sparse_update``, ``backend="xla"``) with the same ids
    and pooled-output gradients: the routed lookups and AdaGrad updates
    within the JAX tests' tolerances for random reals (rtol = atol = 1e-6
    forward, 1e-5 for a step), and every table moved."""
    import cuembed_tpu_torch as tce
    from cuembed_tpu_torch import train

    recs = [r["example"]["record"][step] for r in port]
    for nm in recs[0]["ids"]:
        def glob(key, spec):
            return assemble([r[key][nm] for r in recs], spec, (1, WORLD))

        rows, vec = ("model", None), ("model",)
        before, acc = glob("tables", rows).clone(), glob("accums", vec).clone()
        ids, gy = glob("ids", rows), glob("grads", rows)
        np.testing.assert_allclose(glob("pooled", rows).numpy(),
                                   tce.embedding_lookup(before, ids, backend="xla").numpy(),
                                   rtol=1e-6, atol=1e-6)
        after = before.clone()
        train.rowwise_adagrad_sparse_update(after, acc, ids, gy, lr=0.05, backend="xla")
        np.testing.assert_allclose(glob("tables_after", rows).numpy(), after.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(glob("accums_after", vec).numpy(), acc.numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert not torch.equal(after, before)


@pytest.mark.parametrize("spec", [("model", None), ("data", None), (None, "model"),
                                  ("model", "data"), ("data", "model"), (None,), ()])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_assemble_inverts_the_block_cut(spec, as_tensor):
    """``sharding.assemble`` puts back together the blocks that each rank of
    the (2, 2) mesh cuts under ``spec`` (row-major ranks, as
    ``init_device_mesh`` lays them out), and refuses replicas that differ."""
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    blocks = []
    for rank in range(WORLD):
        c = {"data": rank // SHAPE[1], "model": rank % SHAPE[1]}
        index = [slice(None)] * x.ndim
        for dim, axis in enumerate(spec):
            if axis is not None:
                n = SHAPE[0] if axis == "data" else SHAPE[1]
                size = x.shape[dim] // n
                index[dim] = slice(c[axis] * size, (c[axis] + 1) * size)
        block = x[tuple(index)].copy()
        blocks.append(torch.from_numpy(block) if as_tensor else block)
    got = assemble(blocks, spec, SHAPE)
    assert isinstance(got, torch.Tensor) == as_tensor
    np.testing.assert_array_equal(np.asarray(got), x)
    replicated = [a for a in ("data", "model") if a not in spec]
    if replicated:
        blocks[WORLD - 1] = blocks[WORLD - 1] + 1
        with pytest.raises(ValueError, match="replicas"):
            assemble(blocks, spec, SHAPE)


def test_dryrun_and_pod_mesh_need_a_device_without_a_card(monkeypatch):
    """Without a card, the dry run and ``pod_mesh`` take the CPU only when
    asked: no device given raises, as ``types.default_device`` does."""
    from cuembed_tpu_torch.parallel import dryrun, multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.pod_mesh()


def test_multihost_pod_mesh(port):
    """``multihost.initialize`` leaves an initialized group alone, and
    ``pod_mesh`` puts one host's ranks on the model axis (no
    ``LOCAL_WORLD_SIZE``: all 4 ranks)."""
    from cuembed_tpu_torch.parallel import multihost

    assert all(r["pod_mesh"] == (1, 4, ("data", "model")) for r in port)
    multihost.initialize()  # no torchrun environment here: stays uninitialized
    import torch.distributed as dist

    assert not dist.is_initialized()
