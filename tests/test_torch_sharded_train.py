"""The port's routed sparse updates (``cuembed_tpu_torch.parallel.train``:
row-sharded, hybrid, column and grid; SGD and row-wise AdaGrad) against
``cuembed_tpu``'s updates on the same numpy inputs.

The port runs on 4 spawned gloo ranks (one spawn for the file,
``tests/torch_dist.py``): row-sharded and hybrid updates route over a
4-rank ``model`` axis; column and grid updates run on a ``(data, model) =
(2, 2)`` mesh (the grid routes rows over ``model``, columns split over
``data``). The ranks' blocks are put back together (replicas must agree bit
for bit) and held to the JAX single-chip update of the whole table, as the
JAX tests hold the JAX sharded updates; one case of each of the 8 functions
is also held to the JAX sharded update itself (each compiles for seconds on
the CPU mesh).

Covered: SUM, MEAN and weighted SUM, sharded CSR (flat CSR for the column
layout), the overflow fallback (every id on one owner under a small
capacity), repeated AdaGrad steps, a bf16 table, the hybrid head's K3
path (a head past ``HEAD_GRAD_MXU_MAX_ROWS``), and run-to-run determinism.

Tolerances: integer-valued tables and gradients with lr = 0.5 keep every
sum exact: bit for bit. Random reals: the JAX tests'
(``tests/test_sharded_train.py``): rtol = atol = 1e-5, 1e-4 over two steps,
and 2e-2 for the bf16 table (JAX adds each position's bf16 update, the port
each row's summed one).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_dist import run_ranks

from cuembed_tpu_torch import CombineMode
from cuembed_tpu_torch.parallel import (assemble, local_block, make_mesh, shard_csr,
                                        split_hybrid_table)
from cuembed_tpu_torch.parallel import train as ptrain

WORLD = 4
FLAT, GRID = (1, 4), (2, 2)
TOL = dict(rtol=1e-5, atol=1e-5)
LR = 0.1
MODES = {"sum": CombineMode.SUM, "mean": CombineMode.MEAN}


def _problem(seed, V=1024, W=32, B=64, H=8, weighted=False, hi=None, integer=False,
             csr=None, hot=None):
    rng = np.random.default_rng(seed)
    if integer:
        table = rng.integers(-8, 9, (V, W)).astype(np.float32)
        gy = rng.integers(-4, 5, (B, W)).astype(np.float32)
    else:
        table = rng.standard_normal((V, W)).astype(np.float32)
        gy = rng.standard_normal((B, W)).astype(np.float32)
    p = dict(table=table, gy=gy, hot=hot)
    if csr is None:
        idx = rng.integers(0, hi or V, (B, H)).astype(np.int32)
        if hot is not None and hi is None:
            r = rng.random((B, H))
            idx = np.minimum((r ** 4 * V).astype(np.int32), V - 1)
        p.update(idx=idx, w=rng.standard_normal((B, H)).astype(np.float32)
                 if weighted else None)
        return p
    hots = rng.integers(0, 6, B)
    offsets = np.concatenate([[0], np.cumsum(hots)]).astype(np.int32)
    nnz = int(offsets[-1])
    idx = rng.integers(0, hi or V, nnz).astype(np.int32)
    if hot is not None:
        idx[::2] = rng.integers(0, hot, idx[::2].shape)
    w = rng.choice([0.5, 0.25, 1.0], nnz).astype(np.float32) if weighted else None
    p.update(flat=idx, flat_offsets=offsets, flat_w=w)
    if csr > 0:  # sharded-CSR blocks over csr ranks
        p["idx"], p["offsets"], p["w"] = shard_csr(idx, offsets, csr, w)
    else:  # flat CSR, replicated (the column layout)
        p["idx"], p["offsets"], p["w"] = idx, offsets, w
    return p


# name -> (kind, optimizer, mesh shape, problem, kwargs, steps)
CASES = {
    "row/sgd/sum": ("row", "sgd", FLAT, lambda: _problem(0), {}, 1),
    "row/sgd/mean": ("row", "sgd", FLAT, lambda: _problem(0), dict(mode="mean"), 1),
    "row/sgd/sum_w": ("row", "sgd", FLAT, lambda: _problem(0, weighted=True), {}, 1),
    "row/sgd/int": ("row", "sgd", FLAT, lambda: _problem(30, integer=True), dict(lr=0.5), 1),
    "row/sgd/overflow": ("row", "sgd", FLAT, lambda: _problem(1, hi=128),
                         dict(capacity_factor=0.25), 1),
    "row/sgd/csr_sum": ("row", "sgd", FLAT, lambda: _problem(2, csr=4), {}, 1),
    "row/sgd/csr_mean": ("row", "sgd", FLAT, lambda: _problem(2, csr=4), dict(mode="mean"), 1),
    "row/sgd/bf16": ("row", "sgd", FLAT, lambda: _problem(3), dict(dtype="bf16"), 1),
    "row/adagrad/sum": ("row", "adagrad", FLAT, lambda: _problem(4), {}, 1),
    "row/adagrad/mean": ("row", "adagrad", FLAT, lambda: _problem(4), dict(mode="mean"), 1),
    "row/adagrad/sum_w_2steps": ("row", "adagrad", FLAT, lambda: _problem(5, weighted=True),
                                 {}, 2),
    "row/adagrad/overflow": ("row", "adagrad", FLAT, lambda: _problem(6, hi=100),
                             dict(capacity_factor=0.25), 1),
    "row/adagrad/csr_sum_w": ("row", "adagrad", FLAT,
                              lambda: _problem(7, csr=4, weighted=True), {}, 1),
    "hybrid/sgd/sum": ("hybrid", "sgd", FLAT, lambda: _problem(8, hot=128), {}, 1),
    "hybrid/sgd/sum_w": ("hybrid", "sgd", FLAT, lambda: _problem(8, hot=128, weighted=True),
                         {}, 1),
    "hybrid/sgd/overflow": ("hybrid", "sgd", FLAT, lambda: _problem(9, hot=128, hi=160),
                            dict(cold_frac=0.05, capacity_factor=1.0), 1),
    "hybrid/sgd/csr_mean": ("hybrid", "sgd", FLAT, lambda: _problem(10, hot=128, csr=4),
                            dict(mode="mean"), 1),
    "hybrid/sgd/large_head": ("hybrid", "sgd", FLAT,
                              lambda: _problem(11, V=20480, W=8, hot=17000), {}, 1),
    "hybrid/adagrad/sum_w": ("hybrid", "adagrad", FLAT,
                             lambda: _problem(12, hot=128, weighted=True), {}, 1),
    "hybrid/adagrad/overflow_2steps": ("hybrid", "adagrad", FLAT,
                                       lambda: _problem(13, hot=128, hi=160),
                                       dict(cold_frac=0.05, capacity_factor=1.0), 2),
    "hybrid/adagrad/csr_sum_w": ("hybrid", "adagrad", FLAT,
                                 lambda: _problem(14, hot=128, csr=4, weighted=True), {}, 1),
    "col/sgd/sum": ("col", "sgd", GRID, lambda: _problem(15), {}, 1),
    "col/sgd/sum_w": ("col", "sgd", GRID, lambda: _problem(15, weighted=True), {}, 1),
    "col/sgd/csr_sum_w": ("col", "sgd", GRID, lambda: _problem(16, csr=0, weighted=True),
                          {}, 1),
    "col/adagrad/sum": ("col", "adagrad", GRID, lambda: _problem(17), {}, 1),
    "col/adagrad/mean": ("col", "adagrad", GRID, lambda: _problem(17), dict(mode="mean"), 1),
    "col/adagrad/csr_mean": ("col", "adagrad", GRID, lambda: _problem(18, csr=0),
                             dict(mode="mean"), 1),
    "grid/sgd/sum_w": ("grid", "sgd", GRID, lambda: _problem(19, weighted=True), {}, 1),
    "grid/sgd/overflow": ("grid", "sgd", GRID, lambda: _problem(20, hi=64),
                          dict(capacity_factor=0.25), 1),
    "grid/sgd/csr_mean": ("grid", "sgd", GRID, lambda: _problem(21, csr=2),
                          dict(mode="mean"), 1),
    "grid/adagrad/sum": ("grid", "adagrad", GRID, lambda: _problem(22), {}, 1),
    "grid/adagrad/csr_sum_w": ("grid", "adagrad", GRID,
                               lambda: _problem(23, csr=2, weighted=True), {}, 1),
}
# One case of each function is also held to the JAX sharded update.
SHARDED_REF = ("row/sgd/sum_w", "row/adagrad/csr_sum_w", "hybrid/sgd/sum_w",
               "hybrid/adagrad/csr_sum_w", "col/sgd/sum_w", "col/adagrad/mean",
               "grid/sgd/sum_w", "grid/adagrad/csr_sum_w")


def _specs(kind, p):
    """Specs of (table, accum, batch arrays, grad_y)."""
    if kind == "col":
        if "offsets" in p:
            return (None, "model"), (None,), (None,), (None, "model")
        return (None, "model"), (None,), ("data", None), ("data", "model")
    if kind == "grid":
        return ("model", "data"), ("model",), ("model", None), ("model", "data")
    return ("model", None), ("model",), ("model", None), ("model", None)


# -- the ranks ----------------------------------------------------------------

def _port_case(mesh, kind, opt, p, kwargs, steps):
    tspec, aspec, bspec, gspec = _specs(kind, p)
    kw = dict(kwargs)
    dtype = torch.bfloat16 if kw.pop("dtype", None) == "bf16" else torch.float32
    kw["mode"] = MODES[kw.get("mode", "sum")]
    kw.setdefault("lr", LR)

    def block(x, spec):
        return None if x is None else local_block(torch.from_numpy(x), mesh,
                                                  spec).contiguous()

    batch = dict(indices=block(p["idx"], bspec), grad_y=block(p["gy"], gspec),
                 weights=block(p["w"], bspec), offsets=block(p.get("offsets"), bspec))
    idx, gy = batch.pop("indices"), batch.pop("grad_y")
    kw.update(batch)
    if kind == "hybrid":
        head, tail = split_hybrid_table(p["table"], p["hot"], mesh.size(1))
        head = torch.from_numpy(head.copy())
        tail = block(tail, tspec).clone()
        if opt == "sgd":
            for _ in range(steps):
                ptrain.sharded_hybrid_sgd_sparse_update(head, tail, idx, gy, mesh=mesh, **kw)
            return head, tail
        hacc = torch.zeros(head.shape[0])
        tacc = torch.zeros(tail.shape[0])
        for _ in range(steps):
            ptrain.sharded_hybrid_rowwise_adagrad_sparse_update(
                head, tail, hacc, tacc, idx, gy, mesh=mesh, **kw)
        return head, tail, hacc, tacc
    table = block(p["table"], tspec).to(dtype).clone()
    fn = {"row": (ptrain.sharded_sgd_sparse_update,
                  ptrain.sharded_rowwise_adagrad_sparse_update),
          "col": (ptrain.column_sharded_sgd_sparse_update,
                  ptrain.column_sharded_rowwise_adagrad_sparse_update),
          "grid": (ptrain.grid_sharded_sgd_sparse_update,
                   ptrain.grid_sharded_rowwise_adagrad_sparse_update)}[kind]
    if opt == "sgd":
        for _ in range(steps):
            fn[0](table, idx, gy, mesh=mesh, **kw)
        return (table.float(),)
    acc = block(np.zeros(p["table"].shape[0], np.float32), aspec).clone()
    for _ in range(steps):
        fn[1](table, acc, idx, gy, mesh=mesh, **kw)
    return table, acc


def ranks(rank, world, tmp):
    meshes = {FLAT: make_mesh(n_model=4, device_type="cpu"),
              GRID: make_mesh(n_model=2, device_type="cpu")}
    res = {name: _port_case(meshes[shape], kind, opt, problem(), kwargs, steps)
           for name, (kind, opt, shape, problem, kwargs, steps) in CASES.items()}
    # Determinism: the same update twice gives the same bits.
    kind, opt, shape, problem, kwargs, steps = CASES["row/adagrad/sum_w_2steps"]
    again = _port_case(meshes[shape], kind, opt, problem(), kwargs, steps)
    res["deterministic"] = all(torch.equal(a, b) for a, b in
                               zip(again, res["row/adagrad/sum_w_2steps"]))
    # The refusals, with JAX's messages.
    p = _problem(0)
    t = local_block(torch.from_numpy(p["table"]), meshes[FLAT], ("model", None)).clone()
    idx = local_block(torch.from_numpy(p["idx"]), meshes[FLAT], ("model", None))
    gy = local_block(torch.from_numpy(p["gy"]), meshes[FLAT], ("model", None))
    errors = []
    for kw in (dict(mode=CombineMode.CONCAT), dict(mode=CombineMode.MEAN, weights=idx * 1.0)):
        try:
            ptrain.sharded_sgd_sparse_update(t, idx, gy, mesh=meshes[FLAT], lr=LR, **kw)
        except ValueError as e:
            errors.append(str(e))
    try:
        ptrain.sharded_rowwise_adagrad_sparse_update(t, torch.zeros(3), idx, gy,
                                                     mesh=meshes[FLAT], lr=LR)
    except ValueError as e:
        errors.append(str(e))
    res["errors"] = errors
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks(Path(__file__), "ranks", WORLD, tmp_path_factory.mktemp("train"),
                     timeout=180.0)


# -- the JAX side ---------------------------------------------------------------

def _single_chip(kind, opt, p, kwargs, steps):
    """The JAX single-chip update of the whole table: (table, accum)."""
    import jax.numpy as jnp
    from cuembed_tpu import train as jtrain
    from cuembed_tpu.types import CombineMode as J

    kw = dict(kwargs)
    dt = jnp.bfloat16 if kw.pop("dtype", None) == "bf16" else jnp.float32
    for k in ("capacity_factor", "cold_frac"):
        kw.pop(k, None)
    kw["mode"] = J(kw.get("mode", "sum"))
    kw.setdefault("lr", LR)
    csr = "flat" in p

    def arr(x):
        return None if x is None else jnp.asarray(x)

    idx, gy = arr(p["flat"] if csr else p["idx"]), arr(p["gy"])
    kw.update(weights=arr(p["flat_w"] if csr else p["w"]),
              offsets=arr(p["flat_offsets"]) if csr else None)
    table = jnp.asarray(p["table"], dt)
    if opt == "sgd":
        for _ in range(steps):
            table = jtrain.sgd_sparse_update(table, idx, gy, **kw)
        return np.asarray(table.astype(jnp.float32)), None
    acc = jnp.zeros(p["table"].shape[0], jnp.float32)
    for _ in range(steps):
        table, acc = jtrain.rowwise_adagrad_sparse_update(table, acc, idx, gy, **kw)
    return np.asarray(table), np.asarray(acc)


def _jax_sharded(kind, opt, shape, p, kwargs):
    """The JAX sharded update of one case (one step): (table, accum)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from cuembed_tpu.parallel import train as jpt
    from cuembed_tpu.types import CombineMode as J

    m = Mesh(np.array(jax.devices()[:WORLD]).reshape(shape), ("data", "model"))
    tspec, aspec, bspec, gspec = _specs(kind, p)

    def put(x, spec):
        return None if x is None else jax.device_put(x, NamedSharding(m, P(*spec)))

    kw = dict(kwargs, mode=J(kwargs.get("mode", "sum")), lr=LR, mesh=m,
              weights=put(p["w"], bspec), offsets=put(p.get("offsets"), bspec))
    idx, gy = put(p["idx"], bspec), put(p["gy"], gspec)
    if kind == "hybrid":
        head, tail = jpt_split(p, shape)
        args = (put(head, ()), put(tail, tspec))
        if opt == "sgd":
            h, t = jpt.sharded_hybrid_sgd_sparse_update(*args, idx, gy, **kw)
            return np.concatenate([np.asarray(h), np.asarray(t)]), None
        h, t, ha, ta = jpt.sharded_hybrid_rowwise_adagrad_sparse_update(
            *args, put(np.zeros(head.shape[0], np.float32), ()),
            put(np.zeros(tail.shape[0], np.float32), aspec), idx, gy, **kw)
        return (np.concatenate([np.asarray(h), np.asarray(t)]),
                np.concatenate([np.asarray(ha), np.asarray(ta)]))
    fn = {"row": (jpt.sharded_sgd_sparse_update, jpt.sharded_rowwise_adagrad_sparse_update),
          "col": (jpt.column_sharded_sgd_sparse_update,
                  jpt.column_sharded_rowwise_adagrad_sparse_update),
          "grid": (jpt.grid_sharded_sgd_sparse_update,
                   jpt.grid_sharded_rowwise_adagrad_sparse_update)}[kind]
    table = put(p["table"], tspec)
    if opt == "sgd":
        return np.asarray(fn[0](table, idx, gy, **kw)), None
    t, a = fn[1](table, put(np.zeros(p["table"].shape[0], np.float32), aspec), idx, gy, **kw)
    return np.asarray(t), np.asarray(a)


def jpt_split(p, shape):
    from cuembed_tpu.parallel import split_hybrid_table as jsplit

    return jsplit(p["table"], p["hot"], shape[1])


def _port_result(port, name):
    """The port's (table, accum) of a case, whole and unpadded."""
    kind, opt, shape, problem, kwargs, steps = CASES[name]
    p = problem()
    tspec, aspec, _, _ = _specs(kind, p)
    V = p["table"].shape[0]
    blocks = [r[name] for r in port]
    if kind == "hybrid":
        head = assemble([b[0].numpy() for b in blocks], (), shape)
        tail = assemble([b[1].numpy() for b in blocks], tspec, shape)
        table = np.concatenate([head, tail])[:V]
        acc = None
        if opt == "adagrad":
            acc = np.concatenate([assemble([b[2].numpy() for b in blocks], (), shape),
                                  assemble([b[3].numpy() for b in blocks], aspec, shape)])[:V]
        return table, acc
    table = assemble([b[0].float().numpy() for b in blocks], tspec, shape)
    acc = None if opt == "sgd" else assemble([b[1].numpy() for b in blocks], aspec, shape)
    return table, acc


@pytest.mark.parametrize("name", sorted(CASES))
def test_routed_update_matches_jax(port, name):
    kind, opt, shape, problem, kwargs, steps = CASES[name]
    p = problem()
    got_t, got_a = _port_result(port, name)
    refs = [_single_chip(kind, opt, p, kwargs, steps)]
    if name in SHARDED_REF:
        refs.append(_jax_sharded(kind, opt, shape, p, kwargs))
    tol = dict(rtol=1e-4, atol=1e-4) if steps > 1 else TOL
    if kwargs.get("dtype") == "bf16":
        tol = dict(rtol=2e-2, atol=2e-2)
    for want_t, want_a in refs:
        want_t = want_t[: got_t.shape[0]]
        if name.endswith("/int"):
            np.testing.assert_array_equal(got_t, want_t)
        else:
            np.testing.assert_allclose(got_t, want_t, **tol)
        if want_a is not None:
            np.testing.assert_allclose(got_a, want_a[: got_a.shape[0]], **tol)


def test_routed_update_is_deterministic(port):
    assert all(r["deterministic"] for r in port)


def test_routed_update_refusals(port):
    msgs = port[0]["errors"]
    assert "CONCAT unsupported" in msgs[0]
    assert "weights are only supported with CombineMode.SUM" in msgs[1]
    assert "row-aligned" in msgs[2]


def test_capacity_formulas_match_jax():
    """The slot counts, whose overflow decides the route, are JAX's."""
    from cuembed_tpu.parallel import train as jpt

    for nnz, n, f in ((512, 4, 2.0), (512, 4, 0.25), (8, 2, 2.0), (4096, 8, 1.5)):
        assert ptrain._grid_cap(nnz, n, f) == jpt._grid_cap(nnz, n, f)
        t = np.zeros((n * 8, 4), np.float32)
        idx = np.zeros((n, nnz // n), np.int32)
        got = ptrain._update_shapes(torch.zeros(8, 4), torch.from_numpy(idx[:1]), None, n, f)
        want = jpt._update_shapes(t, idx, None, n, f)
        assert got[2:] == want[2:]
