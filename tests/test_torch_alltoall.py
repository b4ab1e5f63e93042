"""The port's routed lookups (``cuembed_tpu_torch.parallel.alltoall_lookup``:
all-to-all, hybrid head/tail and grid) against ``cuembed_tpu.parallel`` on
the same numpy inputs.

The port runs on 4 spawned gloo ranks (one spawn for the file,
``tests/torch_dist.py``), routing over a 4-rank ``model`` axis, or over the
``model`` axis of a ``(data, model) = (2, 2)`` mesh whose ``data`` replicas
route independently (the grid routes rows over ``model`` and splits columns
over ``data``). JAX runs the same meshes on 4 of its 8 virtual CPU devices.
The ranks' blocks are put back together (replicas must agree bit for bit)
and held to JAX's result.

Covered: fixed hotness (SUM, MEAN, weighted SUM, CONCAT), sharded CSR, the
overflow fallback (every id on one owner, a capacity below the share), the
hybrid layout (fixed and CSR), the grid (gathered and feature-sharded,
CSR), ``compress="int8"`` (its error bound, the hybrid head exact, no
gradient), and the table, head and weights gradients on the (2, 2) mesh
against the single-device JAX gradient.

Tolerances: integer-valued tables with power-of-two weights: bit for bit.
Random reals: the JAX tests' (``tests/test_alltoall.py``: rtol = atol =
1e-5, CONCAT 1e-6; ``tests/test_csr_sharded.py``: 2e-5), against the
single-device JAX lookup for every case and against JAX's sharded function
for one case of each function and layout (``SHARDED_REF``). int8 routes:
the same tolerance against JAX's int8 route (the int8 payload is the same
bytes), and within ``sum max|row| / 254`` of the exact route.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_dist import run_ranks

from cuembed_tpu_torch import CombineMode
from cuembed_tpu_torch.parallel import (
    alltoall_row_sharded_lookup,
    assemble,
    grid_sharded_lookup,
    hybrid_tiered_lookup,
    local_block,
    make_mesh,
    shard_csr,
    split_hybrid_table,
)
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)

WORLD = 4
FLAT, GRID = (1, 4), (2, 2)  # (data, model) shapes
TOL = dict(rtol=1e-5, atol=1e-5)
CSR_TOL = dict(rtol=2e-5, atol=2e-5)


def _skewed_idx(rng, batch, hotness, V):
    r = rng.random((batch, hotness))
    return np.minimum((r ** 4 * V).astype(np.int32), V - 1)


def _csr_problem(rng, batch, V, max_hot, weighted=False):
    hots = rng.integers(0, max_hot + 1, batch)
    offsets = np.concatenate([[0], np.cumsum(hots)]).astype(np.int32)
    nnz = int(offsets[-1])
    idx = rng.integers(0, V, max(nnz, 1)).astype(np.int32)
    w = rng.choice([0.5, 0.25, 1.0], max(nnz, 1)).astype(np.float32) if weighted else None
    return idx[:nnz], offsets, None if w is None else w[:nnz]


# -- problems: a name -> (kind, mesh shape, arrays, kwargs) ----------------------

def _fixed(seed, V=1024, W=32, B=64, H=8, weighted=False, integer=False, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    table = (rng.integers(-8, 9, (V, W)) if integer else rng.standard_normal((V, W)))
    w = None
    if weighted:
        w = (rng.choice([0.5, 0.25, 2.0], (B, H)) if integer
             else rng.standard_normal((B, H)))
        w = w.astype(np.float32)
    idx = rng.integers(lo, hi or V, (B, H)).astype(np.int32)
    return dict(table=table.astype(np.float32), idx=idx, w=w)


def _csr(seed, n, V, W, batch, max_hot, weighted=False, hot=None, skew_all=None):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, W)).astype(np.float32)
    idx, offsets, w = _csr_problem(rng, batch, V, max_hot, weighted)
    if hot is not None:
        idx[::2] = rng.integers(0, hot, idx[::2].shape)
    if skew_all is not None:
        idx[:] = rng.integers(*skew_all, idx.shape)
    ib, ob, wb = shard_csr(idx, offsets, n, w)
    return dict(table=table, idx=ib, w=wb, offsets=ob, flat=idx, flat_offsets=offsets,
                flat_w=w)


def _hybrid(seed, V=2048, hot=256, W=32, B=64, H=8, weighted=False, overflow=False):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, W)).astype(np.float32)
    idx = (rng.integers(hot, hot + 64, (B, H)).astype(np.int32) if overflow
           else _skewed_idx(rng, B, H, V))
    w = rng.standard_normal((B, H)).astype(np.float32) if weighted else None
    return dict(table=table, idx=idx, w=w, hot=hot)


CASES = {
    "a2a/sum": ("a2a", FLAT, lambda: _fixed(0), {}),
    "a2a/mean": ("a2a", FLAT, lambda: _fixed(0), dict(mode="mean")),
    "a2a/sum_w": ("a2a", FLAT, lambda: _fixed(0, weighted=True), {}),
    "a2a/sum_w_int": ("a2a", FLAT, lambda: _fixed(13, weighted=True, integer=True), {}),
    "a2a/overflow": ("a2a", FLAT, lambda: _fixed(1, W=16, hi=128), dict(capacity_factor=0.25)),
    "a2a/concat": ("a2a", FLAT, lambda: _fixed(11), dict(mode="concat")),
    "a2a/concat_overflow": ("a2a", FLAT, lambda: _fixed(12, W=16, H=4, hi=128),
                            dict(mode="concat", capacity_factor=0.25)),
    "a2a/grid_mesh": ("a2a", GRID, lambda: _fixed(0, weighted=True), {}),
    "a2a/csr_sum": ("a2a", FLAT, lambda: _csr(1, 4, 256, 32, 16, 5), dict(capacity_factor=8.0)),
    "a2a/csr_mean": ("a2a", FLAT, lambda: _csr(1, 4, 256, 32, 16, 5),
                     dict(mode="mean", capacity_factor=8.0)),
    "a2a/csr_sum_w": ("a2a", FLAT, lambda: _csr(1, 4, 256, 32, 16, 5, weighted=True),
                      dict(capacity_factor=8.0)),
    "a2a/csr_overflow": ("a2a", FLAT, lambda: _csr(2, 4, 64, 32, 8, 4, skew_all=(0, 1)),
                         dict(capacity_factor=1.0)),
    "a2a/int8": ("a2a", FLAT, lambda: _fixed(8), dict(compress="int8")),
    "hybrid/sum": ("hybrid", FLAT, lambda: _hybrid(5), dict(cold_frac=0.5)),
    "hybrid/mean": ("hybrid", FLAT, lambda: _hybrid(5), dict(mode="mean", cold_frac=0.5)),
    "hybrid/sum_w": ("hybrid", FLAT, lambda: _hybrid(5, weighted=True), dict(cold_frac=0.5)),
    "hybrid/overflow": ("hybrid", FLAT, lambda: _hybrid(6, W=16, overflow=True),
                        dict(cold_frac=0.05, capacity_factor=1.0)),
    "hybrid/csr_sum": ("hybrid", FLAT, lambda: dict(_csr(7, 4, 256, 32, 16, 5, hot=64), hot=64),
                       dict(capacity_factor=8.0)),
    "hybrid/csr_mean": ("hybrid", FLAT, lambda: dict(_csr(7, 4, 256, 32, 16, 5, hot=64),
                                                      hot=64),
                        dict(mode="mean", capacity_factor=8.0)),
    "hybrid/csr_sum_w": ("hybrid", FLAT, lambda: dict(
        _csr(7, 4, 256, 32, 16, 5, weighted=True, hot=64), hot=64), dict(capacity_factor=8.0)),
    "hybrid/csr_overflow": ("hybrid", FLAT, lambda: dict(
        _csr(8, 4, 256, 16, 16, 6, skew_all=(16, 24)), hot=16),
        dict(capacity_factor=0.05, cold_frac=0.2)),
    "hybrid/int8": ("hybrid", FLAT, lambda: _hybrid(9), dict(compress="int8")),
    "grid/sum": ("grid", GRID, lambda: _fixed(20), {}),
    "grid/sum_w": ("grid", GRID, lambda: _fixed(21, weighted=True), {}),
    "grid/sliced": ("grid", GRID, lambda: _fixed(22), dict(gather_output=False)),
    "grid/overflow": ("grid", GRID, lambda: _fixed(23, hi=64), dict(capacity_factor=0.25)),
    "grid/csr": ("grid", GRID, lambda: _csr(24, 2, 256, 32, 16, 5, weighted=True),
                 dict(capacity_factor=4.0)),
    "grid/int8": ("grid", GRID, lambda: _fixed(25), dict(compress="int8")),
}
MODES = {"sum": CombineMode.SUM, "mean": CombineMode.MEAN, "concat": CombineMode.CONCAT}


def _specs(kind, p, kwargs):
    """(table spec, batch spec, result spec) of a case."""
    csr = "offsets" in p
    if kind == "grid":
        out = ("model", None, None) if csr else ("model", None)
        if kwargs.get("gather_output") is False:
            out = out[:-1] + ("data",)
        return ("model", "data"), ("model", None), out
    return ("model", None), ("model", None), ("model", None, None) if csr else ("model", None)


# -- the ranks ----------------------------------------------------------------

def _port_call(kind, mesh, p, kwargs, table=None, head=None, weights=None):
    """Run one case's port function on this rank's blocks."""
    tspec, bspec, _ = _specs(kind, p, kwargs)
    t = torch.from_numpy

    def block(x, spec=bspec):
        return None if x is None else local_block(t(x), mesh, spec).contiguous()

    kw = dict(kwargs, mode=MODES[kwargs.get("mode", "sum")])
    w = weights if weights is not None else block(p["w"])
    args = (block(p["idx"]), w, block(p.get("offsets")))
    if kind == "hybrid":
        h, tail = split_hybrid_table(p["table"], p["hot"], mesh.size(1))
        return hybrid_tiered_lookup(t(h) if head is None else head,
                                    block(tail, tspec) if table is None else table,
                                    *args, mesh=mesh, **kw)
    fn = grid_sharded_lookup if kind == "grid" else alltoall_row_sharded_lookup
    return fn(block(p["table"], tspec) if table is None else table, *args, mesh=mesh, **kw)


def ranks(rank, world, tmp):
    meshes = {FLAT: make_mesh(n_model=4, device_type="cpu"),
              GRID: make_mesh(n_model=2, device_type="cpu")}
    res = {}
    for name, (kind, shape, problem, kwargs) in CASES.items():
        res[name] = _port_call(kind, meshes[shape], problem(), kwargs)

    # Gradients on the (2, 2) mesh: loss sum(out * gy) with a fixed global gy.
    mesh = meshes[GRID]
    for kind in ("a2a", "hybrid", "grid"):
        p = _hybrid(7, V=1024, hot=128, W=16, B=32, H=4, weighted=True)
        tspec = ("model", "data") if kind == "grid" else ("model", None)
        table = p["table"] if kind != "hybrid" else split_hybrid_table(
            p["table"], p["hot"], 2)[1]
        tl = local_block(torch.from_numpy(table), mesh, tspec).contiguous().requires_grad_()
        wl = local_block(torch.from_numpy(p["w"]), mesh, ("model", None)).contiguous()
        wl.requires_grad_()
        head = torch.from_numpy(p["table"][: p["hot"]]).requires_grad_()
        out = _port_call(kind, mesh, p, {}, table=tl, head=head, weights=wl)
        gy = np.random.default_rng(99).standard_normal((32, 16)).astype(np.float32)
        (out * local_block(torch.from_numpy(gy), mesh, ("model", None))).sum().backward()
        res[f"grad/{kind}"] = (tl.grad, wl.grad, head.grad)

    # int8 responses refuse a gradient.
    p = _fixed(10)
    tl = local_block(torch.from_numpy(p["table"]), meshes[FLAT], ("model", None))
    try:
        _port_call("a2a", meshes[FLAT], p, dict(compress="int8"),
                   table=tl.contiguous().requires_grad_())
        res["int8/grad"] = "no error"
    except NotImplementedError as e:
        res["int8/grad"] = str(e)
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks(Path(__file__), "ranks", WORLD, tmp_path_factory.mktemp("alltoall"))


# -- the JAX side ---------------------------------------------------------------

def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:WORLD]).reshape(shape), ("data", "model"))


def _put(x, mesh, spec):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return None if x is None else jax.device_put(x, NamedSharding(mesh, P(*spec)))


def _jax_call(kind, shape, p, kwargs, table=None, head=None, weights=None):
    from cuembed_tpu.parallel import alltoall_lookup as ja
    from cuembed_tpu.types import CombineMode as J

    m = _jax_mesh(shape)
    tspec, bspec, _ = _specs(kind, p, kwargs)
    kw = dict(kwargs, mode=J(MODES[kwargs.get("mode", "sum")].value))
    w = weights if weights is not None else _put(p["w"], m, bspec)
    args = (_put(p["idx"], m, bspec), w, _put(p.get("offsets"), m, bspec))
    if kind == "hybrid":
        h, tail = ja.split_hybrid_table(p["table"], p["hot"], shape[1])
        return ja.hybrid_tiered_lookup(
            _put(h, m, ()) if head is None else head,
            _put(tail, m, tspec) if table is None else table, *args, mesh=m, **kw)
    fn = ja.grid_sharded_lookup if kind == "grid" else ja.alltoall_row_sharded_lookup
    return fn(_put(p["table"], m, tspec) if table is None else table, *args, mesh=m, **kw)


# The cases also held to JAX's sharded function (each compiles for seconds
# on the CPU mesh): one of each function and layout, and every int8 route.
# The others are held to the single-device JAX lookup, as the JAX tests hold
# the JAX functions.
SHARDED_REF = ("a2a/sum_w", "a2a/sum_w_int", "a2a/concat", "a2a/csr_sum_w", "a2a/grid_mesh",
               "a2a/int8", "hybrid/sum_w", "hybrid/csr_sum_w", "hybrid/int8", "grid/sum_w",
               "grid/csr", "grid/int8")


def _single_device(p, kwargs):
    """The JAX single-device lookup of a case's global batch."""
    from cuembed_tpu import embedding_lookup as jl, embedding_lookup_csr as jlc
    from cuembed_tpu.types import CombineMode as J

    mode = J(MODES[kwargs.get("mode", "sum")].value)
    if "offsets" in p:
        return np.asarray(jlc(p["table"], p["flat"], p["flat_offsets"], p["flat_w"],
                              mode=mode, backend="xla"))
    return np.asarray(jl(p["table"], p["idx"], p["w"], mode=mode, backend="xla"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_routed_lookup_matches_jax(port, name):
    kind, shape, problem, kwargs = CASES[name]
    p = problem()
    _, _, out_spec = _specs(kind, p, kwargs)
    got = assemble([r[name].numpy() for r in port], out_spec, shape)
    wants = [np.asarray(_jax_call(kind, shape, p, kwargs))] if name in SHARDED_REF else []
    if kwargs.get("compress") != "int8":
        wants.append(_single_device(p, kwargs).reshape(got.shape))
    for want in wants:
        assert got.shape == want.shape
        if name.endswith("_int"):
            np.testing.assert_array_equal(got, want)
        elif kwargs.get("mode") == "concat":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(got, want, **(CSR_TOL if "offsets" in p else TOL))


@pytest.mark.parametrize("name", ["a2a/int8", "hybrid/int8", "grid/int8"])
def test_int8_compress_within_bound(port, name):
    """The int8 route is within sum max|row| / 254 of the exact route (the
    port's own, fp32), and the hybrid head's samples stay exact."""
    kind, shape, problem, kwargs = CASES[name]
    p = problem()
    _, _, out_spec = _specs(kind, p, kwargs)
    lossy = assemble([r[name].numpy() for r in port], out_spec, shape)
    idx, table = p["idx"], p["table"]
    exact = np.stack([table[i].sum(axis=0) for i in idx])
    amax = np.abs(table).max(axis=1)
    cold = idx >= p.get("hot", 0)
    bound = (amax[idx] / 254 * cold).sum(axis=1) + 1e-5
    assert (np.abs(lossy - exact).max(axis=1) <= bound).all()
    if kind == "hybrid":
        all_hot = ~cold.any(axis=1)
        assert all_hot.any()
        np.testing.assert_allclose(lossy[all_hot], exact[all_hot], **TOL)


def test_int8_compress_refuses_grad(port):
    assert all("serving-only" in r["int8/grad"] for r in port)


@pytest.mark.parametrize("kind", ["a2a", "hybrid", "grid"])
def test_routed_grads_match_single_device(port, kind):
    """Table (tail), head and weights gradients on the (2, 2) mesh equal
    the single-device JAX gradient: the ``data`` replicas add no factor, and
    the hybrid head's gradient is summed over the axis once."""
    import jax
    import jax.numpy as jnp
    from cuembed_tpu import embedding_lookup as jlookup

    p = _hybrid(7, V=1024, hot=128, W=16, B=32, H=4, weighted=True)
    gy = np.random.default_rng(99).standard_normal((32, 16)).astype(np.float32)
    tspec = ("model", "data") if kind == "grid" else ("model", None)

    st, sw = jax.grad(lambda t, w: jnp.sum(jlookup(t, p["idx"], w, backend="xla") * gy),
                      argnums=(0, 1))(jnp.asarray(p["table"]), jnp.asarray(p["w"]))
    st, sw = np.asarray(st), np.asarray(sw)
    got_t = assemble([r[f"grad/{kind}"][0].numpy() for r in port], tspec, GRID)
    got_w = assemble([r[f"grad/{kind}"][1].numpy() for r in port], ("model", None), GRID)
    np.testing.assert_allclose(got_w, sw, **TOL)
    if kind == "hybrid":
        got_h = assemble([r[f"grad/{kind}"][2].numpy() for r in port], (), GRID)
        np.testing.assert_allclose(got_h, st[: p["hot"]], **TOL)
        np.testing.assert_allclose(got_t[: 1024 - p["hot"]], st[p["hot"]:], **TOL)
    else:
        np.testing.assert_allclose(got_t, st, **TOL)

