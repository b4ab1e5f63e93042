"""``EmbeddingCollection.apply``'s fixed-hotness tables through the one route
to K1: ``api.embedding_lookup_many`` (the lookups on the card that need no
gradient) -> ``dispatch.forward_many`` (the K1 lookups) ->
``cuda_forward.embedding_forward_cuda_many`` (one host pass, one call into
the library).

On the CPU: the rule where it lives (collection: CSR tables apart; api: on
the card, no gradient, its checks; dispatch: CONCAT apart), ``apply``
routing a mixed call by it with the card stood in (every tensor reads as on
the card, and the library's call is a host version of K1 that reads the
descriptors' pointers and writes the outputs), CPU tables on the per-table
route, the one cached plan, the descriptors' words and the output buffers,
and the list form's errors against ``embedding_lookup``'s. On the card
(``-m cuda``): the batched ``apply`` equal to the per-table
``embedding_lookup`` bit for bit at the DLRM-v2 hotnesses and across table
dtypes, id dtypes and combine modes; a call mixing batched and per-table
tables; the counters and the trace of one 26-table call; and the errors of
bad inputs.
"""

import contextlib
import ctypes
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cuembed_tpu_torch.collection import EmbeddingCollection, TableConfig
from cuembed_tpu_torch.ops import _build, api, cuda_forward
from cuembed_tpu_torch.ops.api import (
    embedding_lookup,
    embedding_lookup_csr,
    embedding_lookup_many,
)
from cuembed_tpu_torch.ops.lookup_torch import embedding_forward_torch, rounded_reciprocal
from cuembed_tpu_torch.types import CombineMode, accumulation_dtype
from cuembed_tpu_torch.utils import trace
from portbench.tracing import reduce

SUM, MEAN, CONCAT = CombineMode.SUM, CombineMode.MEAN, CombineMode.CONCAT
# MLPerf DLRM-v2's 26 multi-hot sizes (portbench/configs/dlrmv2-criteo-mh.json).
DLRMV2_HOTNESS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27,
                  10, 3, 1, 1)
W = cuda_forward.FIXED_DESC_WORDS


def _delta(before):
    after = trace.counters()
    return {k: after[k] - before[k] for k in after}


# -- the card stood in on the CPU ----------------------------------------------

def _host_view(ptr, shape, dtype):
    """The tensor of ``shape`` and ``dtype`` at host address ``ptr``."""
    nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_byte * nbytes).from_address(ptr),
                            dtype=dtype).view(shape)


def _k1_on_the_host(packed, n, stream):
    """``cuembed_fixed_forward_many`` on host memory: each descriptor's
    lookup by the plain version, read from and written to its pointers."""
    d = struct.unpack(f"{n * W}q", packed)
    dtypes = {0: torch.float32, 1: torch.float16, 2: torch.bfloat16}
    for k in range(n):
        (tp, ip, wp, op, rows, batch, hot, width, ibytes, _, dt, lpm, _, mean,
         *_) = d[W * k:W * (k + 1)]
        table = _host_view(tp, (rows, width), dtypes[dt])
        idx = _host_view(ip, (batch, hot), torch.int64 if ibytes == 8 else torch.int32)
        w = _host_view(wp, (batch, hot), torch.float32) if wp else None
        _host_view(op, (batch, width), dtypes[dt]).copy_(embedding_forward_torch(
            table, idx, None, w, mode=MEAN if mean else SUM, low_precision_math=bool(lpm)))
    return 0


@pytest.fixture
def on_cuda(monkeypatch):
    """Every tensor reads as on the card unless marked ``on_card = False``,
    the library's call is :func:`_k1_on_the_host`, and the device guard and
    stream are stood in; the tables that each batched call served."""
    served = []
    real = cuda_forward.embedding_forward_cuda_many

    def many(tables, *args, **kwargs):
        outs = real(tables, *args, **kwargs)
        served.append([t.data_ptr() for t, out in zip(tables, outs) if out is not None])
        return outs

    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda t: t.__dict__.get("on_card", True)))
    monkeypatch.setattr(_build, "load_library",
                        lambda: SimpleNamespace(cuembed_fixed_forward_many=_k1_on_the_host))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_forward, "embedding_forward_cuda_many", many)
    return served


# -- the rule ----------------------------------------------------------------

# case -> (weighted, CSR, mode, grad mode), batched?
RULE = {
    "sum": ((False, False, SUM, True), True),
    "mean": ((False, False, MEAN, True), True),
    "weighted": ((True, False, SUM, True), True),
    "csr": ((False, True, SUM, True), False),
    "concat": ((False, False, CONCAT, True), False),
    "cpu table": ((False, False, SUM, True), False),
    "cpu indices": ((False, False, SUM, True), False),
    "table needs grad": ((False, False, SUM, True), False),
    "table requires grad, grad mode off": ((False, False, SUM, False), True),
    "weights need grad": ((True, False, SUM, True), False),
    "weights require grad, grad mode off": ((True, False, SUM, False), True),
}


@pytest.mark.parametrize("case", sorted(RULE))
def test_batched_route_rule(on_cuda, case, monkeypatch):
    """One table through ``apply``, where the rule now lives: the collection
    (CSR apart), api (no gradient to take), dispatch (CONCAT apart) and the
    K1 path's test (the card; ids elsewhere than the table, as host ids
    beside a table on the card, take the per-table route, which raises the
    checks' error)."""
    (weighted, csr, mode, grad), want = RULE[case]
    per_table = []
    real = api.embedding_lookup

    def spy(table, *args, **kwargs):
        per_table.append(table.data_ptr())
        return real(table, *args, **kwargs)

    monkeypatch.setattr(api, "embedding_lookup", spy)
    g = torch.Generator().manual_seed(7)
    table = torch.randn((10, 8), generator=g)
    idx = torch.randint(0, 10, (4, 3), generator=g)
    w = torch.rand((4, 3), generator=g) if weighted else None
    off = None
    if csr:
        idx, off = idx.reshape(-1), torch.arange(0, 13, 3)
    if case == "cpu table":
        table.on_card = False
    elif case == "cpu indices":
        idx = idx.to("meta")
    elif case.startswith("table"):
        table.requires_grad_(True)
    elif case.startswith("weights"):
        w.requires_grad_(True)
    coll = EmbeddingCollection([TableConfig("t", 10, 8, mode=mode)])
    raises = (pytest.raises(ValueError, match="must be on") if case == "cpu indices"
              else contextlib.nullcontext())
    with torch.set_grad_enabled(grad), raises:
        coll.apply({"t": table}, {"t": idx}, {"t": w} if w is not None else None,
                   {"t": off} if off is not None else None)
    assert ([table.data_ptr()] in on_cuda) is want
    assert per_table == ([] if want or csr else [table.data_ptr()])


ROWS, WIDTH, BATCH = 50, 6, 7


def _mixed(requires_grad=False):
    """A collection of every kind of table, its tables, ids, weights and
    offsets; "bag" is the only CSR table."""
    specs = {"a": (SUM, 3), "b": (MEAN, 2), "w": (SUM, 4), "c": (CONCAT, 2),
             "g": (SUM, 5), "bag": (SUM, 3)}
    coll = EmbeddingCollection([TableConfig(n, ROWS, WIDTH, mode=m, hotness=h)
                                for n, (m, h) in specs.items()])
    g = torch.Generator().manual_seed(3)
    tables = {n: torch.randn((ROWS, WIDTH), generator=g) for n in specs}
    tables["g"].requires_grad_(requires_grad)
    ids = {n: torch.randint(0, ROWS, (BATCH, h), generator=g) for n, (_, h) in specs.items()}
    ids["bag"] = ids["bag"].reshape(-1)
    weights = {"w": torch.rand((BATCH, 4), generator=g)}
    offsets = {"bag": torch.arange(0, BATCH * 3 + 1, 3)}
    return coll, tables, ids, weights, offsets


def _per_table(coll, tables, ids, weights, offsets, backend="auto"):
    out = {}
    for n, idx in ids.items():
        mode = coll.configs[n].mode
        if n in offsets:
            out[n] = embedding_lookup_csr(tables[n], idx, offsets[n], weights.get(n),
                                          mode=mode, backend=backend)
        else:
            out[n] = embedding_lookup(tables[n], idx, weights.get(n), mode=mode,
                                      backend=backend)
    return out


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
def test_apply_routes_a_mixed_call_by_the_rule(on_cuda, grad):
    coll, tables, ids, weights, offsets = _mixed(requires_grad=True)
    before = trace.counters()
    with torch.set_grad_enabled(grad):
        got = coll.apply(tables, ids, weights, offsets)
        delta = _delta(before)
        want = _per_table(coll, tables, ids, weights, offsets, backend="xla")
    batched = ["a", "b", "w"] + ([] if grad else ["g"])
    assert on_cuda == [[tables[n].data_ptr() for n in batched]]
    assert delta["collection.batched_tables"] == len(batched)
    assert delta["launch.k1_batch"] == 1
    assert delta["launch.k1"] == len(batched) + grad  # "g" by the one-lookup path
    assert list(got) == list(ids)
    for n in ids:
        assert torch.equal(got[n], want[n]), n
    assert got["g"].requires_grad is grad


@pytest.mark.parametrize("kw", [dict(tiered=True), dict(backend="xla")],
                         ids=["tiered", "xla"])
def test_apply_takes_the_per_table_route_tiered_or_off_the_kernels(on_cuda, kw):
    coll, tables, ids, weights, offsets = _mixed()
    got = coll.apply(tables, ids, weights, offsets, **kw)
    assert on_cuda == []
    want = _per_table(coll, tables, ids, weights, offsets, backend="xla")
    assert all(torch.equal(got[n], want[n]) for n in ids)


def test_cpu_tables_take_the_per_table_route():
    coll, tables, ids, weights, offsets = _mixed()
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        coll.apply(tables, ids, weights, offsets)
    events = reduce(prof.profiler.kineto_results.events())
    names = [n for n, *_ in events.ops if n.startswith(trace.PREFIX)]
    assert names.count(trace.PREFIX + "api.lookup") == len(ids)
    assert trace.PREFIX + "launch.k1_batch" not in names
    delta = _delta(before)
    assert delta["collection.batched_tables"] == delta["launch.k1_batch"] == 0


# -- the plan cache and the descriptors ---------------------------------------

@pytest.mark.parametrize("nvec,batch,weighted", [(8, 100, False), (8, 700, True),
                                                 (32, 65536, False), (2, 1, True),
                                                 (33, 5000, False)])
def test_plan_cache_returns_launch_plans_plan(nvec, batch, weighted):
    want = cuda_forward.launch_plan.__wrapped__(nvec, batch, csr=False, weighted=weighted)
    assert cuda_forward.launch_plan(nvec, batch, False, weighted) == want
    assert cuda_forward.launch_plan(nvec, batch, False, weighted) is cuda_forward.launch_plan(
        nvec, batch, False, weighted)


# (table dtype, width, index dtype, weighted, mode, batch, hotness)
LOOKUPS = [
    (torch.float16, 128, torch.int64, False, SUM, 9, 3),
    (torch.float16, 128, torch.int64, False, SUM, 9, 100),
    (torch.float32, 7, torch.int32, True, SUM, 9, 4),
    (torch.bfloat16, 36, torch.int64, False, MEAN, 5, 6),
    (torch.float16, 2, torch.int32, False, MEAN, 9, 1),
    (torch.float32, 128, torch.int64, False, SUM, 0, 2),
]


def _lookups(rows=40):
    g = torch.Generator().manual_seed(5)
    tables, ids, ws, modes = [], [], [], []
    for dtype, width, idt, weighted, mode, batch, hot in LOOKUPS:
        tables.append(torch.randn((rows, width), generator=g).to(dtype))
        ids.append(torch.randint(0, rows, (batch, hot), generator=g).to(idt))
        ws.append(torch.rand((batch, hot), generator=g) if weighted else None)
        modes.append(mode)
    return tables, ids, ws, modes


@pytest.mark.parametrize("lpm", [False, True], ids=["fp32_sums", "low_precision"])
def test_descriptor_words_are_the_per_table_launch_arguments(on_cuda, lpm):
    tables, ids, ws, modes = _lookups()
    outs, descs = cuda_forward.pack_fixed_many(tables, ids, ws, modes,
                                               low_precision_math=lpm)
    (device, words), = descs.items()
    assert device == torch.device("cpu")
    launched = [i for i, o in enumerate(outs) if o.numel()]
    assert len(words) == W * len(launched)
    for k, i in enumerate(launched):
        t, idx, w, out, mode = tables[i], ids[i], ws[i], outs[i], modes[i]
        d = words[W * k:W * (k + 1)]
        itemsize = t.element_size()
        vec = next((v for v in (16, 8) if (t.shape[1] * itemsize) % v == 0
                    and t.data_ptr() % v == 0 and out.data_ptr() % v == 0), itemsize)
        acc = accumulation_dtype(t.dtype, lpm)
        scale = rounded_reciprocal(idx.shape[1], acc) if mode == MEAN else 1.0
        assert d[:14] == [t.data_ptr(), idx.data_ptr(), 0 if w is None else w.data_ptr(),
                          out.data_ptr(), t.shape[0], idx.shape[0], idx.shape[1],
                          t.shape[1], idx.element_size(), vec,
                          _build.DTYPE_CODE[t.dtype], int(acc != torch.float32),
                          struct.unpack("<I", struct.pack("<f", scale))[0],
                          int(mode == MEAN)]
        assert tuple(d[14:]) == cuda_forward.launch_plan.__wrapped__(
            t.shape[1] * itemsize // vec, idx.shape[0], csr=False, weighted=w is not None)
        assert np.float32(struct.unpack("<f", struct.pack("<I", d[12]))[0]) == np.float32(
            scale)


def test_outputs_share_a_buffer_per_batch_width_dtype_and_device(on_cuda):
    tables, ids, ws, modes = _lookups()
    outs, _ = cuda_forward.pack_fixed_many(tables, ids, ws, modes)
    for out, t, idx in zip(outs, tables, ids):
        assert out.shape == (idx.shape[0], t.shape[1]) and out.dtype == t.dtype
        assert out.is_contiguous()
    storage = [o.untyped_storage().data_ptr() for o in outs]
    # lookups 0 and 1 share (9, 128, fp16); every other lookup has its own key
    # and a tensor of its own
    assert storage[0] == storage[1] and outs[0].data_ptr() != outs[1].data_ptr()
    assert len(set(storage[1:])) == len(outs) - 1
    assert all(o._base is None for o in outs[2:])


def test_a_lookup_without_work_has_no_descriptor(on_cuda):
    tables, ids, ws, modes = _lookups()
    _, descs = cuda_forward.pack_fixed_many(tables[-1:], ids[-1:], ws[-1:], modes[-1:])
    assert descs == {}


def _bad(kind):
    g = torch.Generator().manual_seed(1)
    table = torch.randn((20, 8), generator=g)
    idx = torch.randint(0, 20, (4, 3), generator=g)
    w, mode = None, SUM
    if kind == "index dtype":
        idx = idx.to(torch.int16)
    elif kind == "weights with mean":
        w, mode = torch.rand((4, 3), generator=g), MEAN
    elif kind == "flat indices":
        idx = idx.reshape(-1)
    elif kind == "3-d table":
        table = table.reshape(4, 5, 8)
    elif kind == "float64 table":
        table = table.double()
    elif kind == "weights shape":
        w = torch.rand((4, 2), generator=g)
    elif kind == "mean of no positions":  # raises on the card only
        idx, mode = idx[:, :0], MEAN
    return table, idx, w, mode


@pytest.mark.parametrize("kind", ["index dtype", "weights with mean", "flat indices",
                                  "3-d table", "float64 table", "weights shape"])
def test_bad_inputs_raise_the_per_table_routes_error(on_cuda, kind):
    table, idx, w, mode = _bad(kind)
    with pytest.raises(ValueError) as per_table:
        embedding_lookup(table, idx, w, mode=mode)
    good = _bad(None)
    with pytest.raises(ValueError) as batched:
        embedding_lookup_many([good[0], table], [good[1], idx], [None, w], [SUM, mode])
    assert str(batched.value) == str(per_table.value)


def test_a_lookup_its_checks_accept_and_the_host_pass_refuses_raises(monkeypatch):
    # The checks pass CPU tensors as on the card; the host pass still refuses
    # them (not on the card): the two tests disagree, so nothing falls back.
    table, idx, w, mode = _bad(None)
    monkeypatch.setattr(_build, "check_placement", lambda tensors: True)
    before = trace.counters()
    with pytest.raises(RuntimeError, match="refused a lookup that its checks accept"):
        cuda_forward.embedding_forward_cuda(table, idx, w, mode=mode)
    assert _delta(before)["launch.k1"] == 0


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dlrmv2(card, batch, rows=1000, dtype=torch.float16, index_dtype=torch.int64):
    g = torch.Generator(device=card).manual_seed(batch)
    names = [f"t{i}" for i in range(len(DLRMV2_HOTNESS))]
    coll = EmbeddingCollection([TableConfig(n, rows, 128, dtype=dtype, hotness=h)
                                for n, h in zip(names, DLRMV2_HOTNESS)])
    tables = {n: torch.randn((rows, 128), device=card, generator=g).to(dtype) for n in names}
    ids = {n: torch.randint(0, rows, (batch, h), device=card, generator=g).to(index_dtype)
           for n, h in zip(names, DLRMV2_HOTNESS)}
    return coll, tables, ids


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 100, 700, 4096])
def test_batched_apply_equals_the_per_table_lookups_at_dlrmv2_hotness(card, batch):
    coll, tables, ids = _dlrmv2(card, batch)
    coll.apply(tables, ids)  # the library loaded
    before = trace.counters()
    got = coll.apply(tables, ids)
    delta = _delta(before)
    assert (delta["launch.k1"], delta["launch.k1_batch"],
            delta["collection.batched_tables"]) == (26, 1, 26)
    for n, idx in ids.items():
        assert torch.equal(got[n], embedding_lookup(tables[n], idx)), n


@pytest.mark.cuda
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "sum_w", "mean"])
def test_batched_apply_equals_the_per_table_lookups(card, mode, dtype, index_dtype):
    # every load width; t3 and t5 share (batch, width, dtype): one buffer, two views
    widths, hots = (2, 7, 36, 128, 514, 128), (1, 5, 19, 64, 3, 64)
    m = CombineMode(mode.removesuffix("_w"))
    g = torch.Generator(device=card).manual_seed(len(mode))
    names = [f"t{i}" for i in range(len(widths))]
    coll = EmbeddingCollection([TableConfig(n, 300, wd, mode=m, dtype=dtype)
                                for n, wd in zip(names, widths)])
    tables = {n: torch.randn((300, wd), device=card, generator=g).to(dtype)
              for n, wd in zip(names, widths)}
    ids = {n: torch.randint(0, 300, (67, h), device=card, generator=g).to(index_dtype)
           for n, h in zip(names, hots)}
    w = ({n: torch.rand(ids[n].shape, device=card, generator=g) for n in names}
         if mode == "sum_w" else None)
    before = trace.counters()
    got = coll.apply(tables, ids, w)
    assert _delta(before)["launch.k1_batch"] == 1
    assert got["t3"].untyped_storage().data_ptr() == got["t5"].untyped_storage().data_ptr()
    for n in names:
        want = embedding_lookup(tables[n], ids[n], w[n] if w else None, mode=m)
        assert torch.equal(got[n], want), n


@pytest.mark.cuda
def test_a_mixed_call_routes_each_table_and_equals_the_per_table_route(card):
    coll, tables, ids, weights, offsets = _mixed(requires_grad=True)
    tables = {n: t.detach().to(card).requires_grad_(n == "g") for n, t in tables.items()}
    ids = {n: i.to(card) for n, i in ids.items()}
    weights = {n: x.to(card) for n, x in weights.items()}
    offsets = {n: x.to(card) for n, x in offsets.items()}
    before = trace.counters()
    got = coll.apply(tables, ids, weights, offsets)
    delta = _delta(before)
    # a, b, w batched (one call); g (grad), c (CONCAT, no kernel), bag (K2) per table
    assert (delta["collection.batched_tables"], delta["launch.k1_batch"],
            delta["launch.k1"], delta["launch.k2"]) == (3, 1, 4, 1)
    assert got["g"].requires_grad and not got["a"].requires_grad
    want = _per_table(coll, tables, ids, weights, offsets)
    assert all(torch.equal(got[n], want[n]) for n in ids)
    tiered = coll.apply(tables, ids, weights, offsets, tiered=True)
    assert all(torch.equal(tiered[n], want[n]) for n in ids)
    assert _delta(before)["launch.k1_batch"] == 1


@pytest.mark.cuda
def test_one_batched_span_links_every_k1_of_a_26_table_call(card):
    coll, tables, ids = _dlrmv2(card, 300)
    coll.apply(tables, ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        coll.apply(tables, ids)
        torch.cuda.synchronize()
    events = reduce(prof.profiler.kineto_results.events())
    spans = [c for n, _, _, c in events.ops if n == trace.PREFIX + "launch.k1_batch"]
    k1 = [d for d in events.device if "fixed_forward_kernel" in d[0]]
    assert len(spans) == 1 and len(k1) == 26
    assert {d[3] for d in k1} == set(spans)
    names = {n for n, *_ in events.ops}
    assert not names & {trace.PREFIX + s for s in ("api.lookup", "dispatch.forward",
                                                    "launch.k1")}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["index dtype", "weights with mean", "flat indices",
                                  "float64 table", "weights shape", "weights on the host",
                                  "mean of no positions"])
def test_bad_inputs_on_the_card_raise_the_per_table_routes_error(card, kind):
    table, idx, w, mode = _bad(kind)
    table, idx = table.to(card), idx.to(card)
    if kind == "weights on the host":
        w = torch.rand(idx.shape)
    elif w is not None:
        w = w.to(card)
    coll = EmbeddingCollection([TableConfig("t", 20, 8, mode=mode)])
    with pytest.raises(Exception) as per_table:
        embedding_lookup(table, idx, w, mode=mode)
    before = trace.counters()
    with pytest.raises(Exception) as batched:
        coll.apply({"t": table}, {"t": idx}, {"t": w} if w is not None else None)
    assert type(batched.value) is type(per_table.value)
    assert str(batched.value) == str(per_table.value)
    assert _delta(before)["launch.k1"] == 0
