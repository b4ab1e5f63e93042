"""The COO transpose (``dispatch.transpose``; K5, ``ops/cuda_transforms.py``).

On the CPU: ``dispatch.transpose`` takes the plain version for CPU tensors
and under ``"xla"``, equal to ``transforms.transpose_position_ordered`` with
the sample ids made by hand, on fixed, CONCAT and CSR COOs, with and without
coefficients, with the sentinel; that every backend but ``"xla"`` is
handed to K5's wrapper; the fixed-hotness sample ids; K5's key bits and
passes from a table's rows; the wrapper's refusals; the ``launch.k5``
counter. On the card (``-m cuda``): the library's plan against
``sort_plan``; K5 equal to the ``torch.sort`` route bit for bit over id
dtypes, sizes, row counts, id laws and COO forms; an autograd backward
under ``"tiered"`` and ``"narrow"`` on K5, bit for bit the sort route; the
sparse updates leave tables and state bit for bit as the ``torch.sort``
route does where several distinct out-of-range ids are present; a 26-table
DLRM-v2-shaped AdaGrad update transposes once a table on K5, bit for bit as
the ``torch.sort`` route.
"""

import pytest
import torch

from cuembed_tpu_torch.collection import EmbeddingCollection, TableConfig
from cuembed_tpu_torch.ops import cuda_transforms, dispatch
from cuembed_tpu_torch.ops.lookup_torch import SENTINEL
from cuembed_tpu_torch.ops.transforms import fixed_sample_ids, transpose_position_ordered
from cuembed_tpu_torch.train import rowwise_adagrad_sparse_update, sgd_sparse_update
from cuembed_tpu_torch.utils import trace

FORMS = ["fixed", "concat", "csr"]


def _coo(form, n, num_rows, dtype, weighted, device, seed=0, law="uniform"):
    """``(ids, sample-id keyword, coeff, the sample ids)`` of a COO of ``n``
    positions into ``num_rows`` rows, about 1% of them the sentinel and, for
    int64, 1% at -1 (one value below 0 and one at or past the rows)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if law == "uniform":
        ids = torch.randint(0, num_rows, (n,), generator=g, device=device)
    else:  # heavy at the low rows, many repeats
        u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
        ids = (num_rows ** u).long().clamp(1, num_rows) - 1
    mark = torch.rand(n, generator=g, device=device)
    ids = torch.where(mark < 0.01, SENTINEL, ids)
    if dtype == torch.int64:
        ids = torch.where(mark > 0.99, -1, ids)
    ids = ids.to(dtype)
    if form == "csr":
        sids = torch.sort(torch.randint(0, max(1, n // 3), (n,), generator=g,
                                        device=device)).values.to(torch.int32)
        rows_of = {"sample_ids": sids}
    else:
        hotness = 1 if form == "concat" else 64
        sids = torch.arange(n, dtype=torch.int32, device=device) // hotness
        rows_of = {"hotness": hotness}
    coeff = torch.rand(n, generator=g, device=device) if weighted else None
    return ids, rows_of, coeff, sids


def _same(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "coeff"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_plain_route_is_the_stable_sort(backend, form, dtype, weighted):
    ids, rows_of, coeff, sids = _coo(form, 777, 36, dtype, weighted, "cpu")
    assert (ids == SENTINEL).any()
    got = dispatch.transpose(ids, 36, **rows_of, coeff=coeff, backend=backend)
    _same(got, transpose_position_ordered(sids, ids, coeff))


def test_plain_route_takes_every_backend_but_the_kernels():
    ids, rows_of, coeff, sids = _coo("fixed", 130, 10, torch.int64, True, "cpu")
    want = transpose_position_ordered(sids, ids, coeff)
    for backend in dispatch.BACKENDS:
        _same(dispatch.transpose(ids, 10, **rows_of, coeff=coeff, backend=backend), want)
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.transpose(ids, 10, **rows_of, backend="tpu")


@pytest.mark.parametrize("num_rows,bits,passes", [
    (3, 3, 1), (36, 6, 1), (10_000_000, 24, 3), (40_000_000, 26, 4), (2**31 - 3, 31, 4)])
def test_sort_plan_sorts_only_the_bits_of_the_rows(num_rows, bits, passes):
    """Keys run over 0..num_rows + 1 (-1 and num_rows the two out-of-range
    buckets), in as many 8-bit passes as their bits need."""
    assert cuda_transforms.sort_plan(num_rows) == (bits, passes)
    assert (num_rows + 1) >> bits == 0 and (num_rows + 1) >> (bits - 1) == 1


@pytest.mark.parametrize("backend", dispatch.BACKENDS)
def test_transpose_routes_every_backend_but_xla_to_k5(monkeypatch, backend):
    """``dispatch.transpose`` hands the call to K5's wrapper under every
    backend but ``"xla"``, as K3 and K4 are routed (the wrapper itself sends
    CPU tensors to the plain version), and to the plain version under
    ``"xla"``."""
    seen = []
    monkeypatch.setattr(cuda_transforms, "coo_transpose_cuda",
                        lambda *args, **kwargs: seen.append("k5"))
    monkeypatch.setattr(cuda_transforms, "coo_transpose_torch",
                        lambda *args, **kwargs: seen.append("plain"))
    dispatch.transpose(torch.zeros(4, dtype=torch.int64), 10, hotness=2, backend=backend)
    assert seen == ["plain" if backend == "xla" else "k5"]


@pytest.mark.parametrize("n,hotness", [(0, 3), (7, 1), (12, 4), (13, 5)])
def test_fixed_sample_ids_are_the_position_over_the_hotness(n, hotness):
    got = fixed_sample_ids(n, hotness, device="cpu")
    assert got.dtype == torch.int32 and got.tolist() == [p // hotness for p in range(n)]


def test_wrapper_refuses_what_k5_does_not_take():
    meta = torch.empty(2**31, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="fewer than 2\\*\\*31 positions"):
        cuda_transforms.coo_transpose_cuda(meta, 10, hotness=1)
    ids = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="2\\*\\*31 - 2 rows"):
        cuda_transforms.coo_transpose_cuda(ids, 2**31 - 1, hotness=1)
    with pytest.raises(ValueError, match="exactly one"):
        cuda_transforms.coo_transpose_cuda(ids, 10, hotness=1,
                                           sample_ids=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="exactly one"):
        cuda_transforms.coo_transpose_cuda(ids, 10)
    with pytest.raises(ValueError, match="sample_ids"):
        cuda_transforms.coo_transpose_cuda(ids, 10, sample_ids=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="coeff"):
        cuda_transforms.coo_transpose_cuda(ids, 10, hotness=2,
                                           coeff=torch.ones(4, dtype=torch.int32))


def test_launch_k5_is_a_counter():
    assert "launch.k5" in trace.counters()


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sort_route(monkeypatch):
    """Every transpose through the ``torch.sort`` route, as before K5."""
    monkeypatch.setattr(cuda_transforms, "coo_transpose_cuda",
                        cuda_transforms.coo_transpose_torch)


@pytest.mark.cuda
@pytest.mark.parametrize("num_rows", [3, 36, 10_000_000, 40_000_000])
@pytest.mark.parametrize("n", [0, 1, 4096, 6_553_600])  # 4096: one tile (kTileKeys)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_k5_equals_the_sort_route(card, dtype, n, num_rows):
    for law in ("uniform", "power"):
        for form, weighted in (("fixed", True), ("fixed", False), ("concat", False),
                               ("csr", True)):
            ids, rows_of, coeff, sids = _coo(form, n, num_rows, dtype, weighted, card,
                                             seed=n + num_rows, law=law)
            before = trace.counters()["launch.k5"]
            got = cuda_transforms.coo_transpose_cuda(ids, num_rows, **rows_of, coeff=coeff)
            assert trace.counters()["launch.k5"] == before + 1
            _same(got, transpose_position_ordered(sids, ids, coeff))


@pytest.mark.cuda
@pytest.mark.parametrize("num_rows", [3, 36, 10_000_000, 40_000_000, 2**31 - 3])
def test_library_plans_what_sort_plan_states(card, num_rows):
    """The library's plan (``csrc/transpose.cu``'s ``plan()``, which K5 runs)
    sorts the bits ``sort_plan`` states, and its scratch holds the passes'
    keys and positions: one pair for two passes, two pairs past that."""
    n = 6_553_600
    bits, passes, scratch = cuda_transforms.library_plan(n, num_rows)
    assert (bits, passes) == cuda_transforms.sort_plan(num_rows)
    assert scratch >= min(passes - 1, 2) * 2 * n * 4
    with pytest.raises(RuntimeError):
        cuda_transforms.library_plan(2**31, num_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["tiered", "narrow"])
def test_autograd_backward_transposes_on_k5_under_every_kernel_backend(card, monkeypatch,
                                                                      backend):
    """A lookup's autograd backward under ``"tiered"`` (width 256) or
    ``"narrow"`` (width 32) transposes once on K5 and sums once on K3, and
    its gradient is the ``torch.sort`` route's bit for bit."""
    from cuembed_tpu_torch.ops.api import embedding_lookup
    from cuembed_tpu_torch.ops.tiered import TieredConfig

    rows, width, batch, hotness = 1000, 256 if backend == "tiered" else 32, 256, 8
    cfg = TieredConfig(hot_rows=128, chunk_elems=64, cold_slots=32, mxu_head_rows=32,
                       mid_slots=32)
    g = torch.Generator(device=card).manual_seed(7)
    table = torch.randn((rows, width), generator=g, device=card)
    ids = torch.randint(0, rows, (batch, hotness), generator=g, device=card)
    ids[:, :3] %= 32  # head traffic
    w = torch.rand((batch, hotness), generator=g, device=card)
    gy = torch.randn((batch, width), generator=g, device=card)

    def grad():
        t = table.clone().requires_grad_()
        (embedding_lookup(t, ids, w, backend=backend, tiered_cfg=cfg) * gy).sum().backward()
        return t.grad

    keys = ("launch.k5", "launch.k3_full")
    before = trace.counters()
    got = grad()
    torch.cuda.synchronize()
    after = trace.counters()
    assert [after[k] - before[k] for k in keys] == [1, 1]
    with monkeypatch.context() as m:
        _sort_route(m)
        want = grad()
    assert trace.counters()["launch.k5"] == after["launch.k5"]
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("coeff_dtype", [torch.float16, torch.bfloat16, torch.float64])
def test_k5_carries_every_coefficient_and_sample_id_width(card, coeff_dtype):
    ids, _, coeff, sids = _coo("csr", 50_000, 1000, torch.int64, True, card)
    coeff, sids = coeff.to(coeff_dtype), sids.long()
    got = cuda_transforms.coo_transpose_cuda(ids, 1000, sample_ids=sids, coeff=coeff)
    _same(got, transpose_position_ordered(sids, ids, coeff))
    view = ids[::2]  # a strided input, read through a copy
    _same(cuda_transforms.coo_transpose_cuda(view, 1000, hotness=3),
          transpose_position_ordered(
              torch.arange(view.shape[0], dtype=torch.int32, device=card) // 3, view, None))


@pytest.mark.cuda
def test_k5_keeps_several_out_of_range_values_in_position_order(card):
    ids = torch.tensor([5, -3, 2, 9, -1, 12, 5, -3, 10, 2], device=card)
    t_idx, t_sid, _ = cuda_transforms.coo_transpose_cuda(ids, 9, hotness=1)
    assert t_idx.tolist() == [-3, -1, -3, 2, 2, 5, 5, 9, 12, 10]
    assert t_sid.tolist() == [1, 4, 7, 2, 9, 0, 6, 3, 5, 8]


@pytest.mark.cuda
@pytest.mark.parametrize("update", ["adagrad", "sgd"])
@pytest.mark.parametrize("form", ["fixed", "csr"])
def test_updates_with_several_out_of_range_ids_match_the_sort_route(card, monkeypatch,
                                                                    update, form):
    rows, width, batch, hotness = 5000, 64, 512, 8
    g = torch.Generator(device=card).manual_seed(3)
    ids = torch.randint(0, rows, (batch, hotness), generator=g, device=card)
    bad = torch.tensor([-7, -1, rows, rows + 3, SENTINEL], device=card)
    pick = torch.randint(0, bad.numel(), ids.shape, generator=g, device=card)
    ids = torch.where(torch.rand(ids.shape, generator=g, device=card) < 0.05, bad[pick], ids)
    gy = torch.randn((batch, width), generator=g, device=card)
    kw = {}
    if form == "csr":
        kw["offsets"] = torch.arange(0, batch * hotness + 1, hotness, device=card)
        kw["weights"] = torch.rand(batch * hotness, generator=g, device=card)
        ids = ids.reshape(-1)
    table = torch.randn((rows, width), generator=g, device=card).to(torch.float16)
    accum = torch.rand(rows, generator=g, device=card)

    def step():
        t, a = table.clone(), accum.clone()
        if update == "adagrad":
            rowwise_adagrad_sparse_update(t, a, ids, gy, lr=0.01, **kw)
        else:
            sgd_sparse_update(t, ids, gy, lr=0.01, **kw)
        return t, a

    before = trace.counters()["launch.k5"]
    got = step()
    assert trace.counters()["launch.k5"] == before + 1
    with monkeypatch.context() as m:
        _sort_route(m)
        want = step()
    assert trace.counters()["launch.k5"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


# MLPerf DLRM-v2's 26 tables (portbench/configs/dlrmv2-criteo-mh.json), at a
# narrow width: the rows set K5's passes, not the width.
DLRMV2_ROWS = (40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
               40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
               40_000_000, 40_000_000, 40_000_000, 590_152, 12_973, 108, 36)
DLRMV2_HOTNESS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27,
                  10, 3, 1, 1)


@pytest.mark.cuda
def test_dlrmv2_adagrad_update_transposes_each_table_once_on_k5(card, monkeypatch):
    batch, width = 4096, 16
    g = torch.Generator(device=card).manual_seed(26)
    names = [f"t{i}" for i in range(len(DLRMV2_ROWS))]
    coll = EmbeddingCollection([TableConfig(n, r, width, dtype=torch.float16, hotness=h)
                                for n, r, h in zip(names, DLRMV2_ROWS, DLRMV2_HOTNESS)])
    tables = {n: torch.randn((r, width), device=card, generator=g).to(torch.float16)
              for n, r in zip(names, DLRMV2_ROWS)}
    ids = {n: torch.randint(0, r, (batch, h), device=card, generator=g)
           for n, r, h in zip(names, DLRMV2_ROWS, DLRMV2_HOTNESS)}
    gy = {n: torch.randn((batch, width), device=card, generator=g) for n in names}
    accums = coll.adagrad_init(device=card)
    t_sort = {n: t.clone() for n, t in tables.items()}
    a_sort = {n: a.clone() for n, a in accums.items()}
    coll.adagrad_update(tables, accums, ids, gy, lr=0.01)  # the library loaded
    torch.cuda.synchronize()
    tables = {n: t.clone() for n, t in t_sort.items()}
    accums = {n: a.clone() for n, a in a_sort.items()}
    before = trace.counters()
    coll.adagrad_update(tables, accums, ids, gy, lr=0.01)
    torch.cuda.synchronize()
    after = trace.counters()
    delta = {k: after[k] - before[k] for k in ("launch.k5", "launch.k3_compressed",
                                              "launch.k3_full", "launch.k4")}
    assert delta == {"launch.k5": 26, "launch.k3_compressed": 26, "launch.k3_full": 0,
                     "launch.k4": 26}
    _sort_route(monkeypatch)
    coll.adagrad_update(t_sort, a_sort, ids, gy, lr=0.01)
    assert trace.counters()["launch.k5"] == after["launch.k5"]
    for n in names:
        assert torch.equal(tables[n], t_sort[n]) and torch.equal(accums[n], a_sort[n])
