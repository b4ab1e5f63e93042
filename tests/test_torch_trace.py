"""The port's spans and counters (``cuembed_tpu_torch/utils/trace.py``).

On the CPU: under ``torch.profiler`` a collection's lookup and AdaGrad update
give the spans of each host layer, nested, which the benchmark's trace
reduction keeps as they are; the AdaGrad update waits for nothing, and each
``wait.*`` span of an SGD update is a ``wait.*`` count; with no profiler
recording no span is entered; a compile of the library is counted and
spanned. On the card (``-m cuda``): K1's, K3's, K4's and K5's kernels link to
their launch spans by correlation id, a lookup and an AdaGrad update read
nothing back to the host (the update transposes once a table on K5), and
every host read of an SGD update is inside a ``wait.*`` span.
"""

import stat
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cuembed_tpu_torch.collection import EmbeddingCollection, TableConfig
from cuembed_tpu_torch.ops import _build
from cuembed_tpu_torch.utils import trace
from portbench.tracing import reduce

TABLES = 3
ROWS, WIDTH, HOTNESS, BATCH = 100, 8, 3, 5
LOOKUP = ("collection.apply", "api.lookup", "dispatch.forward")
UPDATE = ("collection.adagrad_update", "train.row_sums", "dispatch.backward_compressed",
          "train.adagrad")
# The host reads of SGD's update (AdaGrad's makes none).
WAITS = ("wait.num_unique", "wait.keep_mask")
# Each span and the span it lies in.
PARENT = {"api.lookup": "collection.apply", "dispatch.forward": "api.lookup",
          "train.row_sums": "collection.adagrad_update",
          "dispatch.backward_compressed": "train.row_sums",
          "train.adagrad": "collection.adagrad_update"}


def _problem(device="cpu"):
    g = torch.Generator(device=device).manual_seed(0)
    coll = EmbeddingCollection([TableConfig(f"t{i}", ROWS, WIDTH, hotness=HOTNESS)
                                for i in range(TABLES)])
    names = [f"t{i}" for i in range(TABLES)]
    tables = {n: torch.randn((ROWS, WIDTH), generator=g, device=device) for n in names}
    ids = {n: torch.randint(0, ROWS, (BATCH, HOTNESS), generator=g, device=device)
           for n in names}
    gy = {n: torch.randn((BATCH, WIDTH), generator=g, device=device) for n in names}
    return coll, tables, coll.adagrad_init(device=device), ids, gy


def _step(coll, tables, accums, ids, gy):
    coll.apply(tables, ids)
    coll.adagrad_update(tables, accums, ids, gy, lr=0.1)


def _sgd_step(coll, tables, accums, ids, gy):
    coll.sgd_update(tables, ids, gy, lr=0.1)


def _traced(step):
    """``step`` of a collection under the profiler: the raw events, their
    reduction, and the counters' change."""
    problem = _problem()
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(*problem)
    after = trace.counters()
    raw = list(prof.profiler.kineto_results.events())
    return raw, reduce(raw), {k: after[k] - before[k] for k in after}


@pytest.fixture(scope="module")
def traced():
    """One lookup and one AdaGrad update of the collection."""
    return _traced(_step)


@pytest.fixture(scope="module")
def traced_sgd():
    """One SGD update of the collection, which still reads sizes back."""
    return _traced(_sgd_step)


def _spans(events, name):
    return sorted((s, e) for n, s, e, _ in events.ops if n == trace.PREFIX + name)


@pytest.mark.parametrize("name", LOOKUP + UPDATE + WAITS)
def test_each_layer_has_its_spans(traced, traced_sgd, name):
    _, events, _ = traced_sgd if name in WAITS else traced
    once = name.startswith("collection.")
    assert len(_spans(events, name)) == (1 if once else TABLES)


@pytest.mark.parametrize("name", sorted(PARENT))
def test_spans_nest_in_their_layer(traced, name):
    _, events, _ = traced
    parents = _spans(events, PARENT[name])
    for s, e in _spans(events, name):
        assert any(ps <= s and e <= pe for ps, pe in parents), (name, s, e)


def test_no_launch_span_on_the_cpu(traced):
    _, events, delta = traced
    assert not [n for n, *_ in events.ops if n.startswith(trace.PREFIX + "launch.")]
    assert not any(delta[k] for k in delta if k.startswith("launch."))


def test_the_benchmark_keeps_the_spans_as_they_are(traced):
    raw, events, _ = traced
    mine = sorted((e.name(), e.start_ns() / 1e3, e.start_ns() / 1e3 + e.duration_ns() / 1e3)
                  for e in raw if e.name().startswith(trace.PREFIX))
    kept = sorted((n, s, e) for n, s, e, _ in events.ops if n.startswith(trace.PREFIX))
    assert mine == pytest.approx(kept)
    assert len(kept) == 2 + (len(LOOKUP) + len(UPDATE) - 2) * TABLES


@pytest.mark.parametrize("site", ["num_unique", "keep_mask"])
def test_wait_spans_are_wait_counts(traced_sgd, site):
    _, events, delta = traced_sgd
    assert delta["wait." + site] == len(_spans(events, "wait." + site)) == TABLES


def test_adagrad_update_waits_for_nothing(traced):
    _, events, delta = traced
    assert [delta[w] for w in WAITS] == [0, 0]
    assert not [n for n, *_ in events.ops if n.startswith(trace.PREFIX + "wait.")]


def test_counters_are_snapshots():
    c = trace.counters()
    assert set(c) == {"launch.k1", "launch.k2", "launch.k3_full", "launch.k3_compressed",
                      "launch.k4", "launch.k5", "launch.k1_batch", "collection.batched_tables",
                      "wait.num_unique", "wait.keep_mask", "build"}
    c["wait.num_unique"] += 100
    assert trace.counters()["wait.num_unique"] == c["wait.num_unique"] - 100


def test_no_span_without_a_profiler(monkeypatch):
    entered = []

    def spy(name):
        entered.append(name)
        return torch._C._profiler._RecordFunctionFast(name)

    def refuse(self):
        raise AssertionError(f"record_function entered: {self.name}")

    monkeypatch.setattr(trace, "_range", spy)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", refuse)
    problem = _problem()
    coll, tables, _, ids, _ = problem
    _step(*problem)
    coll.apply(tables, {n: x.reshape(-1) for n, x in ids.items()},
               offsets={n: torch.arange(0, BATCH * HOTNESS + 1, HOTNESS) for n in ids})
    assert entered == [] and not trace.on()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.on()
        coll.apply(tables, ids)
    assert not trace.on()
    assert entered == ["cuembed::" + n for n in ("collection.apply",)
                       + ("api.lookup", "dispatch.forward") * TABLES]


def _fake_nvcc(tmp_path):
    """An nvcc that writes an empty file wherever ``-o`` points."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$#" -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi\n  shift\ndone\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return nvcc


def test_a_compile_is_counted_and_spanned(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(_fake_nvcc(tmp_path)))
    src = tmp_path / "csrc"
    src.mkdir()
    for name in _build.SOURCES + _build.HEADERS:
        (src / name).write_text("// fake\n")
    monkeypatch.setattr(_build, "SOURCE_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    before = trace.counters()["build"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        path = _build.build()
    assert path.exists() and trace.counters()["build"] == before + 1
    events = reduce(prof.profiler.kineto_results.events())
    assert len(_spans(events, "build")) == 1
    assert _build.build() == path  # loaded, not compiled: not counted
    assert trace.counters()["build"] == before + 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


K1 = ("fixed_forward_kernel",)
K3 = ("coo_backward_kernel", "coo_backward_fixup_kernel", "run_count_kernel", "run_scan_kernel")
K4 = ("rowwise_adagrad_apply_kernel",)
K5 = ("histogram_kernel", "digit_pass_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("launch,kernels,spans", [
    ("launch.k1_batch", K1, 1), ("launch.k3", K3, TABLES), ("launch.k4", K4, TABLES),
    ("launch.k5", K5, TABLES)],
    ids=["k1", "k3", "k4", "k5"])
def test_kernels_link_to_their_launch_span(card, launch, kernels, spans):
    """On the card the collection's lookups take the batched forward: every
    table's K1 links to its one ``launch.k1_batch`` span."""
    problem = _problem(card)
    _step(*problem)  # the library loaded outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _step(*problem)
        torch.cuda.synchronize()
    events = reduce(prof.profiler.kineto_results.events())
    linked = {c for n, _, _, c in events.ops if n == trace.PREFIX + launch}
    mine = [d for d in events.device if any(k in d[0] for k in kernels)]
    assert len(linked) == spans and mine
    assert {d[3] for d in mine} == linked
    # the spans draw nothing on the device's timeline
    names = {n for n, *_ in events.ops if n.startswith(trace.PREFIX)}
    assert names and not [d for d in events.device if d[0] in names]


@pytest.fixture
def sync_warnings(card):
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield seen
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _syncs(seen):
    return [w for w in seen if not isinstance(w, str) and "synchroniz" in str(w.message)]


@pytest.mark.cuda
def test_a_lookup_reads_nothing_back(card, sync_warnings):
    coll, tables, _, ids, _ = _problem(card)
    coll.apply(tables, ids)
    torch.cuda.synchronize()
    sync_warnings.clear()
    coll.apply(tables, ids)
    assert _syncs(sync_warnings) == []


@pytest.mark.cuda
def test_an_adagrad_update_reads_nothing_back(card):
    coll, tables, accums, ids, gy = _problem(card)
    _step(coll, tables, accums, ids, gy)
    torch.cuda.synchronize()
    before = trace.counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        coll.adagrad_update(tables, accums, ids, gy, lr=0.1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = trace.counters()
    assert after["launch.k4"] - before["launch.k4"] == TABLES
    assert after["launch.k5"] - before["launch.k5"] == TABLES
    assert [after[w] - before[w] for w in WAITS] == [0, 0]


@pytest.mark.cuda
def test_k4_spans_nest_in_the_adagrad_span(card):
    problem = _problem(card)
    _step(*problem)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _step(*problem)
        torch.cuda.synchronize()
    events = reduce(prof.profiler.kineto_results.events())
    parents, mine = _spans(events, "train.adagrad"), _spans(events, "launch.k4")
    assert len(mine) == TABLES
    assert all(any(ps <= s and e <= pe for ps, pe in parents) for s, e in mine)


@pytest.mark.cuda
def test_every_host_read_of_an_update_is_a_wait(card, sync_warnings, monkeypatch):
    problem = _problem(card)
    _sgd_step(*problem)
    torch.cuda.synchronize()
    real = trace.wait

    def marked(site, read, *args):
        sync_warnings.append("enter")
        try:
            return real(site, read, *args)
        finally:
            sync_warnings.append("exit")

    monkeypatch.setattr(trace, "wait", marked)
    sync_warnings.clear()
    _sgd_step(*problem)
    depth, outside = 0, []
    for w in sync_warnings:
        if isinstance(w, str):
            depth += 1 if w == "enter" else -1
        elif "synchroniz" in str(w.message) and depth == 0:
            outside.append(str(w.message))
    assert _syncs(sync_warnings) and outside == []
