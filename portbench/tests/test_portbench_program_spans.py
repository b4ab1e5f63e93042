"""The readers of the program's own spans on synthetic traces, and the
program's spans in a tiny cell's traced window on the CPU."""

from __future__ import annotations

import pytest

from portbench import harness, program_spans
from portbench.tracing import Events, Tracer

SERVE = ("collection_us_per_lookup.serve", "api_us_per_lookup.serve",
         "dispatch_us_per_lookup.serve", "launch_us_per_lookup.serve")
TRAIN = ("host_waits_per_step.train", "wait_ms_per_step.train", "wait_idle_ms_per_step.train")


def read(name, ctx):
    return harness.reader(name)(ctx)


def serve_ctx(launches=True):
    # window 0-1000 us; a request of two lookups (K1), one of one (K2), and a
    # span past the window
    c = "cuembed::"
    ops = [("portbench.window", 0, 1000, 1), ("portbench.apply", 5, 115, 2),
           (c + "collection.apply", 10, 110, 3),
           (c + "api.lookup", 20, 60, 4), (c + "dispatch.forward", 30, 55, 5),
           (c + "launch.k1", 40, 50, 6), ("aten::empty", 32, 34, 7),
           (c + "api.lookup", 65, 100, 8), (c + "dispatch.forward", 70, 95, 9),
           (c + "launch.k1", 80, 92, 10),
           (c + "collection.apply", 500, 560, 11),
           (c + "api.lookup", 510, 550, 12), (c + "dispatch.forward", 520, 545, 13),
           (c + "launch.k2", 530, 540, 14),
           (c + "collection.apply", 1200, 1300, 15), (c + "api.lookup", 1210, 1290, 16)]
    if not launches:
        ops = [o for o in ops if "::launch." not in o[0]]
    dev = [("fixed_forward_kernel", 45, 60, 6), ("csr_forward_kernel", 535, 600, 14)]
    return {"loop": "serve", "events": Events(device=dev, ops=ops, window=(0, 1000)),
            "records": [(0, 0.0, 0.0001, 0.0002)] * 2}


def test_serve_split_is_self_time_a_lookup():
    c = serve_ctx()
    # collection 160 - api 115; api 115 - dispatch 75; dispatch 75 - launch 32
    got = [read(n, c) for n in SERVE]
    assert got == pytest.approx([45 / 3, 40 / 3, 43 / 3, 32 / 3])
    assert sum(got) * 3 == pytest.approx(160)  # the collection.apply spans


def test_serve_split_reads_nothing_without_launches_or_spans():
    for c in (serve_ctx(launches=False), dict(serve_ctx(), events=None),
              dict(serve_ctx(), loop="train")):
        assert [read(n, c) for n in SERVE] == [None] * 4
    bare = serve_ctx()
    bare["events"].ops = [o for o in bare["events"].ops if o[0].startswith("portbench.")]
    assert [read(n, bare) for n in SERVE] == [None] * 4


def train_ctx(waits=((90, 120), (290, 315), (500, 520))):
    c = "cuembed::"
    ops = [("portbench.window", 0, 1000, 1), (c + "collection.adagrad_update", 50, 600, 2)]
    ops += [(c + ("wait.num_unique" if i % 2 else "wait.keep_mask"), s, e, 3 + i)
            for i, (s, e) in enumerate(waits)]
    # idle gaps: 100-150, 300-320, 400-700, 900-1000
    dev = [("k", 0, 100, 0), ("k", 150, 300, 0), ("k", 320, 400, 0), ("k", 700, 900, 0)]
    return {"loop": "train", "events": Events(device=dev, ops=ops, window=(0, 1000)),
            "records": [(0, 0.0, 0.1, 0.2, 0.3)] * 2}


def test_train_readers():
    c = train_ctx()
    assert read("host_waits_per_step.train", c) == pytest.approx(1.5)
    assert read("wait_ms_per_step.train", c) == pytest.approx(75 / 1e3 / 2)
    # the gaps at 100 and 300 begin inside a wait, the one at 400 and the last do not
    assert read("wait_idle_ms_per_step.train", c) == pytest.approx(70 / 1e3 / 2)


def test_train_readers_read_zero_waits_as_zero():
    c = train_ctx(waits=())
    assert [read(n, c) for n in TRAIN] == [0.0, 0.0, 0.0]


def test_train_readers_read_nothing_without_spans_or_a_device():
    no_device = train_ctx()
    no_device["events"].device = []
    bare = train_ctx()
    bare["events"].ops = bare["events"].ops[:1]
    for c in (no_device, bare, dict(train_ctx(), events=None), dict(train_ctx(), loop="serve")):
        assert [read(n, c) for n in TRAIN] == [None] * 3


def _traced_window(root, workload):
    from cuembed_tpu_torch.utils import trace

    cell = harness.resolve(root, workload, 2**40 + 7, "cpu")
    tracer = Tracer(True)
    loop = harness.make_loop(cell, tracer)
    loop.setup()
    before = trace.counters()
    with tracer.window():
        loop.window(0.2)
    after = trace.counters()
    return loop, tracer.events, {k: after[k] - before[k] for k in after}


def test_program_waits_in_a_traced_window_are_its_counts(tiny_root):
    loop, ev, delta = _traced_window(tiny_root, "tiny-train")
    waits = program_spans.spans(ev, "wait.")
    steps, tables = len(loop.records), len(loop.cell.tables)
    assert steps and len(waits) == delta["wait.num_unique"] + delta["wait.keep_mask"]
    assert len(waits) == 2 * tables * steps


def test_program_lookups_in_a_traced_window_nest(tiny_root):
    loop, ev, _ = _traced_window(tiny_root, "tiny-serve")
    coll = program_spans.spans(ev, "collection.apply")
    api = program_spans.spans(ev, "api.lookup")
    disp = program_spans.spans(ev, "dispatch.forward")
    assert len(coll) == len(loop.records) and len(api) == len(disp) == 3 * len(coll)
    assert program_spans.inside(coll, api) == pytest.approx(program_spans.total(api))
    assert program_spans.inside(api, disp) == pytest.approx(program_spans.total(disp))
