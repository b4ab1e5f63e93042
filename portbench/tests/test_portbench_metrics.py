"""Each per-layer reader on a synthetic trace."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.tracing import Events, idle_by_span, top_device_ops, union_s

K1 = "void (anonymous namespace)::fixed_forward_kernel<__half, long, false, false, 16>(FwdArgs)"
K3 = "void coo_backward_kernel<float, long, 16>(BwdArgs)"


def serve_ctx():
    # window 0-1000 us; two requests, one K1 each: 100 us and 200 us of device time
    ops = [("portbench.window", 0, 1000, 1), ("portbench.request", 0, 400, 6),
           ("portbench.apply", 10, 60, 2), ("portbench.sync", 60, 400, 3),
           ("portbench.request", 500, 900, 7), ("portbench.apply", 500, 540, 4),
           ("portbench.sync", 540, 900, 5)]
    dev = [(K1, 50, 150, 2), (K1, 530, 730, 4)]
    ev = Events(device=dev, ops=ops, window=(0, 1000))
    rec = [(0, 0.0, 0.00005, 0.0004), (1, 0.0005, 0.00054, 0.0009)]
    return {"loop": "serve", "events": ev, "window_s": 1e-3, "records": rec, "host_records": rec,
            "least_bytes": [3.35e6, 6.7e6], "k1_bound_s": [50e-6, 150e-6],
            "launches_per_request": 1}


def train_ctx():
    ops = [("portbench.window", 0, 1000, 1), ("portbench.step", 0, 600, 14),
           ("portbench.adagrad_update", 100, 500, 10),
           ("aten::sort", 120, 200, 11), ("aten::copy_", 130, 140, 12),
           ("aten::index_add_", 300, 310, 13)]
    dev = [("fixed_forward_kernel", 10, 60, 9), ("radix_sort_k", 150, 250, 11),
           ("copy_k", 250, 260, 12), ("index_add_k", 320, 420, 13), (K3, 420, 520, 10),
           ("run_scan_kernel", 520, 530, 10)]
    ev = Events(device=dev, ops=ops, window=(0, 1000))
    rec = [(0, 0.0, 0.0001, 0.0005, 0.0006)]
    return {"loop": "train", "events": ev, "window_s": 1e-3, "records": rec, "host_records": rec,
            "least_bytes": [3.35e6], "k1_bound_s": [1e-5], "k3_bound_s": [55e-6],
            "launches_per_request": 1}


def read(name, ctx):
    return harness.reader(name)(ctx)


def test_serve_readers():
    c = serve_ctx()
    assert read("host_ms_per_request.serve", c) == pytest.approx((0.05 + 0.04) / 2)
    assert read("k1_roofline.serve", c) == pytest.approx(100 * 200e-6 / 300e-6)
    assert read("device_idle_share.serve", c) == pytest.approx(70.0)
    # 10.05e6 bytes at 3.35e12 = 3 us over 0.8 ms of wall time
    assert read("request_roofline.serve", c) == pytest.approx(100 * 3e-6 / 0.0008)
    assert read("k3_roofline.train", c) is None


def test_train_readers():
    c = train_ctx()
    assert read("host_ms_per_step.train", c) == pytest.approx(0.5)
    assert read("sort_device_ms.train", c) == pytest.approx(0.11)  # sort and the copy it called
    assert read("update_device_ms.train", c) == pytest.approx(0.1)  # index_add_ only
    assert read("k3_roofline.train", c) == pytest.approx(100 * 55e-6 / 110e-6)
    assert read("device_idle_share.train", c) == pytest.approx(100 * (1 - 0.37))
    assert read("step_roofline.train", c) == pytest.approx(100 * 1e-6 / 0.0006)
    assert read("host_ms_per_request.serve", c) is None


def test_host_clock_readers_take_the_untraced_window():
    c = dict(serve_ctx(), host_records=[(0, 0.0, 0.00002, 0.0002)])
    assert read("host_ms_per_request.serve", c) == pytest.approx(0.02)
    assert read("request_roofline.serve", c) == pytest.approx(100 * 1e-6 / 0.0002)
    t = dict(train_ctx(), host_records=[(0, 0.0, 0.0001, 0.0002, 0.0003)] * 2)
    assert read("host_ms_per_step.train", t) == pytest.approx(0.2)
    assert read("step_roofline.train", t) == pytest.approx(100 * 1e-6 / 0.0003)


def test_readers_find_nothing_without_a_trace():
    c = dict(serve_ctx(), events=None)
    assert read("k1_roofline.serve", c) is None
    assert read("device_idle_share.serve", c) is None
    t = dict(train_ctx(), events=None)
    assert read("update_device_ms.train", t) is None
    unlinked = train_ctx()
    unlinked["events"].device = [(n, s, e, 0) for n, s, e, _ in unlinked["events"].device]
    assert read("sort_device_ms.train", unlinked) is None


def test_kernel_readers_leave_out_what_lost_a_launch():
    c = serve_ctx()
    c["events"].device = c["events"].device[1:]  # the first request's K1 lost
    assert read("k1_roofline.serve", c) == pytest.approx(100 * 150e-6 / 200e-6)
    c["events"].device = []
    assert read("k1_roofline.serve", c) is None
    t = train_ctx()
    t["events"].device = [d for d in t["events"].device if d[0] != K3]
    assert read("k3_roofline.train", t) is None


def test_union_gaps_and_breakdown():
    assert union_s([(0, 10), (5, 20), (30, 40)], 0, 100) == pytest.approx(30e-6)
    assert union_s([(0, 10)], 5, 100) == pytest.approx(5e-6)
    ev = serve_ctx()["events"]
    gaps = dict(idle_by_span(ev, ["apply", "sync"], ["request"]))
    assert gaps["portbench.sync"] == pytest.approx((250 + 170) / 1e6)
    assert gaps["portbench.apply"] == pytest.approx((40 + 30) / 1e6)
    assert sum(gaps.values()) == pytest.approx(0.7e-3)
    assert top_device_ops(ev) == [[K1, pytest.approx(300e-6)]]
