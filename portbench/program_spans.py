"""What the readers of the program's own spans share.

The program records spans named ``cuembed::<layer>.<what>`` while a profiler
records (``cuembed_tpu_torch/utils/trace.py``); ``tracing.reduce`` keeps them
in ``Events.ops`` beside torch's ops, on the window's clock. The serving
split is each host layer's self time a lookup, nested as ``collection.apply``
contains ``api.lookup`` contains ``dispatch.forward`` contains
``launch.k1`` / ``launch.k2``, so the four add up to ``collection.apply``.
The training readers count the ``wait.*`` spans, the program's host reads of
sizes and masks the device computes.

A reader returns None where the trace holds none of the spans it reads: a
program without them, a serving run whose lookups launched no kernel, or a
run with no device activity (the CPU), where a read of the host waits on no
device.
"""

from __future__ import annotations

import bisect

from portbench.tracing import idle_gaps

PREFIX = "cuembed::"
LAUNCHES = ("launch.k1", "launch.k2")
WAITS = "wait."


def spans(events, *names) -> list:
    """``(start, end)`` of every program span called one of ``names`` (a
    name ending in ``.`` takes every span under it) that starts inside the
    window, in order."""
    lo, hi = events.window
    exact = {PREFIX + n for n in names if not n.endswith(".")}
    under = tuple(PREFIX + n for n in names if n.endswith("."))
    return sorted((s, e) for n, s, e, _ in events.ops
                  if lo <= s <= hi and (n in exact or (under and n.startswith(under))))


def total(intervals) -> float:
    return sum(e - s for s, e in intervals)


def inside(outer, inner) -> float:
    """Time of the ``inner`` spans that lie within one of the ``outer``
    spans (each list in order, neither overlapping itself)."""
    starts = [s for s, _ in outer]
    t = 0.0
    for s, e in inner:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= outer[i][1]:
            t += e - s
    return t


def serve_split(ctx):
    """Each layer's self time a lookup in microseconds, by layer
    (``collection``, ``api``, ``dispatch``, ``launch``), over the serving
    window's ``api.lookup`` spans; None without all four layers' spans."""
    ev = ctx["events"]
    if ctx["loop"] != "serve" or ev is None:
        return None
    coll, api = spans(ev, "collection.apply"), spans(ev, "api.lookup")
    disp, launch = spans(ev, "dispatch.forward"), spans(ev, *LAUNCHES)
    if not (coll and api and disp and launch):
        return None
    n = len(api)
    return {"collection": (total(coll) - inside(coll, api)) / n,
            "api": (total(api) - inside(api, disp)) / n,
            "dispatch": (total(disp) - inside(disp, launch)) / n,
            "launch": total(launch) / n}


def waits(ctx):
    """The training window's ``wait.*`` spans, or None: not a training
    run, no device activity, or a program without spans (none of its
    ``collection.adagrad_update``)."""
    ev = ctx["events"]
    if ctx["loop"] != "train" or ev is None or not ev.device or not ctx["records"]:
        return None
    if not spans(ev, "collection.adagrad_update"):
        return None
    return spans(ev, WAITS)


def wait_idle_us(events, wait_spans) -> float:
    """Device-idle time in the window's gaps that begin while the host is
    inside a wait span: the queue a wait drained, idle until the host
    refills it. Each such gap counts whole."""
    starts = [s for s, _ in wait_spans]
    t = 0.0
    for g0, g1 in idle_gaps(events):
        i = bisect.bisect_right(starts, g0) - 1
        if i >= 0 and g0 < wait_spans[i][1]:
            t += g1 - g0
    return t
