"""The traced run: ``torch.profiler`` over the measured window, its events kept
in memory and reduced to plain tuples that the metric readers take.

Spans are the benchmark's own: ``record_function`` around its calls into the
program (``portbench.<name>``), so they share the profiler's clock with the
device's activities. Untraced runs get a span that does nothing.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch

SPAN_PREFIX = "portbench."
WINDOW = SPAN_PREFIX + "window"


@dataclass
class Events:
    """A trace reduced to what the readers need, times in microseconds on the
    profiler's clock.

    ``device``: ``(name, start, end, linked)`` for every kernel, copy and
    memset, ``linked`` the correlation id of the host op that launched it
    (0 where unknown). ``ops``: ``(name, start, end, corr)`` for every host
    op and every benchmark span. ``window``: the measured window's
    ``(start, end)``.
    """

    device: list = field(default_factory=list)
    ops: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)

    def spans(self, name: str) -> list:
        """The ``(start, end)`` of every benchmark span called ``name``."""
        full = SPAN_PREFIX + name
        return sorted((s, e) for n, s, e, _ in self.ops if n == full)


def _us(ev, what):
    ns = getattr(ev, f"{what}_ns", None)
    return ns() / 1e3 if ns is not None else getattr(ev, f"{what}_us")()


def reduce(kineto_events) -> Events:
    """Plain tuples from the profiler's raw events
    (``prof.profiler.kineto_results.events()``)."""
    from torch.autograd import DeviceType

    out = Events()
    for ev in kineto_events:
        name = ev.name()
        start = _us(ev, "start")
        end = start + _us(ev, "duration")
        if ev.device_type() == DeviceType.CUDA:
            if name.startswith(SPAN_PREFIX):
                continue  # a span's mirror on the device timeline, not work
            out.device.append((name, start, end, ev.linked_correlation_id()))
        elif ev.device_type() == DeviceType.CPU and (
                "::" in name or name.startswith(SPAN_PREFIX)) and not ev.linked_correlation_id():
            # torch's ops and the spans; the runtime's calls (linked to the op
            # that made them) and the profiler's own events number their
            # correlation ids apart
            out.ops.append((name, start, end, ev.correlation_id()))
    windows = out.spans(WINDOW[len(SPAN_PREFIX):])
    if windows:
        out.window = windows[0]
    out.device.sort(key=lambda d: d[1])
    return out


class Tracer:
    """Spans and, when enabled, the profiler over the window."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN_PREFIX + name)

    @contextlib.contextmanager
    def window(self):
        """Profile the block (when enabled) under the window's span."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with self.span(WINDOW[len(SPAN_PREFIX):]):
                yield
        self.events = reduce(prof.profiler.kineto_results.events())


def union_s(intervals, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` (microseconds) covered by the intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def idle_gaps(events: Events) -> list:
    """The window's idle gaps ``(start, end)``: no device activity."""
    lo, hi = events.window
    gaps, t = [], lo
    for _, s, e, _ in events.device:
        if e <= lo or s >= hi:
            continue
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def _cover(gaps, spans):
    """Per gap, the parts covered by the (non-overlapping, sorted) spans,
    and the parts left."""
    covered, left, j = 0.0, [], 0
    for g0, g1 in gaps:
        t = g0
        while j < len(spans) and spans[j][1] <= g0:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < g1:
            s0, s1 = max(spans[k][0], g0), min(spans[k][1], g1)
            if s0 > t:
                left.append((t, s0))
            covered += max(0.0, s1 - max(s0, t))
            t = max(t, s1)
            k += 1
        if t < g1:
            left.append((t, g1))
    return covered, left


def idle_by_span(events: Events, leaves: list, parents: list) -> list:
    """Idle seconds of the window by what the host was in: each leaf span
    (innermost first), then each parent span, then ``outside``; largest
    first, as ``[name, seconds]``."""
    left = idle_gaps(events)
    out = []
    for name in list(leaves) + list(parents):
        covered, left = _cover(left, events.spans(name))
        out.append([SPAN_PREFIX + name, covered / 1e6])
    out.append(["outside spans", sum(e - s for s, e in left) / 1e6])
    return sorted((x for x in out if x[1] > 0), key=lambda x: -x[1])


def top_device_ops(events: Events, n: int = 10) -> list:
    """Device seconds by operation name in the window, largest first."""
    lo, hi = events.window
    by = {}
    for name, s, e, _ in events.device:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            by[name] = by.get(name, 0.0) + d / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def ops_within(events: Events, spans: list) -> set:
    """Correlation ids of host ops that start inside one of the spans."""
    spans = sorted(spans)
    starts = [s for s, _ in spans]
    out = set()
    for _, s, _, corr in events.ops:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= spans[i][1]:
            out.add(corr)
    return out


def ops_named_within(events: Events, name: str) -> set:
    """Correlation ids of host ops that start inside an op called ``name``
    (that op included): the ops it called."""
    return ops_within(events, [(s, e) for n, s, e, _ in events.ops if n == name])
