"""What the per-layer readers (``portbench/metrics/``) share: which device
operations are which kernel, which host op launched them, and the shares
that more than one reader takes."""

from __future__ import annotations

import bisect

from portbench.tracing import ops_named_within, ops_within, union_s

K1 = ("fixed_forward_kernel",)
K3 = ("coo_backward_kernel", "coo_backward_fixup_kernel", "run_count_kernel", "run_scan_kernel")
SORT_OP = "aten::sort"


def is_kernel(name: str, kernel_names) -> bool:
    return any(k in name for k in kernel_names)


def in_window(events):
    """The device operations inside the measured window."""
    lo, hi = events.window
    return [d for d in events.device if d[1] >= lo and d[2] <= hi]


def device_s(ops) -> float:
    return sum(e - s for _, s, e, _ in ops) / 1e6


def linked(events) -> bool:
    """Whether the trace ties device operations to the host ops that
    launched them."""
    return any(d[3] for d in events.device)


def launched_in_span(events, span: str) -> list:
    """Device operations launched by a host op inside the benchmark span."""
    corr = ops_within(events, events.spans(span))
    return [d for d in in_window(events) if d[3] in corr]


def launched_by_op(events, op: str) -> list:
    """Device operations launched inside the host op ``op`` (or ops it
    called)."""
    corr = ops_named_within(events, op)
    return [d for d in in_window(events) if d[3] in corr]


def idle_share(ctx, loop: str):
    """Percent of the window in which no kernel, copy or memset ran."""
    ev = ctx["events"]
    if ctx["loop"] != loop or ev is None or not ev.device:
        return None
    lo, hi = ev.window
    return 100.0 * (1.0 - union_s([(s, e) for _, s, e, _ in ev.device], lo, hi) / ((hi - lo) / 1e6))


def kernel_share(ctx, span: str, kernel_names, main: str, bound_key: str):
    """A kernel's share of its roofline over the window: over the requests or
    steps (benchmark span ``span``) whose every launch of ``main`` the trace
    holds, the sum of their least times (``ctx[bound_key]``, by pool entry)
    over the device time of ``kernel_names`` inside them. A request or step
    from which the trace lost a launch cannot be matched to its bound and is
    left out; with none left, nothing is read."""
    ev = ctx["events"]
    if ev is None:
        return None
    spans, records = ev.spans(span), ctx["records"]
    if not spans or len(spans) != len(records):
        return None
    starts = [s for s, _ in spans]
    inside = [[] for _ in spans]
    for d in in_window(ev):
        i = bisect.bisect_right(starts, d[1]) - 1
        if i >= 0 and d[1] <= spans[i][1] and is_kernel(d[0], kernel_names):
            inside[i].append(d)
    bound = busy = 0.0
    for r, ops in zip(records, inside):
        if sum(main in d[0] for d in ops) == ctx["launches_per_request"]:
            bound += ctx[bound_key][r[0]]
            busy += device_s(ops)
    return 100.0 * bound / busy if busy else None


def k1_share(ctx):
    """K1's share of its roofline over a serving window: each request's least
    time over K1's device time in it (``bounds.k1_bound_s``)."""
    if ctx["loop"] != "serve":
        return None
    return kernel_share(ctx, "request", K1, K1[0], "k1_bound_s")
