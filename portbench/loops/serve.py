"""Serving: a closed loop of pooled lookups through the program's
``EmbeddingCollection.apply``, one request outstanding.

The traffic file sets the request sizes (``samples``: ``{"fixed": n}`` or
``{"uniform": [lo, hi]}``), the pool of requests made on the device from the
seed at set-up (``pool``), and how many of them the check compares
(``check_requests``, the largest always among them). The window cycles the
pool in its seeded order. A request's latency runs from the call into
``apply`` to the return of the synchronize on its outputs, on the card's
clock (:class:`_Latency`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import bounds, check, gen
from portbench.loops import common


class Loop:
    LEAF_SPANS = ("apply", "sync")
    PARENT_SPANS = ("request",)

    def __init__(self, cell, tracer):
        self.cell, self.tracer = cell, tracer
        self.check_setup_s = 0.0
        self.attempted = self.failed = 0

    def setup(self):
        cell, t = self.cell, self.cell.traffic
        host = torch.Generator().manual_seed(gen.subseed(cell.seed, "sizes"))
        self.sizes = gen.sizes(t["samples"], int(t["pool"]), host)
        self.starts = np.cumsum([0] + self.sizes[:-1]).tolist()
        self.tables = common.make_tables(cell)
        self.ids = common.make_ids(cell, sum(self.sizes), "ids")
        self.requests = [{f"t{i}": ids[s:s + n] for i, ids in enumerate(self.ids)}
                         for s, n in zip(self.starts, self.sizes)]
        largest = max(range(len(self.sizes)), key=lambda q: self.sizes[q])
        order = torch.randperm(len(self.sizes), generator=host).tolist()
        picked = [largest] + [q for q in order if q != largest]
        self.checked = set(picked[:int(t["check_requests"])])
        self.saved = {}
        self.coll = common.collection(cell)
        self.names = [f"t{i}" for i in range(len(self.tables))]
        self.tabledict = dict(zip(self.names, self.tables))
        for _ in range(int(t.get("warm_passes", 1))):
            for req in self.requests:
                self.coll.apply(self.tabledict, req)
        _sync(cell.device)
        end, k = time.perf_counter() + float(t.get("warm_seconds", 0)), 0
        while time.perf_counter() < end:  # the host's pace settles under load
            self.coll.apply(self.tabledict, self.requests[k % len(self.requests)])
            _sync(cell.device)
            k += 1

    def window(self, seconds: float):
        coll, tables, reqs, span = self.coll, self.tabledict, self.requests, self.tracer.span
        device, checked, saved = self.cell.device, self.checked, self.saved
        rec, n = [], len(reqs)
        timer = _Latency(device)
        start = time.perf_counter()
        end = start + seconds
        k = 0
        while True:
            t0 = time.perf_counter()
            if t0 >= end:
                break
            q = k % n
            with span("request"):
                timer.begin()
                with span("apply"):
                    out = coll.apply(tables, reqs[q])
                t1 = time.perf_counter()
                with span("sync"):
                    _sync(device)
            t2 = time.perf_counter()
            timer.end(t0, t2)
            rec.append((q, t0, t1, t2))
            if q in checked:
                saved[q] = out
            k += 1
        self.records, self.latency = rec, timer.close()
        self.window_s = rec[-1][3] - start
        self.attempted += len(rec)

    def end_to_end(self) -> dict:
        lat = np.array(self.latency)
        ids = sum(self.sizes[r[0]] for r in self.records) * sum(h for _, h in self.cell.tables)
        return {"serve_p95_ms": float(np.percentile(lat, 95) * 1e3),
                "serve_ids_per_s": ids / self.window_s}

    def asides(self) -> dict:
        """Readings printed beside the result and judged by nothing: the tail
        on the host's clock, call to the synchronize's return."""
        host = np.array([t2 - t0 for _, t0, _, t2 in self.records])
        return {"serve_p95_host_ms": float(np.percentile(host, 95) * 1e3)}

    def layer_context(self, events) -> dict:
        """What the per-layer readers take: the trace, the window's requests
        with their host times, and each pool entry's least bytes and K1
        bound (one launch a table)."""
        elem = self.tables[0].element_size()
        width = self.cell.width
        least = [0] * len(self.sizes)
        k1 = [0.0] * len(self.sizes)
        for ids, (_, hot) in zip(self.ids, self.cell.tables):
            for q, u in enumerate(common.unique_counts(ids, self.sizes)):
                n = self.sizes[q]
                kw = dict(unique_rows=u, ids=n * hot, out_rows=n, width=width, elem=elem)
                least[q] += bounds.lookup_bytes(**kw)
                k1[q] += bounds.k1_bound_s(**kw)
        return {"loop": "serve", "events": events, "window_s": self.window_s,
                "records": self.records, "least_bytes": least, "k1_bound_s": k1,
                "launches_per_request": len(self.tables)}

    def close(self):
        """After the window: nothing to add, the check reads the window's
        own outputs."""

    def free_program(self):
        self.coll = None

    def numbers(self) -> dict:
        """Every checked request's pooled rows against the reference's."""
        worst = 0.0
        for q, out in self.saved.items():
            for name, table, ids in zip(self.names, self.tables, self.ids):
                s, n = self.starts[q], self.sizes[q]
                worst = max(worst, check.pooled_err_bounds(out[name], table, ids[s:s + n]))
        return {"pooled_err_bounds": worst if self.saved else None}


class _Latency:
    """Each request's latency on the card's clock, from the call into
    ``apply`` to the return of the synchronize on its outputs: an event
    recorded on the idle stream at the call, and one recorded once the
    synchronize has returned, which the idle card stamps as it arrives. A
    pair is read once the next request's synchronize has passed both, so
    reading adds no wait. A single reading of the host's clock is off by up
    to half a millisecond, more than a flagship request takes; on the CPU
    (tests) it stands in."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.seconds, self.k, self.pending = [], 0, None
        if self.cuda:
            self.pairs = [(torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)) for _ in range(2)]

    def begin(self):
        if self.cuda:
            self.pairs[self.k % 2][0].record()

    def end(self, t0: float, t2: float):
        """After the request's synchronize has returned."""
        if not self.cuda:
            self.seconds.append(t2 - t0)
            return
        pair = self.pairs[self.k % 2]
        pair[1].record()
        self._read()
        self.pending, self.k = pair, self.k + 1

    def _read(self):
        if self.pending is not None:
            self.seconds.append(self.pending[0].elapsed_time(self.pending[1]) / 1e3)
            self.pending = None

    def close(self) -> list:
        """Every request's latency in seconds, the last one read too."""
        if self.pending is not None:
            self.pending[1].synchronize()
            self._read()
        return self.seconds


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
