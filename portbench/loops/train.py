"""Training: a closed loop of steps through the program's collection. A step
is ``EmbeddingCollection.apply``, then ``adagrad_update`` (row-wise AdaGrad,
in place) with each table's pooled-output gradient, then a synchronize.

The traffic file sets the batch, the pools made on the device from the seed
(``id_pool`` batches of ids, ``grad_pool`` of gradients, ``grad_scale`` their
spread), the optimizer's ``lr`` and ``eps``, the steps the check follows
(``checked_steps``), further warm-up steps and the rows a table it samples.

Set-up builds the tables and the program's accumulators once, drives them
through the checked steps by the window's own call (each on its own batch),
saves what the check compares, warms up, and hands the same state to the
window. The reference follows the checked steps after the window, from the
tables drawn again from the seed. Once the window has closed, one more step
runs by the same call from the state the window left, with what it touches
saved before and after (:meth:`Loop.close`): the reference replays it, and
adds up every step of the run into each row's accumulator from the seed.
"""

from __future__ import annotations

import math
import time

import torch

from portbench import bounds, check, gen
from portbench.loops import common
from portbench.loops.serve import _sync

HOT_ROWS = 64  # the rows with the longest runs of step 1, always sampled


class Loop:
    LEAF_SPANS = ("apply", "adagrad_update", "sync")
    PARENT_SPANS = ("step",)

    def __init__(self, cell, tracer):
        self.cell, self.tracer = cell, tracer
        self.check_setup_s = 0.0
        self.attempted = self.failed = 0
        t = cell.traffic
        self.batch, self.lr, self.eps = int(t["batch"]), float(t["lr"]), float(t["eps"])

    def feed(self, k: int):
        """Step ``k``'s ids and gradients, by table name."""
        b0 = (k % self.id_pool) * self.batch
        g0 = (k % self.grad_pool) * self.batch
        ids = {n: x[b0:b0 + self.batch] for n, x in zip(self.names, self.ids)}
        gy = {n: g[g0:g0 + self.batch] for n, g in zip(self.names, self.grads)}
        return ids, gy

    def step(self, k: int):
        ids, gy = self.feed(k)
        self.coll.apply(self.tabledict, ids)
        self.coll.adagrad_update(self.tabledict, self.accums, ids, gy, lr=self.lr, eps=self.eps)

    def setup(self):
        cell, t = self.cell, self.cell.traffic
        self.id_pool, self.grad_pool = int(t["id_pool"]), int(t["grad_pool"])
        self.tables = common.make_tables(cell)
        self.names = [f"t{i}" for i in range(len(self.tables))]
        self.ids = common.make_ids(cell, self.id_pool * self.batch, "ids")
        self.grads = [gen.grads(gen.generator(cell.device, cell.seed, "grads", i),
                                self.grad_pool * self.batch, cell.width, float(t["grad_scale"]))
                      for i in range(len(self.tables))]
        self.coll = common.collection(cell)
        self.tabledict = dict(zip(self.names, self.tables))
        self.accums = self.coll.adagrad_init(device=cell.device)
        timer = common.Timer()
        nsteps = int(t["checked_steps"])
        self.saved = []
        for k in range(nsteps):
            self.step(k)
            with timer:
                if k == 0:
                    self._touched(nsteps)
                    self.saved = [{"acc1": self.accums[n][t1].clone()}
                                  for n, (t1, _) in zip(self.names, self.touched)]
        with timer:
            for n, s, (_, tt), rows in zip(self.names, self.saved, self.touched, self.samples):
                s["acc3"] = self.accums[n][tt].clone()
                s["t3"] = self.tabledict[n][rows].clone()
        self.check_setup_s = timer.seconds
        k, end = nsteps, None
        while end is None or k < nsteps + int(t["warm_steps"]) or time.perf_counter() < end:
            self.step(k)
            _sync(cell.device)
            k += 1
            if end is None:  # then the host's pace settles under load
                end = time.perf_counter() + float(t.get("warm_seconds", 0))
        self.next_step = k

    def _touched(self, nsteps: int):
        """Each table's rows touched by step 1 and by any checked step, and
        the rows the check samples: the hottest of step 1 and a seeded draw."""
        self.touched, self.samples = [], []
        for i, name in enumerate(self.names):
            steps = [self.feed(k)[0][name] for k in range(nsteps)]
            t1, counts = torch.unique(steps[0], return_counts=True)
            tt = torch.unique(torch.cat([s.reshape(-1) for s in steps]))
            self.touched.append((t1, tt))
            self.samples.append(self._sample(i, "sample", tt, counts, hot_of=t1))

    def _sample(self, i: int, purpose: str, rows, counts, hot_of=None):
        """A seeded draw of ``sample_rows`` of ``rows`` and the ``HOT_ROWS``
        of ``hot_of`` (default ``rows``) with the most ``counts``."""
        cap = int(self.cell.traffic["sample_rows"])
        g = gen.generator(self.cell.device, self.cell.seed, purpose, i)
        drawn = rows[torch.randperm(rows.numel(), generator=g, device=rows.device)[:cap]]
        hot_of = rows if hot_of is None else hot_of
        hot = hot_of[torch.argsort(counts, descending=True, stable=True)[:HOT_ROWS]]
        return torch.unique(torch.cat([drawn, hot]))

    def window(self, seconds: float):
        span, device = self.tracer.span, self.cell.device
        coll, tables, accums = self.coll, self.tabledict, self.accums
        lr, eps = self.lr, self.eps
        rec = []
        k = self.next_step
        start = time.perf_counter()
        end = start + seconds
        while True:
            if time.perf_counter() >= end:
                break
            ids, gy = self.feed(k)
            t0 = time.perf_counter()
            with span("step"):
                with span("apply"):
                    coll.apply(tables, ids)
                t1 = time.perf_counter()
                with span("adagrad_update"):
                    coll.adagrad_update(tables, accums, ids, gy, lr=lr, eps=eps)
                t2 = time.perf_counter()
                with span("sync"):
                    _sync(device)
            t3 = time.perf_counter()
            rec.append((k % self.id_pool, t0, t1, t2, t3))
            k += 1
        self.records, self.next_step = rec, k
        self.window_s = rec[-1][4] - start
        self.attempted += len(rec)

    def close(self):
        """After the window: one more step by the window's own call, from the
        state the window left. Saved for the check: each table's accumulators
        at the rows the step touches and its sampled rows (a seeded draw and
        the hottest), before and after; then every row of the id pool's
        accumulator, as the whole run left it."""
        k = self.next_step
        ids, _ = self.feed(k)
        last = []
        for i, name in enumerate(self.names):
            rows, counts = torch.unique(ids[name], return_counts=True)
            sample = self._sample(i, "sample-last", rows, counts)
            last.append({"rows": rows, "sample": sample,
                         "acc0": self.accums[name][rows].clone(),
                         "t0": self.tabledict[name][sample].clone()})
        self.step(k)
        for s, name in zip(last, self.names):
            s["acc1"] = self.accums[name][s["rows"]].clone()
            s["t1"] = self.tabledict[name][s["sample"]].clone()
        self.last, self.last_step, self.total_steps = last, k, k + 1
        self.pool_rows = [torch.unique(x) for x in self.ids]
        self.run_accums = [self.accums[n][r].clone() for n, r in zip(self.names, self.pool_rows)]

    def end_to_end(self) -> dict:
        return {"train_examples_per_s": len(self.records) * self.batch / self.window_s}

    def asides(self) -> dict:
        return {}

    def layer_context(self, events) -> dict:
        """The trace, the window's steps with their host times, and each id
        batch's least bytes, K1 and K3 bounds (one launch each a table)."""
        elem = self.tables[0].element_size()
        width, b = self.cell.width, self.batch
        least = [0] * self.id_pool
        k1 = [0.0] * self.id_pool
        k3 = [0.0] * self.id_pool
        for ids, (_, hot) in zip(self.ids, self.cell.tables):
            for q, u in enumerate(common.unique_counts(ids, [b] * self.id_pool)):
                kw = dict(unique_rows=u, ids=b * hot, width=width, elem=elem)
                least[q] += bounds.step_bytes(batch=b, **kw)
                k1[q] += bounds.k1_bound_s(out_rows=b, **kw)
                k3[q] += bounds.k3_bound_s(gy_rows=b, width=width, live=b * hot, unique_rows=u)
        return {"loop": "train", "events": events, "window_s": self.window_s,
                "records": self.records, "least_bytes": least, "k1_bound_s": k1,
                "k3_bound_s": k3, "launches_per_request": len(self.tables)}

    def free_program(self):
        self.coll = self.tabledict = self.accums = None
        self.tables = None
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64) -> dict:
        """The reference's states (``dtype``: the precision it computes in):
        ``first``, after the checked steps, from the tables drawn again from
        the seed; ``run``, every pool row's accumulator after all the run's
        steps, from the seed; ``last``, the step after the window, replayed
        from the program's state before it."""
        cell = self.cell
        nsteps = int(cell.traffic["checked_steps"])

        def batches(ks):
            return [[(ids[n], gy[n]) for n in self.names]
                    for ids, gy in (self.feed(k) for k in ks)]

        def t0_rows(t, rows):
            return gen.table_rows(cell.seed, t, cell.tables[t][0], cell.width, cell.dtype,
                                  cell.device, rows)

        period = math.lcm(self.id_pool, self.grad_pool)
        return {
            "first": check.reference_train(self.touched, batches(range(nsteps)), self.samples,
                                           t0_rows, lr=self.lr, eps=self.eps, dtype=dtype),
            "run": check.reference_run_accums(self.pool_rows, batches(range(period)),
                                              self.total_steps, dtype=dtype),
            "last": check.reference_replay(self.last, batches([self.last_step])[0], lr=self.lr,
                                           eps=self.eps, dtype=dtype)}

    def program_state(self) -> dict:
        return {"first": self.saved, "run": self.run_accums, "last": self.last}

    def numbers(self) -> dict:
        return check.train_numbers(self.program_state(), self.reference())
