"""The numbers that decide ``correct``, each held to its limit.

Every number is a largest gap between what the program produced and what the
plain reference (``portbench/reference/``) works out from the same inputs, in
a unit that the program's stated precision fixes; ``correct`` holds when
every number is at or under its limit. The limits of a cell are data
(``portbench/limits/<workload>.json``); ``PERF.md`` gives the readings each
was set from.
"""

from __future__ import annotations

import math
import sys

import torch

from portbench.reference import pooled, rowwise_adagrad

U32 = 2.0**-24  # unit roundoff of fp32


def ulp16(x: torch.Tensor) -> torch.Tensor:
    """The fp16 spacing at each ``|x|`` (subnormal spacing below 2**-14)."""
    _, e = torch.frexp(x.abs())
    ulp = torch.ldexp(torch.ones_like(x), (e - 11).to(x.dtype))
    return torch.where(x.abs() < 2.0**-14, torch.full_like(x, 2.0**-24), ulp)


def gamma(n: int, u: float = U32) -> float:
    """The recursive-sum factor: ``|fl(sum) - sum| <= gamma * sum |x_i|``."""
    return n * u / (1.0 - n * u)


def pooled_err_bounds(out: torch.Tensor, table: torch.Tensor, ids: torch.Tensor) -> float:
    """Largest ``|out - ref|`` in units of the program's own error bound: an
    fp32 recursive sum of the ``hotness`` rows, ``gamma(hotness - 1)`` times
    the terms' magnitudes, plus half an fp16 spacing of the result for its
    rounding to the table's dtype. A sound lookup reads at most about 1;
    sums in fp16 or bf16 read far more."""
    ref, mag = pooled.pooled_sum(table, ids)
    bound = 0.5 * ulp16(ref) + gamma(ids.shape[1] - 1) * mag
    return float(((out.to(torch.float64) - ref).abs() / bound).max())


def _leaf_gap(prog: list, ref: list, keep: list) -> float:
    """Worst leaf's ``|prog - ref|`` over the larger of that leaf's reference
    norm and the median leaf's."""
    med = sorted(ref)[len(ref) // 2]
    return max((abs(p - r) / max(r, med) for p, r, k in zip(prog, ref, keep) if k), default=0.0)


def train_numbers(prog: dict, ref: dict) -> dict:
    """The training cell's numbers from the program's (or the control's)
    state and the reference's, each a dict of ``first``, ``run`` and
    ``last`` (see ``loops/train.py``), one entry a table in each.

    Over the checked steps at the start:

    * ``accum_rel_err``: largest relative gap of a touched row's accumulator,
      after step 1 and after step 3;
    * ``grad_norm_gap``: the first step's gradient norm of each table, from
      its accumulators after step 1 (``sqrt(W sum acc)``), worst leaf;
    * ``change_norm_gap``: each table's change over the three steps on the
      sampled rows, worst leaf; leaves whose reference gradient is under a
      thousandth of the median leaf's are left out;
    * ``row_err_ulps``: largest gap of a sampled row after step 3, in fp16
      spacings of the largest value the row can pass through (its start
      plus the reference's steps' magnitudes): each step rounds its update
      and its result to fp16 once.

    Over the whole run, window included:

    * ``run_accum_rel_err``: largest relative gap of the accumulator of a row
      of the id pool after every step of the run, each added once.

    Over the step replayed after the window, from the state it left:

    * ``last_accum_rel_err``: largest relative gap of a touched row's
      accumulator after the step;
    * ``last_row_err_ulps``: largest gap of a sampled row after the step, in
      fp16 spacings of its value before plus the reference's step.
    """
    acc_err, row_err = 0.0, 0.0
    g_p, g_r, c_p, c_r = [], [], [], []
    for s, r in zip(prog["first"], ref["first"]):
        for k in ("acc1", "acc3"):
            acc_err = max(acc_err, _rel_err(s[k], r[k]))
        width = s["t3"].shape[1]
        g_p.append(math.sqrt(width * float(s["acc1"].to(torch.float64).sum())))
        g_r.append(math.sqrt(width * float(r["acc1"].to(torch.float64).sum())))
        t0 = r["t0"].to(torch.float64)
        c_p.append(float((s["t3"].to(torch.float64) - t0).norm()))
        c_r.append(float((r["t3"].to(torch.float64) - t0).norm()))
        row_err = max(row_err, _ulps_err(s["t3"], r["t3"], r["mag"]))
    med = sorted(g_r)[len(g_r) // 2]
    keep = [g >= 1e-3 * med for g in g_r]
    return {"accum_rel_err": acc_err, "grad_norm_gap": _leaf_gap(g_p, g_r, [True] * len(g_r)),
            "change_norm_gap": _leaf_gap(c_p, c_r, keep), "row_err_ulps": row_err,
            "run_accum_rel_err": max(_rel_err(p, r) for p, r in zip(prog["run"], ref["run"])),
            "last_accum_rel_err": max(_rel_err(p["acc1"], r["acc1"])
                                      for p, r in zip(prog["last"], ref["last"])),
            "last_row_err_ulps": max(_ulps_err(p["t1"], r["t1"], r["mag"])
                                     for p, r in zip(prog["last"], ref["last"]))}


def _rel_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    p64, r64 = prog.to(torch.float64), ref.to(torch.float64)
    return float(((p64 - r64).abs() / r64).max())


def _ulps_err(prog: torch.Tensor, ref: torch.Tensor, mag: torch.Tensor) -> float:
    return float(((prog.to(torch.float64) - ref.to(torch.float64)).abs() / ulp16(mag)).max())


def reference_train(tables: list, steps: list, samples: list, t0_rows, *, lr: float, eps: float,
                    dtype=torch.float64) -> list:
    """The reference's state after the checked steps, one dict a table:
    ``acc1`` at the rows step 1 touched, ``acc3`` at the rows any step
    touched, ``t0`` and ``t3`` at the sampled rows.

    ``tables``: each table's ``(touched1, touched)``, sorted row ids.
    ``steps``: per step, per table, ``(ids, grad_y)``. ``samples``: each
    table's sampled rows (a subset of ``touched``). ``t0_rows(t, rows)``: the
    table's rows as the benchmark made them. ``dtype``: the precision the
    reference computes in (float64; bfloat16 for the control).
    """
    out = []
    for t, (touched1, touched) in enumerate(tables):
        sample = samples[t]
        t0 = t0_rows(t, sample)
        acc = torch.zeros(touched.numel(), dtype=dtype, device=touched.device)
        rows_now = t0.clone()
        mag = t0.abs().to(torch.float64)  # |t0| + sum of |step|: bounds every value on the way
        pos_sample = torch.searchsorted(touched, sample)
        acc1 = None
        for s, batch in enumerate(steps):
            ids, gy = batch[t]
            rows, g = rowwise_adagrad.row_grads(ids, gy, dtype)
            pos = torch.searchsorted(touched, rows)
            acc[pos] = rowwise_adagrad.accumulate(acc[pos], g)
            if s == 0:
                acc1 = acc[torch.searchsorted(touched, touched1)].clone()
            hit = torch.isin(sample, rows)
            at = torch.searchsorted(rows, sample[hit])
            rows_now[hit], delta = rowwise_adagrad.update(rows_now[hit], acc[pos_sample[hit]],
                                                          g[at], lr=lr, eps=eps)
            mag[hit] += delta.abs().to(torch.float64)
            del rows, g, pos
        out.append({"acc1": acc1, "acc3": acc, "t0": t0, "t3": rows_now, "mag": mag})
    return out


def reference_run_accums(rows: list, period: list, total: int, dtype=torch.float64) -> list:
    """Each table's accumulators at ``rows`` (its id pool's rows, sorted)
    after the run's ``total`` steps, step ``k`` being
    ``period[k % len(period)]`` (per table, ``(ids, grad_y)``), added one
    step at a time in ``dtype``. Row-wise AdaGrad's accumulators do not
    depend on the tables, so the whole run follows from the seed."""
    out = []
    for t, r in enumerate(rows):
        incs = []
        for batch in period:
            hit, g = rowwise_adagrad.row_grads(*batch[t], dtype)
            incs.append((torch.searchsorted(r, hit), rowwise_adagrad.increment(g)))
            del g
        acc = torch.zeros(r.numel(), dtype=dtype, device=r.device)
        for k in range(total):
            pos, inc = incs[k % len(incs)]
            acc[pos] += inc
        out.append(acc)
    return out


def reference_replay(last: list, batch: list, *, lr: float, eps: float,
                     dtype=torch.float64) -> list:
    """One step replayed from the program's state before it. ``last``: each
    table's ``rows`` (the step's distinct ids, sorted), ``sample`` (some of
    them), ``acc0`` at ``rows`` and ``t0`` at ``sample``, as the program left
    them; ``batch``: per table, the step's ``(ids, grad_y)``. Returns each
    table's ``acc1`` at ``rows``, ``t1`` at ``sample`` and ``mag``, the
    sample's ``|t0|`` plus the step's magnitude."""
    out = []
    for s, (ids, gy) in zip(last, batch):
        rows, g = rowwise_adagrad.row_grads(ids, gy, dtype)
        acc = rowwise_adagrad.accumulate(s["acc0"].to(dtype), g)
        at = torch.searchsorted(rows, s["sample"])
        t1, step = rowwise_adagrad.update(s["t0"], acc[at], g[at], lr=lr, eps=eps)
        mag = s["t0"].abs().to(torch.float64) + step.abs().to(torch.float64)
        out.append({"acc1": acc, "t1": t1, "mag": mag})
        del g
    return out


def verdict(numbers: dict, limits: dict):
    """``(correct, checks)``: each number beside its limit; a number that is
    missing or not finite fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct &= ok
        checks[name] = {"value": value, "limit": limit}
    return correct, checks


def print_checks(checks: dict, correct: bool) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct = {correct}", file=sys.stderr)
