"""The plain references against naive loops, and the check's units."""

from __future__ import annotations

import torch

from portbench import check
from portbench.reference import pooled, rowwise_adagrad


def _case(seed=0, rows=50, batch=7, hot=5, width=6):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(rows, width, generator=g).half()
    ids = torch.randint(0, rows, (batch, hot), generator=g)
    gy = torch.randn(batch, width, generator=g)
    return table, ids, gy


def test_pooled_sum_is_the_loop():
    table, ids, _ = _case()
    out, mag = pooled.pooled_sum(table, ids)
    for b in range(ids.shape[0]):
        want = sum(table[int(i)].double() for i in ids[b])
        torch.testing.assert_close(out[b], want, rtol=0, atol=1e-12)
        torch.testing.assert_close(mag[b], sum(table[int(i)].double().abs() for i in ids[b]))


def test_row_grads_are_the_loop():
    _, ids, gy = _case(1)
    rows, g = rowwise_adagrad.row_grads(ids, gy)
    want = {}
    for b in range(ids.shape[0]):
        for i in ids[b].tolist():
            want[i] = want.get(i, 0) + gy[b].double()
    assert rows.tolist() == sorted(want)
    for r, gr in zip(rows.tolist(), g):
        torch.testing.assert_close(gr, want[r], rtol=0, atol=1e-12)


def test_update_is_rowwise_adagrad():
    t = torch.tensor([[0.5, -0.25]], dtype=torch.float16)
    g = torch.tensor([[3.0, 4.0]], dtype=torch.float64)
    acc = rowwise_adagrad.accumulate(torch.tensor([1.0], dtype=torch.float64), g)
    assert float(acc) == 1.0 + 12.5
    new, step = rowwise_adagrad.update(t, acc, g, lr=0.1, eps=0.0)
    want = torch.tensor([[0.5 - 0.3 / 13.5**0.5, -0.25 - 0.4 / 13.5**0.5]])
    torch.testing.assert_close(new, want.half(), rtol=0, atol=0)
    torch.testing.assert_close(step, torch.tensor([[0.3, 0.4]], dtype=torch.float64) / 13.5**0.5)


def test_ulp16():
    x = torch.tensor([1.0, 1.5, 2.0, 0.0, 2.0**-20, 65504.0], dtype=torch.float64)
    want = [2.0**-10, 2.0**-10, 2.0**-9, 2.0**-24, 2.0**-24, 32.0]
    assert check.ulp16(x).tolist() == want


def test_pooled_err_bounds_sound_and_unsound():
    table, ids, _ = _case(2, hot=64, batch=30, rows=500)
    f32 = table.float()[ids].sum(1).half()
    assert check.pooled_err_bounds(f32, table, ids) <= 1.0
    h = table[ids[:, 0]].clone()
    for j in range(1, ids.shape[1]):
        h = h + table[ids[:, j]]  # fp16 sums, rounded each add
    assert check.pooled_err_bounds(h, table, ids) > 3.0


def test_verdict():
    ok, checks = check.verdict({"a": 1.0, "b": 2.0}, {"a": 1.0, "b": 1.5})
    assert not ok and checks["a"] == {"value": 1.0, "limit": 1.0}
    assert not check.verdict({"a": float("nan")}, {"a": 1.0})[0]
    assert not check.verdict({}, {"a": 1.0})[0]
    assert check.verdict({"a": 0.5}, {"a": 1.0})[0]
