"""The byte arithmetic against hand counts."""

from __future__ import annotations

import pytest

from portbench import bounds


def test_lookup_bytes_by_hand():
    # 3 distinct rows of 4 fp16 values, 6 int64 ids, 2 pooled rows out
    assert bounds.lookup_bytes(unique_rows=3, ids=6, out_rows=2, width=4, elem=2) == \
        3 * 8 + 6 * 8 + 2 * 8


def test_k1_bound_flagship():
    # forward_bound at the flagship: 4,194,304 ids, 65,536 bags, width 256 fp16
    kw = dict(unique_rows=600_000, ids=65536 * 64, out_rows=65536, width=256, elem=2)
    nbytes = 600_000 * 512 + 65536 * 64 * 8 + 65536 * 512
    assert bounds.lookup_bytes(**kw) == nbytes
    assert bounds.k1_bound_s(**kw) == pytest.approx(nbytes / 3.35e12)


def test_k1_bound_by_operations_when_rows_are_few():
    kw = dict(unique_rows=1, ids=10**9, out_rows=1, width=1024, elem=2)
    assert bounds.k1_bound_s(**kw) == pytest.approx(10**9 * 1024 / 67e12)


def test_k3_bound_by_hand():
    # backward_bound(compressed): gy rows once, index + sid per position, each unique row + index
    got = bounds.k3_bound_s(gy_rows=10, width=8, live=40, unique_rows=5)
    assert got == pytest.approx((10 * 32 + 40 * 12 + 5 * (32 + 8)) / 3.35e12)


def test_step_bytes_by_hand():
    # lookup (2 rows, 4 ids, 2 out, width 4 fp16) + grad_y fp32 + rows written + accum r/w
    assert bounds.step_bytes(unique_rows=2, ids=4, batch=2, width=4, elem=2) == \
        (2 * 8 + 4 * 8 + 2 * 8) + 2 * 16 + 2 * (8 + 8)
