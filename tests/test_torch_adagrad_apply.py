"""Row-wise AdaGrad's apply (``cuembed_tpu_torch/ops/cuda_adagrad.py``).

On the CPU the port's update takes the plain apply, held to the JAX
package's ``rowwise_adagrad_sparse_update`` over table dtypes, index dtypes
and widths: batches of distinct ids (one rank a row), batches with repeats
(fewer ranks than positions), CSR batches with zero weights and capacity
padding (the sentinel run), and empty batches (which the JAX function
refuses: the state must stay as it was). On integer-exact data
(gradient rows that are integer multiples of one sign pattern, so every sum
and mean square is exact; for distinct ids rows of 2^k and the accumulator
at 3 * 4^k, lr 0.5 and eps 0, so the root and the quotient are exact too)
the two agree bit for bit; on random reals within one rounding of the
table's dtype and a millionth of the step. The apply alone: a count
above the capacity is clamped, sentinel, negative and too-large indices
change nothing, and ranks past the count are never used. On the card
(``-m cuda``): K4 against the plain version, bit for bit on exact data and
within one spacing of the table's dtype on random reals; a row past the
count, NaN in K3's unzeroed buffers, never reaches the table; two launches
give the same bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuembed_tpu import train as jtrain

import cuembed_tpu_torch as tce
from cuembed_tpu_torch.ops import cuda_adagrad, dispatch
from cuembed_tpu_torch.ops.lookup_torch import SENTINEL, CompressedGrad
from cuembed_tpu_torch.utils import trace

V, B, H = 64, 16, 4
DTYPES = [torch.float32, torch.float16, torch.bfloat16]
JDT = {torch.float32: jnp.float32, torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16}
INDEX = [torch.int32, torch.int64]
WIDTHS = [1, 3, 128, 256]
CASES = ["distinct", "repeats", "csr", "empty"]


def _rows(rng, n, width, integer):
    """``n`` gradient rows and, integer-exact, their exponents: each row
    2^k times one sign pattern shared by all rows (k in 0..2), so that any
    sum of rows is an integer times the pattern and its mean square is
    exact at every width; else standard normal."""
    if not integer:
        return rng.standard_normal((n, width)).astype(np.float32), None
    k = rng.integers(0, 3, n)
    scale = np.ldexp(1.0, k) * rng.choice([-1.0, 1.0], n)
    sign = rng.choice([-1.0, 1.0], width)
    return (scale[:, None] * sign).astype(np.float32), k


def _problem(case, width, integer, seed=0):
    """``(table, accum, lr, eps, batch)``; the batch holds ``indices`` and
    ``grad_y`` and, for CSR, ``offsets`` and ``weights``."""
    rng = np.random.default_rng(seed)
    table = (rng.integers(-4, 5, (V, width)) if integer
             else rng.standard_normal((V, width))).astype(np.float32)
    accum = rng.random(V).astype(np.float32)
    batch = {}
    if case == "distinct":
        ids = rng.permutation(V)[:B]
        gy, k = _rows(rng, B, width, integer)
        if integer:  # accum + g2 = 4^(k+1): the root and the quotient are exact
            accum[ids] = 3.0 * np.ldexp(1.0, 2 * k)
        batch = dict(indices=ids[:, None], grad_y=gy)
    elif case == "repeats":
        gy, _ = _rows(rng, B, width, integer)
        batch = dict(indices=rng.integers(0, V // 4, (B, H)), grad_y=gy)
    elif case == "csr":
        hots = rng.integers(0, H + 1, B)
        offsets = np.concatenate([[0], np.cumsum(hots)])
        ids = rng.integers(1, V, int(offsets[-1]) + 5)
        w = (rng.choice([0.5, 1.0], ids.shape) if integer
             else rng.random(ids.shape)).astype(np.float32)
        ids[[0, 2]] = 0  # row 0 only with weight 0: no update may touch it
        w[[0, 2]] = 0.0
        gy, _ = _rows(rng, B, width, integer)
        batch = dict(indices=ids, grad_y=gy, offsets=offsets, weights=w)
    else:
        batch = dict(indices=np.zeros((0, H), np.int64),
                     grad_y=np.zeros((0, width), np.float32))
    lr, eps = (0.5, 0.0) if integer else (0.1, 1e-8)
    return table, accum, lr, eps, batch


def _spacing(x, dtype):
    """The spacing of ``dtype`` at ``|x|`` (its subnormal spacing at 0)."""
    mant = {torch.float32: 23, torch.float16: 10, torch.bfloat16: 7}[dtype]
    tiny = np.ldexp(1.0, -24 if dtype == torch.float16 else -149)
    return np.maximum(np.ldexp(1.0, np.frexp(np.abs(x))[1] - 1 - mant), tiny)


def _within_one_rounding(got, want, before, dtype, rel=1e-6):
    """``got`` within one spacing of ``dtype`` at the step ``want - before``
    plus one at ``want`` (the update rounds to the table's dtype, then the
    sum; a step's order of sums may flip either rounding), plus ``rel`` of
    the step (the fp32 step itself moves by a few of its ulps with the order
    of the sum of squares and a root taken as ``rsqrt``)."""
    got, want, before = (np.asarray(x, np.float64) for x in (got, want, before))
    step = want - before
    bound = _spacing(step, dtype) + _spacing(want, dtype) + rel * np.abs(step)
    assert np.all(np.abs(got - want) <= bound), np.max(np.abs(got - want) / bound)


@pytest.mark.parametrize("integer", [True, False], ids=["exact", "reals"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("index_dtype", INDEX, ids=["i32", "i64"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "fp16", "bf16"])
def test_update_matches_jax(dtype, index_dtype, width, case, integer):
    table, accum, lr, eps, batch = _problem(case, width, integer)
    jt = jnp.asarray(table).astype(JDT[dtype])
    if case == "empty":  # the JAX function refuses an empty batch: nothing changes
        want_t, want_a = jt, accum
    else:
        jb = {k: jnp.asarray(v.astype(np.int32) if k in ("indices", "offsets") else v)
              for k, v in batch.items()}
        want_t, want_a = jtrain.rowwise_adagrad_sparse_update(
            jt, jnp.asarray(accum), lr=lr, eps=eps, **jb)
    t = torch.from_numpy(table.copy()).to(dtype)
    a = torch.from_numpy(accum.copy())
    tb = {k: torch.from_numpy(v).to(index_dtype) if k in ("indices", "offsets")
          else torch.from_numpy(v) for k, v in batch.items()}
    got_t, got_a = tce.rowwise_adagrad_sparse_update(t, a, lr=lr, eps=eps, **tb)
    assert got_t is t and got_a is a
    want_t = np.asarray(want_t.astype(jnp.float32))
    want_a = np.asarray(want_a)
    if integer:
        assert np.array_equal(a.numpy(), want_a)
        assert np.array_equal(t.float().numpy(), want_t)
    else:
        np.testing.assert_allclose(a.numpy(), want_a, rtol=1e-6, atol=0)
        before = torch.from_numpy(table).to(dtype).float().numpy()
        _within_one_rounding(t.float().numpy(), want_t, before, dtype)
    if case == "csr":
        assert a[0] == accum[0] and torch.equal(t[0], torch.from_numpy(table[0]).to(dtype))


def _cg(rows, uniq, nu, index_dtype=torch.int64):
    return CompressedGrad(torch.as_tensor(rows, dtype=torch.float32),
                          torch.as_tensor(uniq, dtype=index_dtype),
                          torch.tensor(nu, dtype=torch.int64))


def _apply(table, accum, cg, **kw):
    t, a = table.clone(), accum.clone()
    cuda_adagrad.rowwise_adagrad_apply_cuda(t, a, cg, lr=0.1, eps=1e-8, **kw)
    return t, a


@pytest.mark.parametrize("index_dtype", INDEX, ids=["i32", "i64"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "fp16", "bf16"])
def test_a_count_above_the_capacity_is_clamped(dtype, index_dtype):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((V, 8)).astype(np.float32)).to(dtype)
    accum = torch.from_numpy(rng.random(V).astype(np.float32))
    rows, uniq = rng.standard_normal((10, 8)), np.sort(rng.permutation(V)[:10])
    at_cap = _apply(table, accum, _cg(rows, uniq, 10, index_dtype))
    above = _apply(table, accum, _cg(rows, uniq, 17, index_dtype))
    assert all(torch.equal(x, y) for x, y in zip(at_cap, above))
    assert not torch.equal(at_cap[1], accum)


@pytest.mark.parametrize("index_dtype", INDEX, ids=["i32", "i64"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "fp16", "bf16"])
def test_out_of_range_runs_change_nothing(dtype, index_dtype):
    """Negative, too large and sentinel indices, and the ranks past the
    count (NaN rows, valid indices), leave the table and the accumulators
    as they would be without them."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((V, 8)).astype(np.float32)).to(dtype)
    table[:, 1] = -0.0  # the skipped ranks add -0 to rows: the sign must stay
    accum = torch.from_numpy(rng.random(V).astype(np.float32))
    good = np.sort(rng.permutation(np.arange(1, V))[:6])
    rows = rng.standard_normal((12, 8))
    uniq = np.concatenate([[-5, -1], good, [V, SENTINEL], [3, 4]])
    rows[10:] = np.nan
    clean = _apply(table, accum, _cg(rows[2:8], good, 6, index_dtype))
    mixed = _apply(table, accum, _cg(rows, uniq, 10, index_dtype))
    assert all(torch.equal(x, y) for x, y in zip(clean, mixed))
    untouched = np.setdiff1d(np.arange(V), good)
    assert torch.equal(mixed[0][untouched].view(torch.int16 if dtype != torch.float32
                                                else torch.int32),
                       table[untouched].view(torch.int16 if dtype != torch.float32
                                             else torch.int32))
    assert torch.equal(mixed[1][untouched], accum[untouched])


def test_an_empty_gradient_changes_nothing():
    table, accum = torch.randn(V, 8), torch.rand(V)
    t, a = _apply(table, accum, _cg(np.zeros((0, 8)), np.zeros(0), 0))
    assert torch.equal(t, table) and torch.equal(a, accum)


@pytest.mark.parametrize("bad", ["table_dtype", "accum_shape", "accum_dtype", "rows_dtype",
                                 "rows_width", "uniq_shape", "uniq_dtype", "count",
                                 "device", "contiguity"])
def test_inputs_are_checked(bad):
    table, accum = torch.randn(V, 8), torch.rand(V)
    rows, uniq, nu = torch.randn(5, 8), torch.arange(5), torch.tensor(5)
    if bad == "table_dtype":
        table = table.double()
    elif bad == "accum_shape":
        accum = accum[:-1]
    elif bad == "accum_dtype":
        accum = accum.half()
    elif bad == "rows_dtype":
        rows = rows.half()
    elif bad == "rows_width":
        rows = rows[:, :4]
    elif bad == "uniq_shape":
        uniq = uniq[:4]
    elif bad == "uniq_dtype":
        uniq = uniq.float()
    elif bad == "count":
        nu = nu.int()
    elif bad == "device":
        nu = nu.to("meta")
    else:
        rows = torch.randn(8, 5).t()
    with pytest.raises(ValueError):
        cuda_adagrad.rowwise_adagrad_apply_cuda(table, accum, CompressedGrad(rows, uniq, nu),
                                                lr=0.1, eps=1e-8)


def test_xla_backend_takes_the_plain_version(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(cuda_adagrad, "rowwise_adagrad_apply_cuda", refuse)
    table, accum = torch.randn(V, 8), torch.rand(V)
    cg = _cg(np.ones((3, 8)), [1, 2, 3], 3)
    t, a = table.clone(), accum.clone()
    dispatch.rowwise_adagrad_apply(t, a, cg, lr=0.1, eps=1e-8, backend="xla")
    assert not torch.equal(a, accum)
    with pytest.raises(AssertionError, match="wrapper"):
        dispatch.rowwise_adagrad_apply(t, a, cg, lr=0.1, eps=1e-8)


def test_the_plain_version_launches_nothing():
    before = trace.counters()["launch.k4"]
    _apply(torch.randn(V, 8), torch.rand(V), _cg(np.ones((3, 8)), [1, 2, 3], 3))
    assert trace.counters()["launch.k4"] == before


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_ROWS = 8192  # table rows of the card's cases


def _device_cg(rng, cap, width, index_dtype, integer, device, *, count=None, rows_past=0.0):
    """A compressed gradient on the card: ``count`` distinct ascending ids
    (a few negative or past the table, the last the sentinel), and ``cap -
    count`` ranks past them filled with ``rows_past`` and valid ids."""
    count = cap if count is None else count
    rows, k = _rows(rng, cap, width, integer)
    ids = np.sort(rng.choice(np.arange(-16, CARD_ROWS + 16), count, replace=False))
    ids[-1] = SENTINEL
    past = rng.integers(0, CARD_ROWS, cap - count)
    rows[count:] = rows_past
    uniq = np.concatenate([ids, past])
    return (CompressedGrad(torch.from_numpy(rows).to(device),
                           torch.from_numpy(uniq).to(device=device, dtype=index_dtype),
                           torch.tensor(count, dtype=torch.int64, device=device)), k)


def _state(rng, width, dtype, integer, device, cg=None, k=None):
    table = (rng.integers(-4, 5, (CARD_ROWS, width)) if integer
             else rng.standard_normal((CARD_ROWS, width))).astype(np.float32)
    accum = rng.random(CARD_ROWS).astype(np.float32)
    if integer:
        uniq = cg.unique_indices.cpu().numpy()[:int(cg.num_unique)]
        on = (uniq >= 0) & (uniq < CARD_ROWS)
        accum[uniq[on]] = 3.0 * np.ldexp(1.0, 2 * k[:len(uniq)][on])
    return (torch.from_numpy(table).to(device=device, dtype=dtype),
            torch.from_numpy(accum).to(device))


def _both(table, accum, cg, lr, eps):
    """K4's result and the plain version's, each from a copy."""
    kt, ka = table.clone(), accum.clone()
    pt, pa = table.clone(), accum.clone()
    cuda_adagrad.rowwise_adagrad_apply_cuda(kt, ka, cg, lr=lr, eps=eps)
    cuda_adagrad.rowwise_adagrad_apply_torch(pt, pa, cg, lr=lr, eps=eps)
    return kt, ka, pt, pa


CARD_WIDTHS = [1, 3, 128, 256, 130, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False], ids=["exact", "reals"])
@pytest.mark.parametrize("width", CARD_WIDTHS)
@pytest.mark.parametrize("index_dtype", INDEX, ids=["i32", "i64"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "fp16", "bf16"])
def test_k4_matches_the_plain_version(card, dtype, index_dtype, width, integer):
    rng = np.random.default_rng(width)
    cg, k = _device_cg(rng, 300, width, index_dtype, integer, card, count=200)
    table, accum = _state(rng, width, dtype, integer, card, cg, k)
    lr, eps = (0.5, 0.0) if integer else (0.1, 1e-8)
    before = trace.counters()["launch.k4"]
    kt, ka, pt, pa = _both(table, accum, cg, lr, eps)
    assert trace.counters()["launch.k4"] == before + 1
    if integer:
        assert torch.equal(ka, pa) and torch.equal(kt, pt)
    else:
        np.testing.assert_allclose(ka.cpu().numpy(), pa.cpu().numpy(), rtol=1e-6, atol=0)
        _within_one_rounding(kt.float().cpu(), pt.float().cpu(), table.float().cpu(), dtype)
    assert not torch.equal(ka, accum)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 1000])
def test_k4_never_reads_past_the_count(card, width):
    rng = np.random.default_rng(7)
    cg, _ = _device_cg(rng, 4096, width, torch.int64, False, card, count=1000,
                       rows_past=np.nan)
    table, accum = _state(rng, width, torch.float16, False, card)
    kt, ka, _, _ = _both(table, accum, cg, 0.1, 1e-8)
    assert not kt.isnan().any() and not ka.isnan().any()
    touched = torch.zeros(CARD_ROWS, dtype=torch.bool, device=card)
    uniq = cg.unique_indices[:1000]
    touched[uniq[(uniq >= 0) & (uniq < CARD_ROWS)]] = True
    assert torch.equal(kt[~touched], table[~touched])
    assert torch.equal(ka[~touched], accum[~touched])


@pytest.mark.cuda
def test_k4_gives_the_same_bits_twice(card):
    rng = np.random.default_rng(8)
    cg, _ = _device_cg(rng, 5000, 256, torch.int64, False, card, count=4000)
    table, accum = _state(rng, 256, torch.bfloat16, False, card)
    first = _both(table, accum, cg, 0.1, 1e-8)[:2]
    second = _both(table, accum, cg, 0.1, 1e-8)[:2]
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.fixture
def nan_buffers(monkeypatch):
    """``torch.empty`` and ``torch.empty_like`` on the card filled with NaN
    (floats) and row 1 (integers): K3's unzeroed buffers hold what a row
    past the count must never pass on."""
    empty, empty_like = torch.empty, torch.empty_like

    def fill(t):
        if t.is_cuda:
            t.fill_(float("nan") if t.is_floating_point() else 1)
        return t

    monkeypatch.setattr(torch, "empty", lambda *a, **k: fill(empty(*a, **k)))
    monkeypatch.setattr(torch, "empty_like", lambda *a, **k: fill(empty_like(*a, **k)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "fp16", "bf16"])
def test_unzeroed_buffers_never_reach_the_tables(card, nan_buffers, dtype):
    rng = np.random.default_rng(9)
    width, rows = 128, 5000
    table = torch.from_numpy(rng.standard_normal((rows, width)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, rows // 8, (512, 8)))
    gy = torch.from_numpy(rng.standard_normal((512, width)).astype(np.float32))
    got_t, got_a = table.to(card, dtype), torch.zeros(rows, device=card)
    want_t, want_a = got_t.clone(), got_a.clone()
    tce.rowwise_adagrad_sparse_update(got_t, got_a, ids.to(card), gy.to(card), lr=0.1)
    tce.rowwise_adagrad_sparse_update(want_t, want_a, ids.to(card), gy.to(card), lr=0.1,
                                      backend="xla")
    assert not got_t.isnan().any() and not got_a.isnan().any()
    # K3 and the plain backward sum a run in other orders.
    np.testing.assert_allclose(got_a.cpu().numpy(), want_a.cpu().numpy(), rtol=1e-5, atol=0)
    step = (want_t.float() - table.to(card, dtype).float()).abs().cpu().numpy()
    np.testing.assert_allclose(got_t.float().cpu().numpy(), want_t.float().cpu().numpy(),
                               rtol=0, atol=1e-5 * step.max()
                               + _spacing(want_t.float().cpu().numpy(), dtype).max())
