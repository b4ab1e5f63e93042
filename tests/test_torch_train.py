"""The port's sparse optimizers against ``cuembed_tpu.train``.

Fixed (SUM, MEAN), CSR-weighted (with zero weights and capacity padding)
and CONCAT batches, made with numpy from a seed. On integer-valued data
(integer table, grad_y and weights in {0, 0.5, 1}) every per-row sum is
exact, and the updates are the same float operations in both packages:
bitwise, except where a quotient by a square root enters: XLA may compute
``a / sqrt(b)`` as ``a * rsqrt(b)``, one ulp off the correctly rounded
quotient (rtol 1e-6 for fp32 tables, one ulp for bf16 ones). On random reals
the per-row sums are taken in another order (the JAX SGD even adds per
position): fp32 tolerance rtol = atol = 1e-5.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuembed_tpu as jce
from cuembed_tpu import train as jtrain

import cuembed_tpu_torch as tce
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)

V, W, B, H = 80, 8, 12, 4
CASES = [("fixed", "sum"), ("fixed", "mean"), ("csr", "sum"), ("fixed", "concat")]


def _problem(layout, mode, integer, seed=0):
    rng = np.random.default_rng(seed)
    table = (rng.integers(-4, 5, (V, W)) if integer
             else rng.standard_normal((V, W))).astype(np.float32)
    offsets = weights = None
    if layout == "fixed":
        idx = rng.integers(1, V, (B, H))
    else:
        hots = rng.integers(0, H + 1, B)
        offsets = np.concatenate([[0], np.cumsum(hots)])
        idx = rng.integers(1, V, int(offsets[-1]) + 5)
        weights = (rng.choice([0.5, 1.0], idx.shape) if integer
                   else rng.random(idx.shape)).astype(np.float32)
        # Row 0 is looked up only with weight 0: no update may touch it.
        idx[[0, 2]] = 0
        weights[[0, 2]] = 0.0
    rows = B * H if mode == "concat" else B
    gy = (rng.integers(-3, 4, (rows, W)) if integer
          else rng.standard_normal((rows, W))).astype(np.float32)
    return table, idx, offsets, weights, gy


def _jargs(idx, offsets, weights, gy, mode):
    return dict(indices=jnp.asarray(idx.astype(np.int32)), grad_y=jnp.asarray(gy),
                offsets=None if offsets is None else jnp.asarray(offsets.astype(np.int32)),
                weights=None if weights is None else jnp.asarray(weights),
                mode=jce.CombineMode(mode))


def _targs(idx, offsets, weights, gy, mode):
    return dict(indices=torch.from_numpy(idx), grad_y=torch.from_numpy(gy),
                offsets=None if offsets is None else torch.from_numpy(offsets),
                weights=None if weights is None else torch.from_numpy(weights),
                mode=tce.CombineMode(mode))


def _check(got, want, integer, rtol_integer=0.0):
    got = np.asarray(got, np.float32)
    want = np.asarray(want).astype(np.float32)
    if integer:
        np.testing.assert_allclose(got, want, rtol=rtol_integer, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _within_bf16_ulp(got, want):
    ulp = np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
    assert np.all(np.abs(got - want) <= ulp)


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("layout,mode", CASES, ids=["sum", "mean", "csr-weighted", "concat"])
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "reals"])
def test_sgd_matches_jax(integer, layout, mode):
    table, idx, offsets, weights, gy = _problem(layout, mode, integer)
    want = jtrain.sgd_sparse_update(jnp.asarray(table), lr=0.5,
                                    **_jargs(idx, offsets, weights, gy, mode))
    t = torch.from_numpy(table.copy())
    got = tce.sgd_sparse_update(t, lr=0.5, **_targs(idx, offsets, weights, gy, mode))
    assert got is t  # in place
    _check(got.numpy(), want, integer)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,mode", CASES, ids=["sum", "mean", "csr-weighted", "concat"])
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "reals"])
def test_rowwise_adagrad_two_steps_match_jax(integer, layout, mode, dtype):
    """Two steps, so the accumulator carries; rows looked up only with
    weight 0 keep their state and values."""
    table, idx, offsets, weights, gy = _problem(layout, mode, integer)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jt, ja = jnp.asarray(table).astype(jdt), jtrain.rowwise_adagrad_init(V)
    t = torch.from_numpy(table.copy()).to(dtype)
    a = tce.rowwise_adagrad_init(V, device="cpu")
    for step in range(2):
        g = gy * (step + 1)
        jt, ja = jtrain.rowwise_adagrad_sparse_update(
            jt, ja, lr=0.1, **_jargs(idx, offsets, weights, g, mode))
        t2, a2 = tce.rowwise_adagrad_sparse_update(
            t, a, lr=0.1, **_targs(idx, offsets, weights, g, mode))
        assert t2 is t and a2 is a
    if dtype == torch.float32:
        _check(t.numpy(), jt, integer, rtol_integer=1e-6)
    else:
        # One bf16 rounding of the same update: at most one ulp apart.
        _within_bf16_ulp(_f32(t), np.asarray(jt.astype(jnp.float32)))
    _check(a.numpy(), ja, integer)
    if layout == "csr":
        assert a[0] == 0 and torch.equal(t[0], torch.from_numpy(table[0]).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,mode", CASES, ids=["sum", "mean", "csr-weighted", "concat"])
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "reals"])
def test_lazy_adam_matches_jax(integer, layout, mode, dtype):
    """Steps 0 (taken as 1) and 2: bias correction, moments that decay only
    on touched rows."""
    table, idx, offsets, weights, gy = _problem(layout, mode, integer, seed=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jt = jnp.asarray(table).astype(jdt)
    jm, jv = jtrain.adam_init(V, W)
    t = torch.from_numpy(table.copy()).to(dtype)
    m, v = tce.adam_init(V, W, device="cpu")
    for step in (0, 2):
        jt, jm, jv = jtrain.adam_sparse_update(
            jt, jm, jv, step, lr=0.01, **_jargs(idx, offsets, weights, gy, mode))
        out = tce.adam_sparse_update(t, m, v, step, lr=0.01,
                                     **_targs(idx, offsets, weights, gy, mode))
        assert out[0] is t and out[1] is m and out[2] is v
    for got, want in ((m, jm), (v, jv)):
        _check(got.numpy(), want, integer)
    got, want = _f32(t), np.asarray(jt.astype(jnp.float32))
    if dtype == torch.float32:
        # Division and square root of the same fp32 moments; the moments of
        # reals differ by reassociation only.
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        _within_bf16_ulp(got, want)
    if layout == "csr":
        assert not m[0].any() and not v[0].any()
        assert torch.equal(t[0], torch.from_numpy(table[0]).to(dtype))


def test_embedding_grad_y_matches_jax():
    rng = np.random.default_rng(5)
    pooled = rng.standard_normal((B, W)).astype(np.float32)
    target = rng.standard_normal((B, W)).astype(np.float32)

    def jloss(p, y):
        return jnp.sum((p - y) ** 2) * 0.5

    def tloss(p, y):
        return ((p - y) ** 2).sum() * 0.5
    want = jtrain.embedding_grad_y(jloss, jnp.asarray(pooled), jnp.asarray(target))
    p = torch.from_numpy(pooled)
    with torch.no_grad():
        got = tce.embedding_grad_y(tloss, p, torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert not p.requires_grad


def test_sparse_sgd_equals_a_dense_autograd_step():
    """The sparse step equals torch.optim.SGD on the module's dense
    gradient (integer data: exact)."""
    table, idx, _, _, gy = _problem("fixed", "sum", True)
    bag = tce.EmbeddingBag.from_numpy(table, device="cpu")
    (bag(torch.from_numpy(idx)) * torch.from_numpy(gy)).sum().backward()
    torch.optim.SGD(bag.parameters(), lr=0.5).step()
    got = tce.sgd_sparse_update(torch.from_numpy(table.copy()), torch.from_numpy(idx),
                                torch.from_numpy(gy), lr=0.5)
    assert torch.equal(got, bag.weight.detach())


def test_tiered_updates_not_ported():
    """The tiered SGD and AdaGrad steps, which raised NotImplementedError
    before the port took them, now equal the JAX tiered steps on the same
    input (integer data: SGD bit for bit, AdaGrad to its quotient's ulp)."""
    table, idx, _, _, gy = _problem("fixed", "sum", True)
    cfg, jcfg = _tiered_cfgs()
    want = jtrain.sgd_sparse_update(jnp.asarray(table), lr=0.5, tiered_cfg=jcfg,
                                    **_jargs(idx, None, None, gy, "sum"))
    got = tce.sgd_sparse_update(torch.from_numpy(table.copy()), lr=0.5, tiered_cfg=cfg,
                                **_targs(idx, None, None, gy, "sum"))
    _check(got.numpy(), want, True)
    jt, ja = jtrain.rowwise_adagrad_sparse_update(
        jnp.asarray(table), jtrain.rowwise_adagrad_init(V), lr=0.1, tiered_cfg=jcfg,
        **_jargs(idx, None, None, gy, "sum"))
    t, a = tce.rowwise_adagrad_sparse_update(
        torch.from_numpy(table.copy()), tce.rowwise_adagrad_init(V, device="cpu"), lr=0.1,
        tiered_cfg=cfg, **_targs(idx, None, None, gy, "sum"))
    _check(t.numpy(), jt, True, rtol_integer=1e-6)
    _check(a.numpy(), ja, True)


# The tiered configs: a head of 10 rows, and non-head slots for half of each
# chunk of 16 positions, so that "drop" drops.
TIERED = dict(hot_rows=40, chunk_elems=16, cold_slots=4, mxu_head_rows=10, mid_slots=4)


def _tiered_cfgs():
    return tce.TieredConfig(**TIERED), jce.TieredConfig(**TIERED)


def _weighted_fixed(integer, seed=2):
    """A fixed batch with weights (zeros among them) and head traffic."""
    rng = np.random.default_rng(seed)
    table, idx, _, _, gy = _problem("fixed", "sum", integer, seed=seed)
    idx = np.where(rng.random(idx.shape) < 0.4, rng.integers(0, 10, idx.shape), idx)
    w = (rng.choice([0.0, 0.5, 1.0], idx.shape) if integer
         else rng.random(idx.shape)).astype(np.float32)
    return table, idx, w, gy


TIERED_CASES = ["sum", "mean", "weighted"]


def _tiered_problem(case, integer):
    if case == "weighted":
        return _weighted_fixed(integer)
    table, idx, _, _, gy = _problem("fixed", case, integer, seed=3)
    idx[:, 0] = np.arange(B) % 10  # head traffic
    return table, idx, None, gy


@pytest.mark.parametrize("overflow", ["fallback", "drop"])
@pytest.mark.parametrize("case", TIERED_CASES)
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "reals"])
def test_tiered_sgd_matches_jax(integer, case, overflow):
    """The head rows from M^T @ grad_y, the rest from K3's compressed mode
    (the plain version here); "drop" keeps the first nonhead_capacity
    sorted non-head positions, as the JAX function does."""
    table, idx, w, gy = _tiered_problem(case, integer)
    mode = "sum" if case == "weighted" else case
    cfg, jcfg = _tiered_cfgs()
    want = jtrain.sgd_sparse_update(jnp.asarray(table), lr=0.5, tiered_cfg=jcfg,
                                    overflow=overflow, **_jargs(idx, None, w, gy, mode))
    got = tce.sgd_sparse_update(torch.from_numpy(table.copy()), lr=0.5, tiered_cfg=cfg,
                                overflow=overflow, **_targs(idx, None, w, gy, mode))
    _check(got.numpy(), want, integer)
    if overflow == "drop":  # the drop did drop something
        full = jtrain.sgd_sparse_update(jnp.asarray(table), lr=0.5, tiered_cfg=jcfg,
                                        **_jargs(idx, None, w, gy, mode))
        assert not np.array_equal(np.asarray(full), np.asarray(want))


@pytest.mark.parametrize("unique_cap,overflow", [(None, "fallback"), (5, "fallback"),
                                                 (5, "drop")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TIERED_CASES)
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "reals"])
def test_tiered_rowwise_adagrad_two_steps_match_jax(integer, case, dtype, unique_cap,
                                                     overflow):
    table, idx, w, gy = _tiered_problem(case, integer)
    mode = "sum" if case == "weighted" else case
    cfg, jcfg = _tiered_cfgs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jt, ja = jnp.asarray(table).astype(jdt), jtrain.rowwise_adagrad_init(V)
    t = torch.from_numpy(table.copy()).to(dtype)
    a = tce.rowwise_adagrad_init(V, device="cpu")
    kw = dict(lr=0.1, unique_cap=unique_cap, overflow=overflow)
    for step in range(2):
        g = gy * (step + 1)
        jt, ja = jtrain.rowwise_adagrad_sparse_update(
            jt, ja, tiered_cfg=jcfg, **kw, **_jargs(idx, None, w, g, mode))
        tce.rowwise_adagrad_sparse_update(t, a, tiered_cfg=cfg, **kw,
                                          **_targs(idx, None, w, g, mode))
    if dtype == torch.float32:
        _check(t.numpy(), jt, integer, rtol_integer=1e-6)
    else:
        _within_bf16_ulp(_f32(t), np.asarray(jt.astype(jnp.float32)))
    _check(a.numpy(), ja, integer)
    # Untiered, the same steps give the same state (the split changes sums'
    # order only), unless "drop" dropped rows.
    if overflow == "fallback" and integer:
        a2 = tce.rowwise_adagrad_init(V, device="cpu")
        t2 = torch.from_numpy(table.copy()).to(dtype)
        for step in range(2):
            tce.rowwise_adagrad_sparse_update(t2, a2, lr=0.1,
                                              **_targs(idx, None, w, gy * (step + 1), mode))
        assert torch.equal(a, a2)


def test_bf16_table_dtype_is_kept():
    table, idx, _, _, gy = _problem("fixed", "sum", True)
    t = torch.from_numpy(table.astype(ml_dtypes.bfloat16).astype(np.float32)).bfloat16()
    tce.sgd_sparse_update(t, torch.from_numpy(idx), torch.from_numpy(gy), lr=0.5)
    assert t.dtype == torch.bfloat16


def test_state_needs_a_device_without_a_card():
    """The optimizer state goes to the card unless a device is given, as
    EmbeddingBag's table does; without a card that raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; tests/test_torch_cuda.py covers the default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tce.rowwise_adagrad_init(V)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tce.adam_init(V, W)
    assert tce.rowwise_adagrad_init(V, device="cpu").device.type == "cpu"
    assert all(t.device.type == "cpu" for t in tce.adam_init(V, W, device="cpu"))
