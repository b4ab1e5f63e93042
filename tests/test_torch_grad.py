"""The port's differentiable lookup against ``jax.grad`` through
``cuembed_tpu.embedding_lookup(_csr)``, ``torch.autograd.gradcheck`` and
``torch.nn.EmbeddingBag``'s gradient.

The table comes from the JAX package's ``EmbeddingBag`` parameters (as
numpy) and is carried across with ``EmbeddingBag.from_numpy``; indices,
weights and cotangents are made with numpy from a seed.

Tolerances. On integer-valued data (integer table and cotangent, weights in
{0.5, 1}) every partial sum is exact: both gradients bitwise. On random
reals the two packages add the same terms, possibly in another order, in
the accumulation type (fp32, or the half type under low-precision math),
then round once to the table's type: each gradient element is held to
2 (n + 1) 2^-p sum|terms| + one ulp of the table's type, with n the terms
summed and p the accumulation type's significand bits.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuembed_tpu as jce
from cuembed_tpu.models.embedding_bag import EmbeddingBag as JaxBag

import cuembed_tpu_torch as tce
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)

V, W, B, H = 60, 16, 12, 5
BITS = {torch.float32: 24, torch.float16: 11, torch.bfloat16: 8}
JNP = {torch.float32: jnp.float32, torch.float16: jnp.float16,
       torch.bfloat16: jnp.bfloat16}

CASES = [  # (layout, mode, weighted)
    ("fixed", "sum", False), ("fixed", "mean", False), ("fixed", "concat", False),
    ("fixed", "sum", True), ("csr", "sum", True), ("csr", "mean", False),
]
TYPES = [(torch.float32, False), (torch.bfloat16, False), (torch.float16, False),
         (torch.bfloat16, True), (torch.float16, True)]


def _problem(layout, mode, weighted, dtype, integer, seed=0):
    rng = np.random.default_rng(seed)
    if integer:
        table = rng.integers(-4, 5, (V, W)).astype(np.float32)
        if dtype != torch.float32:
            table = table.astype(ml_dtypes.bfloat16 if dtype == torch.bfloat16
                                 else np.float16)
    else:
        jbag = JaxBag(V, W, dtype=JNP[dtype], layout="raw")
        table = jbag.export_table(jbag.init(jax.random.PRNGKey(seed)))
    if layout == "fixed":
        idx = rng.integers(0, V, (B, H))
        offsets = None
        n = B * H
    else:
        hots = rng.integers(0, H + 1, B)
        hots[[1, 4]] = 0
        offsets = np.concatenate([[0], np.cumsum(hots)])
        n = int(offsets[-1]) + 4  # capacity padding
        idx = rng.integers(0, V, n)
    weights = None
    if weighted:
        weights = (rng.choice([0.5, 1.0], idx.shape) if integer
                   else rng.random(idx.shape)).astype(np.float32)
    rows = B * H if mode == "concat" else B
    ct = (rng.integers(-3, 4, (rows, W)) if integer
          else rng.standard_normal((rows, W))).astype(np.float32)
    return table, idx, offsets, weights, ct


def _jax_grads(table, idx, offsets, weights, ct, mode, lpm, tiered=None):
    def loss(t, w):
        if offsets is None:
            out = jce.embedding_lookup(t, jnp.asarray(idx.astype(np.int32)), w,
                                       mode=jce.CombineMode(mode), low_precision_math=lpm,
                                       tiered_cfg=None if tiered is None
                                       else jce.TieredConfig(**tiered))
        else:
            out = jce.embedding_lookup_csr(
                t, jnp.asarray(idx.astype(np.int32)), jnp.asarray(offsets.astype(np.int32)),
                w, mode=jce.CombineMode(mode), low_precision_math=lpm,
                tiered_cfg=None if tiered is None else jce.TieredConfig(**tiered))
        return jnp.vdot(out.astype(jnp.float32), jnp.asarray(ct))
    w = None if weights is None else jnp.asarray(weights)
    g_t, g_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table), w)
    return (np.asarray(g_t).astype(np.float32),
            None if g_w is None else np.asarray(g_w).astype(np.float32))


def _torch_grads(table, idx, offsets, weights, ct, mode, lpm, backend="auto", tiered=None):
    bag = tce.EmbeddingBag.from_numpy(table, mode=tce.CombineMode(mode), device="cpu")
    w = None if weights is None else torch.from_numpy(weights).requires_grad_()
    kw = dict(mode=tce.CombineMode(mode), low_precision_math=lpm, backend=backend,
              tiered_cfg=None if tiered is None else tce.TieredConfig(**tiered))
    if offsets is None:
        out = tce.embedding_lookup(bag.weight, torch.from_numpy(idx), w, **kw)
    else:
        out = tce.embedding_lookup_csr(bag.weight, torch.from_numpy(idx),
                                       torch.from_numpy(offsets), w, **kw)
    assert out.requires_grad
    (out.float() * torch.from_numpy(ct)).sum().backward()
    return (bag.weight.grad.float().numpy(), bag.weight.grad.dtype,
            None if w is None else w.grad.numpy())


def _mass(table, idx, offsets, weights, ct, mode):
    """sum |terms| of each table-gradient and weights-gradient element, and
    the most terms any table-gradient element sums (float64)."""
    t = torch.from_numpy(np.abs(np.asarray(table, np.float64))).requires_grad_()
    w = None if weights is None else torch.from_numpy(
        np.abs(weights).astype(np.float64)).requires_grad_()
    kw = dict(mode=tce.CombineMode(mode), backend="xla")
    if offsets is None:
        out = tce.embedding_lookup(t, torch.from_numpy(idx), w, **kw)
        live = idx.reshape(-1)
    else:
        out = tce.embedding_lookup_csr(t, torch.from_numpy(idx), torch.from_numpy(offsets),
                                       w, **kw)
        live = idx[:int(offsets[-1])]
    (out * torch.from_numpy(np.abs(ct)).double()).sum().backward()
    n = np.bincount(live, minlength=V).max()
    return t.grad.numpy(), None if w is None else w.grad.numpy(), n


def _ulp(x, dtype):
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, np.maximum(e, -125) - BITS[dtype])


@pytest.mark.parametrize("dtype,lpm", TYPES,
                         ids=["fp32", "bf16", "fp16", "bf16-lpm", "fp16-lpm"])
@pytest.mark.parametrize("layout,mode,weighted", CASES,
                         ids=["sum", "mean", "concat", "weighted", "csr-weighted", "csr-mean"])
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "reals"])
def test_grads_match_jax(integer, layout, mode, weighted, dtype, lpm):
    table, idx, offsets, weights, ct = _problem(layout, mode, weighted, dtype, integer)
    want_t, want_w = _jax_grads(table, idx, offsets, weights, ct, mode, lpm)
    got_t, got_dtype, got_w = _torch_grads(table, idx, offsets, weights, ct, mode, lpm)
    assert got_dtype == dtype
    if integer and mode != "mean":
        np.testing.assert_array_equal(got_t, want_t)
        if weights is not None:
            np.testing.assert_array_equal(got_w, want_w)
        return
    p = BITS[dtype] if lpm else 24
    mass_t, mass_w, n = _mass(table, idx, offsets, weights, ct, mode)
    tol_t = 2 * (n + 1) * 2.0**-p * mass_t + _ulp(want_t, dtype)
    assert np.all(np.abs(got_t - want_t) <= tol_t)
    if weights is not None:
        # A dot product over the width in the accumulation type, rounded to
        # fp32 weights.
        tol_w = 2 * (W + 1) * 2.0**-p * mass_w + _ulp(want_w, torch.float32)
        assert np.all(np.abs(got_w - want_w) <= tol_w)


# A tiered config whose head (rows under 20) the problems' ids hit often.
TIERED = dict(hot_rows=40, chunk_elems=20, cold_slots=8, mxu_head_rows=20, mid_slots=8)


@pytest.mark.parametrize("dtype,lpm", TYPES,
                         ids=["fp32", "bf16", "fp16", "bf16-lpm", "fp16-lpm"])
@pytest.mark.parametrize("layout,mode,weighted", CASES,
                         ids=["sum", "mean", "concat", "weighted", "csr-weighted", "csr-mean"])
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "reals"])
def test_tiered_grads_match_jax(integer, layout, mode, weighted, dtype, lpm):
    """With a tiered_cfg, which changes no gradient (the port sums the
    whole COO), against jax.grad through the JAX package's tiered backward
    (its head product for pooled fixed lookups), held as
    test_grads_match_jax holds the untiered ones: integer data bit for bit
    but for MEAN (its 1/5 terms are inexact, and the head product sums them
    in another order), the rest to the recursive-sum bound."""
    table, idx, offsets, weights, ct = _problem(layout, mode, weighted, dtype, integer,
                                                seed=5)
    if offsets is None:
        idx = np.where(np.arange(H) < 2, idx % 20, idx)  # head traffic
    want_t, want_w = _jax_grads(table, idx, offsets, weights, ct, mode, lpm, TIERED)
    got_t, got_dtype, got_w = _torch_grads(table, idx, offsets, weights, ct, mode, lpm,
                                           tiered=TIERED)
    assert got_dtype == dtype
    if integer and mode != "mean":
        np.testing.assert_array_equal(got_t, want_t)
        if weights is not None:
            np.testing.assert_array_equal(got_w, want_w)
        return
    p = BITS[dtype] if lpm else 24
    mass_t, mass_w, n = _mass(table, idx, offsets, weights, ct, mode)
    tol_t = 2 * (n + 1) * 2.0**-p * mass_t + _ulp(want_t, dtype)
    assert np.all(np.abs(got_t - want_t) <= tol_t)
    if weights is not None:
        tol_w = 2 * (W + 1) * 2.0**-p * mass_w + _ulp(want_w, torch.float32)
        assert np.all(np.abs(got_w - want_w) <= tol_w)


@pytest.mark.parametrize("layout,mode,weighted", CASES,
                         ids=["sum", "mean", "concat", "weighted", "csr-weighted", "csr-mean"])
def test_backends_agree(layout, mode, weighted):
    """"auto" (K3's CPU route) and "xla" (the plain version) give the same
    bits on the CPU."""
    table, idx, offsets, weights, ct = _problem(layout, mode, weighted, torch.float32,
                                                False, seed=3)
    a = _torch_grads(table, idx, offsets, weights, ct, mode, False, backend="auto")
    x = _torch_grads(table, idx, offsets, weights, ct, mode, False, backend="xla")
    np.testing.assert_array_equal(a[0], x[0])
    if weights is not None:
        np.testing.assert_array_equal(a[2], x[2])


@pytest.mark.parametrize("layout,mode", [("fixed", "sum"), ("fixed", "mean"),
                                         ("fixed", "concat"), ("csr", "mean")])
def test_gradcheck_float64(layout, mode):
    """Finite differences in float64 (the plain version keeps float64
    tables in float64) against the autograd backward."""
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((9, 3))).requires_grad_()
    m = tce.CombineMode(mode)
    if layout == "fixed":
        idx = torch.from_numpy(rng.integers(0, 9, (4, 3)))
        fn = lambda t: tce.embedding_lookup(t, idx, mode=m, backend="xla")  # noqa: E731
    else:
        offsets = torch.tensor([0, 2, 2, 5])
        flat = torch.from_numpy(rng.integers(0, 9, 7))
        fn = lambda t: tce.embedding_lookup_csr(t, flat, offsets, mode=m,  # noqa: E731
                                                backend="xla")
    assert torch.autograd.gradcheck(fn, (table,))


def test_gradcheck_weights_float64():
    """The weights gradient by finite differences, through a float32
    forward: the step must stay well above fp32's resolution."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.integers(-3, 4, (9, 4)).astype(np.float64))
    idx = torch.from_numpy(rng.integers(0, 9, (3, 2)))
    w = torch.from_numpy(rng.integers(1, 4, (3, 2)).astype(np.float64)).requires_grad_()
    fn = lambda w_: tce.embedding_lookup(table, idx, w_, backend="xla")  # noqa: E731
    assert torch.autograd.gradcheck(fn, (w,), eps=1e-2, atol=1e-4)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_module_grad_matches_torch_embedding_bag(mode):
    """The module's table and per-sample-weight gradients against
    torch.nn.EmbeddingBag's (which sums in another order: fp32 tolerance)."""
    rng = np.random.default_rng(4)
    ref = torch.nn.EmbeddingBag(V, W, mode=mode)
    bag = tce.EmbeddingBag.from_torch(ref)
    idx = torch.from_numpy(rng.integers(0, V, (B, H)))
    ct = torch.from_numpy(rng.standard_normal((B, W)).astype(np.float32))
    w = torch.from_numpy(rng.random((B, H)).astype(np.float32)) if mode == "sum" else None
    w_ref = None if w is None else w.clone().requires_grad_()
    w_got = None if w is None else w.clone().requires_grad_()
    (ref(idx, per_sample_weights=w_ref) * ct).sum().backward()
    (bag(idx, w_got) * ct).sum().backward()
    torch.testing.assert_close(bag.weight.grad, ref.weight.grad, rtol=1e-5, atol=1e-6)
    if w is not None:
        torch.testing.assert_close(w_got.grad, w_ref.grad, rtol=1e-5, atol=1e-6)


def test_backward_refuses_tables_of_2_31_rows():
    """The JAX guard (api.py:174-183): the COO path keeps an int32-max
    sentinel, so such a table has no backward (its forward still works)."""
    from cuembed_tpu_torch.ops.api import _lookup_bwd

    big = torch.empty((2**31, 1), device="meta")
    with pytest.raises(NotImplementedError, match="2\\*\\*31"):
        _lookup_bwd((tce.CombineMode.SUM, False, "xla", None), big,
                    torch.zeros((1, 1), dtype=torch.int64), None, None,
                    torch.zeros((1, 1)))
