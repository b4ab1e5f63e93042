"""The port's lookup API against ``cuembed_tpu.embedding_lookup(_csr)`` and
``torch.nn.EmbeddingBag``, and its errors.

Inputs are made with numpy from a seed and handed to both packages (JAX
takes int32 indices: x64 is off in the test suite).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuembed_tpu as jce
import cuembed_tpu_torch as tce
from cuembed_tpu_torch.ops import cuda_forward
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)

V, W, B, H = 300, 24, 17, 5


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(21)
    table = rng.uniform(-0.2, 0.2, (V, W)).astype(np.float32)
    idx = rng.integers(0, V, (B, H))
    weights = rng.random((B, H)).astype(np.float32)
    hots = rng.integers(0, H + 1, B)
    offsets = np.concatenate([[0], np.cumsum(hots)])
    cap = int(offsets[-1]) + 3
    flat = rng.integers(0, V, cap)
    flat_w = rng.random(cap).astype(np.float32)
    remap = rng.permutation(V)
    return table, idx, weights, offsets, flat, flat_w, remap


def _j(a, dtype=np.int32):
    return jnp.asarray(a.astype(dtype))


@pytest.mark.parametrize("use_remap", [False, True], ids=["plain", "remap"])
@pytest.mark.parametrize("mode,weighted", [
    ("sum", False), ("sum", True), ("mean", False), ("concat", False),
])
def test_fixed_lookup_matches_jax(problem, mode, weighted, use_remap):
    table, idx, weights, _, _, _, remap = problem
    w = weights if weighted else None
    want = jce.embedding_lookup(
        jnp.asarray(table), _j(idx), None if w is None else jnp.asarray(w),
        mode=jce.CombineMode(mode), remap=_j(remap) if use_remap else None,
    )
    got = tce.embedding_lookup(
        torch.from_numpy(table), torch.from_numpy(idx),
        None if w is None else torch.from_numpy(w),
        mode=tce.CombineMode(mode),
        remap=torch.from_numpy(remap) if use_remap else None,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_remap", [False, True], ids=["plain", "remap"])
@pytest.mark.parametrize("mode,weighted", [("sum", False), ("sum", True), ("mean", False)])
def test_csr_lookup_matches_jax(problem, mode, weighted, use_remap):
    table, _, _, offsets, flat, flat_w, remap = problem
    w = flat_w if weighted else None
    want = jce.embedding_lookup_csr(
        jnp.asarray(table), _j(flat), _j(offsets),
        None if w is None else jnp.asarray(w), mode=jce.CombineMode(mode),
        remap=_j(remap) if use_remap else None,
    )
    got = tce.embedding_lookup_csr(
        torch.from_numpy(table), torch.from_numpy(flat),
        torch.from_numpy(offsets), None if w is None else torch.from_numpy(w),
        mode=tce.CombineMode(mode),
        remap=torch.from_numpy(remap) if use_remap else None,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
def test_cpu_backends_agree(problem, backend):
    """On the CPU every backend name computes the plain version."""
    table, idx, weights, offsets, flat, flat_w, _ = problem
    t = torch.from_numpy(table)
    base = tce.embedding_forward_torch(
        t, torch.from_numpy(idx), weights=torch.from_numpy(weights))
    got = tce.embedding_lookup(
        t, torch.from_numpy(idx), torch.from_numpy(weights), backend=backend)
    assert torch.equal(got, base)
    base = tce.embedding_forward_torch(
        t, torch.from_numpy(flat), torch.from_numpy(offsets),
        torch.from_numpy(flat_w))
    got = tce.embedding_lookup_csr(
        t, torch.from_numpy(flat), torch.from_numpy(offsets),
        torch.from_numpy(flat_w), backend=backend)
    assert torch.equal(got, base)


# Each case: (fixed or csr, the argument overrides, the message). Both
# packages must raise ValueError with the same message (api.py:137-149 and
# dispatch.py:137-138).
ERROR_CASES = {
    "weights_with_mean": ("fixed", {"weights": "w", "mode": "mean"},
                          "weights are only supported with CombineMode.SUM"),
    "csr_concat": ("csr", {"mode": "concat"}, "CSR does not support CONCAT"),
    "csr_2d_indices": ("csr", {"indices": "idx"}, "CSR indices must be flat"),
    "fixed_1d_indices": ("fixed", {"indices": "flat"},
                         "fixed-hotness indices must be"),
    "table_1d": ("fixed", {"table": "row"}, "table must be"),
    "float_indices": ("fixed", {"indices": "float_idx"},
                      "unsupported index dtype"),
    "unknown_backend": ("fixed", {"backend": "cuda"}, "unknown backend: cuda"),
}


def _error_args(problem, kind, overrides, to):
    table, idx, weights, offsets, flat, _, _ = problem
    named = {
        "w": weights, "idx": idx, "flat": flat, "row": table[0],
        "float_idx": idx.astype(np.float32),
    }
    args = {"table": table, "indices": idx if kind == "fixed" else flat,
            "weights": None, "mode": "sum", "backend": "auto"}
    for k, v in overrides.items():
        args[k] = named.get(v, v) if k in ("weights", "indices", "table") else v
    return (
        to(args["table"]), to(args["indices"]),
        None if kind == "fixed" else to(offsets),
        None if args["weights"] is None else to(args["weights"]),
        args["mode"], args["backend"],
    )


@pytest.mark.parametrize("case", ERROR_CASES)
def test_validation_errors_match_jax(problem, case):
    kind, overrides, msg = ERROR_CASES[case]
    for pkg, to in (
        (jce, lambda a: jnp.asarray(a if a.dtype.kind == "f" else a.astype(np.int32))),
        (tce, torch.from_numpy),
    ):
        table, indices, offsets, weights, mode, backend = _error_args(
            problem, kind, overrides, to)
        kw = dict(mode=pkg.CombineMode(mode), backend=backend)
        with pytest.raises(ValueError, match=msg):
            if offsets is None:
                pkg.embedding_lookup(table, indices, weights, **kw)
            else:
                pkg.embedding_lookup_csr(table, indices, offsets, weights, **kw)


TIERED_CFG = tce.TieredConfig(hot_rows=64, chunk_elems=20, cold_slots=8,
                              mxu_head_rows=16, mid_slots=8)


def _jcfg(cfg):
    import dataclasses

    return jce.TieredConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("kw", [
    {"backend": "tiered"}, {"backend": "narrow"}, {"tiered_cfg": TIERED_CFG},
], ids=["tiered", "narrow", "tiered_cfg"])
def test_tpu_engines_not_ported(problem, kw):
    """The TPU engines' routes, which raised NotImplementedError before the
    port took them, now behave as the JAX dispatcher on the same input:
    "tiered" and "narrow" refuse this small table of width 24 (it fits the
    hot budget; 24 does not pack) with JAX's ValueErrors, and "tiered" with
    an explicit config, like a tiered_cfg under "auto", gives JAX's result."""
    table, idx, weights, offsets, flat, flat_w, _ = problem

    def calls(pkg, backend="auto", tiered_cfg=None):
        arr = jnp.asarray if pkg is jce else torch.from_numpy
        ids = _j if pkg is jce else torch.from_numpy
        cfg = _jcfg(tiered_cfg) if tiered_cfg is not None and pkg is jce else tiered_cfg
        kw = dict(backend=backend, tiered_cfg=cfg)
        return (lambda: pkg.embedding_lookup(arr(table), ids(idx), arr(weights), **kw),
                lambda: pkg.embedding_lookup_csr(arr(table), ids(flat), ids(offsets),
                                                 arr(flat_w), **kw))

    if "backend" in kw:
        msg = "fits the VMEM budget" if kw["backend"] == "tiered" else "needs width < 128"
        for pkg in (jce, tce):
            for call in calls(pkg, **kw):
                with pytest.raises(ValueError, match=msg):
                    call()
        if kw["backend"] == "narrow":
            return
        kw = dict(kw, tiered_cfg=TIERED_CFG)  # an explicit config makes "tiered" serve
    for want, got in zip(calls(jce, **kw), calls(tce, **kw)):
        np.testing.assert_allclose(got().numpy(), np.asarray(want()), rtol=1e-6, atol=1e-6)


def test_lookup_is_differentiable(problem):
    """A table (and weights) that require grad give an output that requires
    grad, and its backward fills their gradients; under no_grad the output
    has none."""
    table, idx, weights, _, _, _, _ = problem
    t = torch.from_numpy(table).requires_grad_()
    w = torch.from_numpy(weights).requires_grad_()
    i = torch.from_numpy(idx)
    out = tce.embedding_lookup(t, i, w)
    assert out.requires_grad
    out.sum().backward()
    assert t.grad is not None and t.grad.shape == t.shape
    assert w.grad is not None and w.grad.shape == w.shape
    # d(sum)/d table[r] counts the weighted lookups of r; d/d w is the row sum.
    want = torch.zeros_like(t.grad).index_add_(
        0, i.reshape(-1), w.detach().reshape(-1, 1).expand(-1, W).contiguous())
    torch.testing.assert_close(t.grad, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(w.grad, t.detach()[i].sum(-1), rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert not tce.embedding_lookup(t, i).requires_grad


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_fixed_matches_torch_embedding_bag(problem, mode):
    """torch's CPU EmbeddingBag sums in another order: float tolerance."""
    table, idx, _, _, _, _, _ = problem
    bag = torch.nn.EmbeddingBag(V, W, mode=mode)
    with torch.no_grad():
        bag.weight.copy_(torch.from_numpy(table))
        want = bag(torch.from_numpy(idx))
    got = tce.embedding_lookup(
        torch.from_numpy(table), torch.from_numpy(idx), mode=tce.CombineMode(mode))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_csr_weighted_matches_torch_embedding_bag(problem):
    table, _, _, offsets, flat, flat_w, _ = problem
    nnz = int(offsets[-1])
    want = torch.nn.functional.embedding_bag(
        torch.from_numpy(flat[:nnz]), torch.from_numpy(table),
        torch.from_numpy(offsets), mode="sum",
        per_sample_weights=torch.from_numpy(flat_w[:nnz]),
        include_last_offset=True,
    )
    got = tce.embedding_lookup_csr(
        torch.from_numpy(table), torch.from_numpy(flat),
        torch.from_numpy(offsets), torch.from_numpy(flat_w))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_kernel_wrappers_check_inputs(problem):
    """The raw wrappers raise on what the kernels do not take, on every
    device, before any compute."""
    table, idx, weights, offsets, flat, _, _ = problem
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_forward.embedding_forward_cuda(t.t().contiguous().t(), i)
    with pytest.raises(ValueError, match="float32"):
        cuda_forward.embedding_forward_cuda(t, i, torch.from_numpy(weights).double())
    with pytest.raises(ValueError, match="must match"):
        cuda_forward.embedding_forward_cuda(t, i, torch.ones(B, H + 1))
    with pytest.raises(ValueError, match="CONCAT"):
        cuda_forward.embedding_forward_cuda(t, i, mode=tce.CombineMode.CONCAT)
    with pytest.raises(ValueError, match="table must be"):
        cuda_forward.embedding_forward_cuda(t.double(), i)
    with pytest.raises(ValueError, match="offsets dtype"):
        cuda_forward.embedding_forward_cuda_csr(
            t, torch.from_numpy(flat), torch.from_numpy(offsets).float())
    with pytest.raises(ValueError, match="must be on"):
        cuda_forward.embedding_forward_cuda(t, i.to("meta"))


def test_api_makes_inputs_contiguous(problem):
    """The API hands the kernels contiguous fp32 weights: strided inputs and
    fp16 weights give the contiguous fp32 result."""
    table, idx, weights, _, _, _, _ = problem
    t = torch.from_numpy(table)
    t_strided = t.t().contiguous().t()
    i = torch.from_numpy(idx)
    i_strided = i.t().contiguous().t()
    w16 = torch.from_numpy(weights).half()
    got = tce.embedding_lookup(t_strided, i_strided, w16)
    assert torch.equal(got, tce.embedding_lookup(t, i, w16.float()))
