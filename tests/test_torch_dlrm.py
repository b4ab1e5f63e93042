"""The port's DLRM (``cuembed_tpu_torch.models.DLRM``, an ``nn.Module``)
against ``cuembed_tpu.models.DLRM`` from the same numpy parameters
(``params_from_numpy`` of the JAX ``init``): the forward, the loss and one
``sgd_step`` (the JAX one with ``backend="xla"``), fused and per-table
storage, fp32 and bf16 tables.

The MLPs multiply bf16-rounded operands into fp32 products in both
packages, and their gradients round to bf16 in both; the sums run in
another order (XLA's dot against an fp32 matmul), so the floats are held to
a stated tolerance: logits and loss rtol = atol = 1e-5, parameters after
the step rtol = 1e-5, atol = 1e-6. A bf16 table after the step is held as
``chip_smoke.py::check_sparse_step`` holds one: one bf16 ulp of the result
plus one bf16 ulp of twice the step (the update rounds to bf16 before it
is added, and where it nearly cancels the old value one ulp of the update
is many of the result).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuembed_tpu.models import DLRM as JDLRM
from cuembed_tpu.models import DLRMConfig as JConfig
from cuembed_tpu.models.dlrm import _bce_with_logits, _mlp_apply

from cuembed_tpu_torch.models import DLRM, DLRMConfig
from cuembed_tpu_torch.models.dlrm import MLP, bce_with_logits, params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
BASE = dict(table_sizes=(500, 300, 700), embed_width=32, hotness=4, dense_features=8,
            bottom_mlp=(16, 32), top_mlp=(16, 8, 1))
B = 16


def _models(fused, dtype=torch.float32, seed=0):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    j = JDLRM(JConfig(**BASE, fused=fused, embed_dtype=jdt))
    jp = j.init(jax.random.key(seed))
    t = DLRM(DLRMConfig(**BASE, fused=fused, embed_dtype=dtype), device="cpu")
    params_from_numpy(t, jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)), jp))
    return t, j, jp


def _batch(seed):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((B, BASE["dense_features"])).astype(np.float32)
    sparse = [rng.integers(0, v, (B, BASE["hotness"])).astype(np.int32)
              for v in BASE["table_sizes"]]
    labels = rng.integers(0, 2, B).astype(np.float32)
    return dense, sparse, labels


def _tables(model):
    if model.fused_spec is not None:
        return model.tables.detach().float().numpy().copy()
    return np.concatenate([bag.weight.detach().float().numpy() for bag in model.bags])


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


def _check_bf16_step(got, want, old):
    step = np.maximum(np.abs(got - old), np.abs(want - old))
    bound = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + _bf16_ulp(2 * step)
    assert (np.abs(got - want) <= bound).all()


def _jtables(jp, width):
    t = jp["tables"]
    t = t if not isinstance(t, list) else jnp.concatenate(t)
    return np.asarray(t.astype(jnp.float32))[:, :width]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_loss_and_step_match_jax(fused, dtype):
    t, j, jp = _models(fused, dtype)
    np.testing.assert_array_equal(_tables(t), _jtables(jp, BASE["embed_width"]))
    dense, sparse, labels = _batch(1)
    td, ts, tl = (torch.from_numpy(dense), [torch.from_numpy(s) for s in sparse],
                  torch.from_numpy(labels))
    jd, js, jl = jnp.asarray(dense), [jnp.asarray(s) for s in sparse], jnp.asarray(labels)
    logits = t(td, ts)
    assert logits.shape == (B,) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(j.apply(jp, jd, js, backend="xla")), **TOL)
    np.testing.assert_allclose(t.loss(td, ts, tl).item(),
                               float(j.loss(jp, jd, js, jl, backend="xla")), **TOL)

    old = _tables(t)
    loss = t.sgd_step(td, ts, tl, lr=0.05)
    jp2, jloss = j.sgd_step(jp, jd, js, jl, lr=0.05, backend="xla")
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    new, want = _tables(t), _jtables(jp2, BASE["embed_width"])
    if dtype == torch.float32:
        np.testing.assert_allclose(new, want, **STEP_TOL)
    else:
        _check_bf16_step(new, want, old)
    assert (new != old).any()
    for mlp, layers in ((t.bottom, jp2["bottom"]), (t.top, jp2["top"])):
        for w, b, layer in zip(mlp.w, mlp.b, layers):
            np.testing.assert_allclose(w.detach().numpy(), np.asarray(layer["w"]),
                                       **STEP_TOL)
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(layer["b"]),
                                       **STEP_TOL)


def test_mlp_and_its_gradients_match_jax_bit_for_bit():
    """bf16 operands, fp32 products: the forward and the bf16-rounded
    gradients of a small tower equal XLA's on the CPU (no sum is long enough
    here for the order to show)."""
    rng = np.random.default_rng(0)
    dims = (8, 16, 32)
    layers = [{"w": rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32),
               "b": rng.standard_normal(dims[i + 1]).astype(np.float32)}
              for i in range(2)]
    x = rng.standard_normal((5, 8)).astype(np.float32)
    g_out = rng.standard_normal((5, 32)).astype(np.float32)
    jl = jax.tree_util.tree_map(jnp.asarray, layers)
    want = _mlp_apply(jl, jnp.asarray(x), final_linear=True)
    jg, jgx = jax.grad(lambda ls, x: jnp.sum(_mlp_apply(ls, x, final_linear=True) * g_out),
                       argnums=(0, 1))(jl, jnp.asarray(x))
    m = MLP(dims, device="cpu")
    m.load_numpy(layers)
    xt = torch.from_numpy(x).requires_grad_()
    out = m(xt, final_linear=True)
    (out * torch.from_numpy(g_out)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgx))
    for i in range(2):
        np.testing.assert_array_equal(m.w[i].grad.numpy(), np.asarray(jg[i]["w"]))
        np.testing.assert_array_equal(m.b[i].grad.numpy(), np.asarray(jg[i]["b"]))


def test_loss_formula_and_triu_order_match_jax():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal(64) * 30).astype(np.float32)
    labels = rng.integers(0, 2, 64).astype(np.float32)
    np.testing.assert_allclose(
        bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(_bce_with_logits(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6, atol=1e-7)
    for f in (2, 5, 9):
        iu, ju = jnp.triu_indices(f, k=1)
        tu = torch.triu_indices(f, f, 1)
        np.testing.assert_array_equal(tu[0].numpy(), np.asarray(iu))
        np.testing.assert_array_equal(tu[1].numpy(), np.asarray(ju))


def test_padded_jax_tables_load_and_errors():
    """The JAX per-table model stores lane-padded tables ([V, 128] for width
    32); their zero columns are dropped on the way in."""
    t, j, jp = _models(False)
    assert jp["tables"][0].shape[1] == 128
    assert t.bags[0].weight.shape == (500, 32)
    with pytest.raises(ValueError, match="embed_width"):
        DLRM(DLRMConfig(**{**BASE, "bottom_mlp": (16, 8)}), device="cpu")
    with pytest.raises(ValueError, match="layers"):
        t.bottom.load_numpy([])
    assert DLRMConfig().num_tables == 8


def test_step_on_a_default_module_moves_every_parameter():
    t = DLRM(DLRMConfig(**BASE, fused=True), device="cpu")
    t.reset_parameters(torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in t.parameters()]
    dense, sparse, labels = _batch(3)
    loss = t.sgd_step(torch.from_numpy(dense), [torch.from_numpy(s) for s in sparse],
                      torch.from_numpy(labels), lr=0.1)
    assert torch.isfinite(loss)
    assert all(not torch.equal(a, p) for a, p in zip(before, t.parameters()))


def test_trainer_runs_on_the_cpu(capsys):
    """examples/train_dlrm_torch.py end to end at a small size on the CPU:
    collection, reorder, the pipeline's remap, the dense towers by autograd
    and sparse AdaGrad on the tables."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / "train_dlrm_torch.py"
    spec = importlib.util.spec_from_file_location("train_dlrm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rate = mod.main(["--steps", "7", "--batch", "64", "--categories", "2000",
                     "--tables", "3", "--width", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rate > 0 and "examples/s" in out and "native host library" in out
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and np.isfinite(losses).all()
