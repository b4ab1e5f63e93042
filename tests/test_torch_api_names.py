"""The JAX package's small public names on the port, each against its JAX
counterpart: ``types.canonical_index_dtype``,
``ops.dispatch.pallas_forward_supported``, ``LANES``,
``EmbeddingBag.stored_width``; and the functional ``init``/``apply`` of
``EmbeddingBag``, ``QREmbeddingBag`` and ``DLRM``, whose counterpart is
``torch.func.functional_call`` over the parameters the numpy converters
carry across.

Where the port differs by design the test says how: int64 indices stay
int64 (the kernels take both index types, the TPU narrows to int32), K1
and K2 serve every width and fp16 (the Pallas forward takes widths that are
multiples of 128 lanes in fp32 and bf16), and the port stores no lane
padding. ``functional_call`` runs the module on parameters passed in, as
``apply`` does; it is held to ``apply`` at rtol = atol = 1e-5, the
tolerance of ``tests/test_torch_dlrm.py`` (the sums run in another order).
"""

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp

import cuembed_tpu as jce
from cuembed_tpu.models import DLRM as JDLRM
from cuembed_tpu.models import DLRMConfig as JConfig
from cuembed_tpu.models import QREmbeddingBag as JQR
from cuembed_tpu.models import embedding_bag as jbag_mod
from cuembed_tpu.ops import dispatch as jdispatch
from cuembed_tpu.types import canonical_index_dtype as j_canonical

import cuembed_tpu_torch as tce
from cuembed_tpu_torch.models import DLRM, DLRMConfig, QREmbeddingBag
from cuembed_tpu_torch.models import embedding_bag as tbag_mod
from cuembed_tpu_torch.models.dlrm import params_from_numpy
from cuembed_tpu_torch.ops import dispatch as tdispatch
from cuembed_tpu_torch.types import canonical_index_dtype
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("given", ["np32", "np64", "str32", "str64", "arr32", "arr64",
                                   "torch32", "torch64", "tensor64"])
@pytest.mark.parametrize("num_categories", [None, 1000, 2**31])
def test_canonical_index_dtype_against_jax(given, num_categories):
    """int32 stays int32 in both. int64 stays int64 here; JAX narrows it to
    int32 below 2**31 rows and keeps it from there."""
    wide = given.endswith("64")
    np_dt = np.int64 if wide else np.int32
    arg = {"np": np_dt, "str": np.dtype(np_dt).name, "arr": np.zeros(3, np_dt),
           "torch": torch.int64 if wide else torch.int32,
           "tensor": torch.zeros(3, dtype=torch.int64)}[given[:-2]]
    got = canonical_index_dtype(arg, num_categories)
    assert got == (torch.int64 if wide else torch.int32)
    if given[:-2] in ("np", "str", "arr"):
        want = np.dtype(j_canonical(arg, num_categories))
        jax_narrows = wide and (num_categories is None or num_categories < 2**31)
        assert want == (np.dtype(np.int32) if jax_narrows else np.dtype(np_dt))


@pytest.mark.parametrize("bad", [np.int16, "float32", torch.float32, np.zeros(2, np.uint8)])
def test_canonical_index_dtype_refuses_as_jax(bad):
    with pytest.raises(ValueError, match="unsupported index dtype"):
        canonical_index_dtype(bad)
    if not isinstance(bad, torch.dtype):
        with pytest.raises(ValueError, match="unsupported index dtype"):
            j_canonical(bad)


@pytest.mark.parametrize("width", [8, 32, 100, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("mode", ["sum", "mean", "concat"])
@pytest.mark.parametrize("csr", [False, True])
def test_pallas_forward_supported_against_jax(width, dtype, mode, csr):
    """Every call JAX's Pallas forward covers, K1 or K2 covers; they also
    cover fp16 and every width. CONCAT is covered by neither."""
    table = np.zeros((16, width), np.float32)
    idx = np.zeros(12 if csr else (4, 3), np.int32)
    offsets = np.array([0, 3, 6, 9, 12], np.int32) if csr else None
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    got = tdispatch.pallas_forward_supported(
        tt, torch.from_numpy(idx), None if offsets is None else torch.from_numpy(offsets),
        None, tce.CombineMode(mode))
    want = jdispatch.pallas_forward_supported(
        jnp.asarray(table).astype(getattr(jnp, dtype)), jnp.asarray(idx),
        None if offsets is None else jnp.asarray(offsets), None, jce.CombineMode(mode))
    assert got == (mode != "concat")
    if want:
        assert got


def test_lanes_match_jax():
    assert tdispatch.LANES == jdispatch.LANES == 128
    assert tbag_mod.LANES == jbag_mod.LANES == 128


@pytest.mark.parametrize("layout", ["padded", "packed", "raw"])
@pytest.mark.parametrize("width", [16, 32, 100, 128, 256])
def test_stored_width_against_jax(layout, width):
    """The width of a stored logical row: JAX's wherever it pads nothing
    (packed, raw, and padded widths that are multiples of 128); JAX pads
    other padded widths to 128 lanes, the port does not."""
    got = tce.EmbeddingBag(10, width, layout=layout, device="cpu").stored_width
    want = jbag_mod.EmbeddingBag(10, width, layout=layout).stored_width
    assert got == width
    if layout != "padded" or width % 128 == 0:
        assert got == want
    else:
        assert want == -(-width // 128) * 128


# -- init/apply: functional_call over the carried parameters ----------------------

def _params(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


@pytest.mark.parametrize("layout", ["padded", "packed"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_functional_call_matches_apply(layout, mode):
    """``apply(table, ...)`` of two JAX inits against ``functional_call`` of
    one module on the parameters carried across from each."""
    rng = np.random.default_rng(41)
    v, width, b, h = 300, 32, 16, 5
    jbag = jbag_mod.EmbeddingBag(v, width, mode=jce.CombineMode(mode), layout=layout)
    bag = tce.EmbeddingBag(v, width, mode=tce.CombineMode(mode), layout=layout,
                           device="cpu")
    idx = rng.integers(0, v, (b, h)).astype(np.int32)
    for seed in (0, 1):
        stored = jbag.init(jax.random.key(seed))
        other = tce.EmbeddingBag(v, width, mode=tce.CombineMode(mode), layout=layout,
                                 device="cpu")
        other.import_table(np.asarray(stored) if layout == "packed"
                           else jbag.export_table(stored))
        got = functional_call(bag, _params(other), (torch.from_numpy(idx),))
        want = jbag.apply(stored, jnp.asarray(idx))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("operation", ["add", "mult"])
def test_qr_embedding_functional_call_matches_apply(operation):
    rng = np.random.default_rng(42)
    v, width, q, b, h = 1000, 16, 37, 24, 4
    j = JQR(v, width, q, operation=operation)
    t = QREmbeddingBag(v, width, q, operation=operation, device="cpu")
    idx = rng.integers(0, v, (b, h)).astype(np.int32)
    for seed in (0, 1):
        jp = j.init(jax.random.key(seed))
        other = QREmbeddingBag(v, width, q, operation=operation, device="cpu")
        other.import_params(jax.tree_util.tree_map(np.asarray, jp))
        got = functional_call(t, _params(other), (torch.from_numpy(idx),))
        want = j.apply(jp, jnp.asarray(idx))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_dlrm_functional_call_matches_apply(fused):
    base = dict(table_sizes=(500, 300, 700), embed_width=32, hotness=4, dense_features=8,
                bottom_mlp=(16, 32), top_mlp=(16, 8, 1))
    rng = np.random.default_rng(43)
    bsz = 16
    dense = rng.standard_normal((bsz, base["dense_features"])).astype(np.float32)
    sparse = [rng.integers(0, n, (bsz, base["hotness"])).astype(np.int32)
              for n in base["table_sizes"]]
    j = JDLRM(JConfig(**base, fused=fused))
    t = DLRM(DLRMConfig(**base, fused=fused), device="cpu")
    for seed in (0, 1):
        jp = j.init(jax.random.key(seed))
        other = DLRM(DLRMConfig(**base, fused=fused), device="cpu")
        params_from_numpy(other, jax.tree_util.tree_map(
            lambda x: np.asarray(x.astype(jnp.float32)), jp))
        got = functional_call(t, _params(other), (torch.from_numpy(dense),
                                                  [torch.from_numpy(s) for s in sparse]))
        want = j.apply(jp, jnp.asarray(dense), [jnp.asarray(s) for s in sparse],
                       backend="xla")
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
