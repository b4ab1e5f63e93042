"""The port's fused table groups (``cuembed_tpu_torch.fused``) against
``cuembed_tpu.fused`` and against the port's own per-table calls.

Fusion must be invisible: every pooled output and every sparse update
equals the per-table result. Under SUM with one hotness the fused lookup
passes no coefficients, so it equals the per-table lookups bit for bit on
any data; elsewhere (MEAN, mixed hotness, weights) the JAX tests' rtol =
atol = 1e-6 for lookups and 1e-5 / 1e-6 for updates. Against the JAX
functions the same inputs give the same results: integer-valued tables
bit for bit, random reals within those tolerances. The last case is the
JAX suite's ``test_dlrm_fused_matches_unfused``: the fused DLRM equals the
per-table one, and its train step moves the one fused table.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuembed_tpu as jce
from cuembed_tpu.types import CombineMode as JMode
from cuembed_tpu.utils.frequency import frequency_order

import cuembed_tpu_torch as tce

TOL = dict(rtol=1e-6, atol=1e-6)
UPD_TOL = dict(rtol=1e-5, atol=1e-6)


def _group(rng, sizes, hotness, width=16, batch=32, integer=False):
    names = [f"t{i}" for i in range(len(sizes))]
    tables = {n: (rng.integers(-8, 9, (v, width)) if integer
                  else rng.standard_normal((v, width))).astype(np.float32)
              for n, v in zip(names, sizes)}
    hot = dict(zip(names, hotness))
    idx = {n: rng.integers(0, v, (batch, hot[n])).astype(np.int32)
           for n, v in zip(names, sizes)}
    return names, tables, hot, idx


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def test_fuse_roundtrip_and_spec_match_jax():
    rng = np.random.default_rng(0)
    names, tables, hot, _ = _group(rng, [64, 128, 32], [4, 4, 4])
    fused, spec = tce.fuse_tables(_t(tables), hot)
    jfused, jspec = jce.fuse_tables(_j(tables), hot)
    np.testing.assert_array_equal(fused.numpy(), np.asarray(jfused))
    assert (spec.names, spec.bases, spec.sizes, spec.hotness, spec.width,
            spec.total_rows) == (jspec.names, jspec.bases, jspec.sizes, jspec.hotness,
                                 jspec.width, jspec.total_rows)
    assert spec.base_of("t1") == 64
    back = tce.unfuse_table(fused, spec)
    for n in names:
        np.testing.assert_array_equal(back[n].numpy(), tables[n])
    counts = {n: np.bincount(idx, minlength=0) for n, idx in
              zip(names, (np.arange(10), np.arange(200) % 7, np.arange(3)))}
    np.testing.assert_array_equal(tce.fuse_counts(spec, counts),
                                  jce.fuse_counts(jspec, counts))


def test_fuse_errors_match_jax():
    for fuse, lib in ((tce.fuse_tables, torch.zeros), (jce.fuse_tables, jnp.zeros)):
        with pytest.raises(ValueError, match="width"):
            fuse({"a": lib((8, 16)), "b": lib((8, 32))}, {"a": 1, "b": 1})
        with pytest.raises(ValueError, match="nothing"):
            fuse({}, {})
    rng = np.random.default_rng(4)
    _, tables, hot, idx = _group(rng, [64], [4])
    fused, spec = tce.fuse_tables(_t(tables), hot)
    with pytest.raises(ValueError, match="CONCAT"):
        tce.fused_lookup(fused, spec, _t(idx), mode=tce.CombineMode.CONCAT)
    with pytest.raises(ValueError, match="CombineMode.SUM"):
        tce.fused_lookup(fused, spec, _t(idx), _t({"t0": np.ones((32, 4), np.float32)}),
                         mode=tce.CombineMode.MEAN)
    with pytest.raises(ValueError, match="expected indices"):
        tce.fused_lookup(fused, spec, {"t0": torch.zeros((32, 3), dtype=torch.int32)})


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("hotness", [(4, 4, 4), (4, 2, 7)])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "real"])
def test_fused_lookup_matches_per_table_and_jax(mode, hotness, integer):
    rng = np.random.default_rng(2)
    names, tables, hot, idx = _group(rng, [64, 128, 32], hotness, integer=integer)
    fused, spec = tce.fuse_tables(_t(tables), hot)
    m = tce.CombineMode(mode)
    got = tce.fused_lookup(fused, spec, _t(idx), mode=m)
    jfused, jspec = jce.fuse_tables(_j(tables), hot)
    want = jce.fused_lookup(jfused, jspec, _j(idx), mode=JMode(mode), backend="xla")
    one_launch = mode == "sum" and len(set(hotness)) == 1
    # Integer tables keep exact sums unless MEAN's 1/7 rounds each product.
    exact = integer and (mode == "sum" or 7 not in hotness)
    for n in names:
        per_table = tce.embedding_lookup(torch.from_numpy(tables[n]),
                                         torch.from_numpy(idx[n]), mode=m)
        if one_launch:
            assert torch.equal(got[n], per_table), n
        else:
            np.testing.assert_allclose(got[n].numpy(), per_table.numpy(), err_msg=n, **TOL)
        if exact:
            np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]), err_msg=n)
        else:
            np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), err_msg=n,
                                       **TOL)


def test_fused_lookup_weighted_matches_jax():
    rng = np.random.default_rng(3)
    names, tables, hot, idx = _group(rng, [64, 32], [4, 3])
    w = {n: rng.standard_normal(idx[n].shape).astype(np.float32) for n in names}
    fused, spec = tce.fuse_tables(_t(tables), hot)
    got = tce.fused_lookup(fused, spec, _t(idx), _t(w))
    jf, js = jce.fuse_tables(_j(tables), hot)
    want = jce.fused_lookup(jf, js, _j(idx), _j(w), backend="xla")
    for n in names:
        per_table = tce.embedding_lookup(torch.from_numpy(tables[n]),
                                         torch.from_numpy(idx[n]), torch.from_numpy(w[n]))
        np.testing.assert_allclose(got[n].numpy(), per_table.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_fused_updates_match_per_table_and_jax(mode):
    rng = np.random.default_rng(5)
    names, tables, hot, idx = _group(rng, [64, 128], [4, 2], batch=16)
    gys = {n: rng.standard_normal((16, 16)).astype(np.float32) for n in names}
    m = tce.CombineMode(mode)
    fused, spec = tce.fuse_tables(_t(tables), hot)
    jf, js = jce.fuse_tables(_j(tables), hot)
    new = tce.fused_sgd_update(fused.clone(), spec, _t(idx), _t(gys), lr=0.1, mode=m)
    want = jce.fused_sgd_update(jf, js, _j(idx), _j(gys), lr=0.1, mode=JMode(mode))
    np.testing.assert_allclose(new.numpy(), np.asarray(want), **UPD_TOL)
    for n, part in tce.unfuse_table(new, spec).items():
        per = tce.sgd_sparse_update(torch.from_numpy(tables[n].copy()),
                                    torch.from_numpy(idx[n]), torch.from_numpy(gys[n]),
                                    lr=0.1, mode=m)
        np.testing.assert_allclose(part.numpy(), per.numpy(), err_msg=n, **UPD_TOL)

    accum = torch.zeros(spec.total_rows)
    nt, na = tce.fused_adagrad_update(fused.clone(), accum, spec, _t(idx), _t(gys),
                                      lr=0.1, mode=m)
    assert na is accum
    wt, wa = jce.fused_adagrad_update(jf, jnp.zeros((js.total_rows,), jnp.float32), js,
                                      _j(idx), _j(gys), lr=0.1, mode=JMode(mode))
    np.testing.assert_allclose(nt.numpy(), np.asarray(wt), **UPD_TOL)
    np.testing.assert_allclose(na.numpy(), np.asarray(wa), **UPD_TOL)
    for n, b, s in zip(spec.names, spec.bases, spec.sizes):
        pt, pa = tce.rowwise_adagrad_sparse_update(
            torch.from_numpy(tables[n].copy()), torch.zeros(s), torch.from_numpy(idx[n]),
            torch.from_numpy(gys[n]), lr=0.1, mode=m)
        np.testing.assert_allclose(nt[b:b + s].numpy(), pt.numpy(), err_msg=n, **UPD_TOL)
        np.testing.assert_allclose(na[b:b + s].numpy(), pa.numpy(), err_msg=n, **UPD_TOL)


def test_fused_remap_invisible():
    """A frequency reorder of the fused table and its remap leave every
    pooled output unchanged, bit for bit, and equal to JAX's."""
    rng = np.random.default_rng(7)
    names, tables, hot, idx = _group(rng, [64, 32], [4, 4])
    fused, spec = tce.fuse_tables(_t(tables), hot)
    counts = {n: np.bincount(idx[n].reshape(-1), minlength=v).astype(np.int64)
              for n, v in zip(names, (64, 32))}
    perm, remap = frequency_order(tce.fuse_counts(spec, counts))
    reordered = fused[torch.from_numpy(perm).long()]
    base = tce.fused_lookup(fused, spec, _t(idx))
    got = tce.fused_lookup(reordered, spec, _t(idx), remap=torch.from_numpy(remap))
    jf, js = jce.fuse_tables(_j(tables), hot)
    want = jce.fused_lookup(jnp.asarray(np.asarray(jf)[perm]), js, _j(idx),
                            remap=jnp.asarray(remap), backend="xla")
    for n in names:
        assert torch.equal(got[n], base[n]), n
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), **TOL)
    gys = {n: torch.randn(32, 16) for n in names}
    a = tce.fused_sgd_update(fused.clone(), spec, _t(idx), gys, lr=0.1)
    b = tce.fused_sgd_update(reordered.clone(), spec, _t(idx), gys, lr=0.1,
                             remap=torch.from_numpy(remap))
    assert torch.equal(a[torch.from_numpy(perm).long()], b)


def test_fused_lookup_is_differentiable():
    rng = np.random.default_rng(8)
    names, tables, hot, idx = _group(rng, [64, 32], [4, 4], batch=8)
    fused, spec = tce.fuse_tables(_t(tables), hot)
    fused.requires_grad_()
    out = tce.fused_lookup(fused, spec, _t(idx))
    sum((o ** 2).sum() for o in out.values()).backward()
    g = fused.grad
    assert g.shape == fused.shape and torch.isfinite(g).all()
    touched = np.zeros(spec.total_rows, bool)
    for n, b in zip(spec.names, spec.bases):
        touched[idx[n].reshape(-1) + b] = True
    assert not g[torch.from_numpy(~touched)].any()
    jf, js = jce.fuse_tables(_j(tables), hot)
    import jax

    want = jax.grad(lambda f: sum(jnp.sum(o ** 2) for o in jce.fused_lookup(
        f, js, _j(idx), backend="xla").values()))(jf)
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_dlrm_fused_matches_unfused():
    """The JAX suite's case (tests/test_fused.py): DLRM(fused=True) from the
    same parameters equals the per-table model, and a train step flows
    gradients into the single fused table; here both against the JAX
    models from the same numpy parameters too."""
    import jax

    from cuembed_tpu.models import DLRM as JDLRM
    from cuembed_tpu.models import DLRMConfig as JConfig
    from cuembed_tpu_torch.models import DLRM, DLRMConfig
    from cuembed_tpu_torch.models.dlrm import params_from_numpy

    rng = np.random.default_rng(9)
    base = dict(table_sizes=(500, 300, 700), embed_width=32, hotness=4,
                dense_features=8, bottom_mlp=(16, 32), top_mlp=(16, 1))
    j1 = JDLRM(JConfig(**base, fused=True))
    jp1 = j1.init(jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, jp1)
    m0 = DLRM(DLRMConfig(**base), device="cpu")
    m1 = DLRM(DLRMConfig(**base, fused=True), device="cpu")
    params_from_numpy(m0, params)  # one fused array into per-table storage
    params_from_numpy(m1, params)
    np.testing.assert_array_equal(
        torch.cat([bag.weight.detach() for bag in m0.bags]).numpy(),
        m1.tables.detach().numpy())
    B = 16
    dense = rng.standard_normal((B, 8)).astype(np.float32)
    sparse = [rng.integers(0, v, (B, 4)).astype(np.int32) for v in base["table_sizes"]]
    td, ts = torch.from_numpy(dense), [torch.from_numpy(s) for s in sparse]
    out0, out1 = m0(td, ts), m1(td, ts)
    assert torch.equal(out0, out1)  # SUM, one hotness: the same sums
    want = j1.apply(jp1, jnp.asarray(dense), [jnp.asarray(s) for s in sparse],
                    backend="xla")
    np.testing.assert_allclose(out1.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    labels = rng.integers(0, 2, B).astype(np.float32)
    before = m1.tables.detach().clone()
    loss = m1.sgd_step(td, ts, torch.from_numpy(labels))
    assert torch.isfinite(loss)
    assert not torch.equal(m1.tables.detach(), before)
    loss0 = m0.sgd_step(td, ts, torch.from_numpy(labels))
    assert torch.equal(loss0, loss)
    np.testing.assert_allclose(
        torch.cat([bag.weight.detach() for bag in m0.bags]).numpy(),
        m1.tables.detach().numpy(), rtol=1e-6, atol=1e-7)


def test_spec_from_sizes_is_the_fused_layout():
    """``FusedSpec.from_sizes`` is the layout ``fuse_tables`` and the fused
    DLRM build, and the JAX ``fuse_tables``'s."""
    rng = np.random.default_rng(7)
    names, tables, hot, _ = _group(rng, [48, 16, 80], [3, 3, 3])
    _, spec = tce.fuse_tables(_t(tables), hot)
    _, jspec = jce.fuse_tables(_j(tables), hot)
    got = tce.FusedSpec.from_sizes(names, [48, 16, 80], [3, 3, 3], 16)
    assert got == spec
    assert (got.bases, got.total_rows) == (jspec.bases, jspec.total_rows)
    cfg = tce.models.DLRMConfig(table_sizes=(48, 16, 80), embed_width=16, hotness=3,
                                bottom_mlp=(8, 16), top_mlp=(8, 1), fused=True)
    m = tce.models.DLRM(cfg, device="cpu")
    assert m.fused_spec == got
    assert m.tables.shape == (got.total_rows, 16)
