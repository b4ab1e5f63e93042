"""The port's chained timers and probes (``cuembed_tpu_torch.utils.benchmarking``)
against ``cuembed_tpu.utils.benchmarking``, on the CPU: ``tests/test_timing.py``
on the port.

The probes take the same numpy inputs in both packages: ``opaque_bump`` and
``bump_from`` are equal; ``carry_probe`` sums squares in fp32 in another
order (a dot product against XLA's reduction), so it is held to n fp32
ulps of the sum over n elements (each partial sum rounds once). The
timers' contracts: signatures and defaults as JAX's, positive slopes, the
statistics dict; ``fori_chain_time`` raises for CPU tensors (the graph chain
needs the card; its timings are in ``tests/test_torch_cuda.py``) after the
JAX version's ``ValueError`` without a float leaf.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuembed_tpu.utils import benchmarking as jb

from cuembed_tpu_torch.utils import benchmarking as tb

TIMERS = ["chain_time", "fori_chain_time", "robust_chain_time", "opaque_bump",
          "bump_from", "carry_probe", "full_carry_x0"]


@pytest.mark.parametrize("name", TIMERS)
def test_signature_matches_jax(name):
    got = inspect.signature(getattr(tb, name)).parameters
    want = inspect.signature(getattr(jb, name)).parameters
    assert [(p.name, p.kind, p.default) for p in got.values()] == \
        [(p.name, p.kind, p.default) for p in want.values()]
    assert tb.DEGENERATE_SLOPE_S == jb.DEGENERATE_SLOPE_S


@pytest.mark.parametrize("dtype", ["float32", "float16", "int32"])
def test_opaque_bump_matches_jax(dtype):
    vals = np.array([0.0, 3.0, -1e30, 1e20, 2.9e38, 3.1e38, np.inf, np.nan], np.float64)
    if dtype == "int32":
        vals = np.array([0, 3, -7, 2**31 - 1], np.int64)
    for v in vals:
        with np.errstate(over="ignore"):  # 2.9e38 and up are inf in fp16
            a = np.asarray(v).astype(dtype)
        got = tb.opaque_bump(torch.from_numpy(a))
        want = jb.opaque_bump(jnp.asarray(a))
        assert got.dtype == torch.int32 and int(got) == int(want), v


def test_bump_from_accepts_scalar_and_array():
    for a in (np.float32(2.0), np.zeros((4, 8), np.float32),
              np.full((3,), 3.2e38, np.float32), np.zeros((2, 2), np.int32)):
        got = tb.bump_from(torch.from_numpy(np.asarray(a)))
        assert got.shape == () and int(got) == int(jb.bump_from(jnp.asarray(a)))


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "int32"])
def test_carry_probe_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((37, 53)).astype(np.float32)
    if dtype == "int32":
        x = rng.integers(-9, 10, (37, 53)).astype(np.int32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    # the same rounded values in both packages
    x = tx.float().numpy() if dtype != "int32" else x
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got, want = tb.carry_probe(tx), jb.carry_probe(jx)
    assert got.dtype == torch.float32 and got.shape == ()
    exact = float(np.sum(x.astype(np.float64) ** 2))
    bound = x.size * exact * 2.0**-24
    assert abs(float(got) - float(want)) <= 2 * bound
    assert abs(float(got) - exact) <= bound


def test_carry_probe_scatter_not_eliminated():
    upd = torch.ones((6, 4))
    rows = torch.tensor([0, 0, 1, 2, 2, 2])
    g = torch.zeros((4, 4)).index_add_(0, rows, upd)
    assert float(tb.carry_probe(g)) == 56.0 == float(
        jb.carry_probe(jnp.zeros((4, 4)).at[jnp.asarray(rows.numpy())].add(1.0)))


def test_carry_probe_scalar_and_pytree():
    p = tb.carry_probe(torch.ones((8, 16), dtype=torch.bfloat16))
    assert p.shape == () and p.dtype == torch.float32 and float(p) == 128.0
    p2 = tb.carry_probe((torch.full((4,), 7, dtype=torch.int32), torch.ones((2,))))
    assert float(p2) == 4 * 49 + 2 == float(
        jb.carry_probe((jnp.full((4,), 7, jnp.int32), jnp.ones((2,)))))


def test_full_carry_x0_discovers_output_shape():
    table = torch.ones((100, 32), dtype=torch.bfloat16)
    idx = torch.zeros((16,), dtype=torch.int64)

    def step(c, table, idx):
        i, dep = c
        return (i + 1, table[idx + tb.bump_from(dep)])

    x0 = tb.full_carry_x0(step, table, idx)
    assert x0[0].dtype == torch.int32 and int(x0[0]) == 0
    assert x0[1].shape == (16, 32) and x0[1].dtype == torch.bfloat16
    assert not x0[1].any()


def test_chain_time_basic():
    dt = tb.chain_time(lambda x: x + 1.0, torch.tensor(0.0), k_lo=1, k_hi=4, repeats=2)
    assert isinstance(dt, float) and dt > 0
    st = tb.chain_time(lambda x: x + 1.0, torch.tensor(0.0), k_lo=1, k_hi=4, repeats=2,
                       return_stats=True)
    assert set(st) == {"min", "median", "max", "degenerate"}
    assert all(v > 0 for k, v in st.items() if k != "degenerate")


def test_chain_time_threads_the_state():
    """The state never resets: warm-up, then repeats of k_lo and k_hi steps."""
    calls = []

    def step(x):
        calls.append(float(x))
        return x + 1.0

    tb.chain_time(step, torch.tensor(0.0), k_lo=1, k_hi=3, repeats=2)
    assert calls == [float(i) for i in range(2 + 2 * 1 + 2 * 3)]


def test_fori_chain_time_requires_float_leaf():
    with pytest.raises(ValueError, match="float leaf"):
        tb.fori_chain_time(lambda c: c + 1, torch.tensor(0, dtype=torch.int32), k_lo=1,
                           k_hi=2)
    with pytest.raises(ValueError, match="float leaf"):
        jb.fori_chain_time(lambda c: c + 1, jnp.int32(0), k_lo=1, k_hi=2)


def test_fori_chain_time_refuses_cpu_tensors():
    """No quiet CPU loop stands in for the graph chain."""
    table = torch.ones((512, 64))
    idx = torch.arange(128) % 512

    def step(c, table, idx):
        i, dep = c
        return (i + 1, tb.carry_probe(table[idx + tb.bump_from(dep)]))

    x0 = (torch.tensor(0, dtype=torch.int32), torch.tensor(0.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.fori_chain_time(step, x0, operands=(table, idx), k_lo=2, k_hi=8, repeats=2)


def test_robust_chain_time_matches_chain_time_contract():
    def step(c, v):
        i, dep = c
        return (i + 1, v * 1.0 + tb.bump_from(dep))

    v = torch.ones((64,))
    x0 = (torch.tensor(0, dtype=torch.int32), torch.zeros((64,)))
    r = tb.robust_chain_time(step, x0, operands=(v,), k_lo=1, k_hi=4, repeats=2,
                             return_stats=True)
    assert r["min"] > 0 and r["max"] > 0 and r["median"] > 0
    assert "degenerate" in r
    s = tb.robust_chain_time(step, x0, operands=(v,), k_lo=1, k_hi=4, repeats=2)
    assert isinstance(s, float)
