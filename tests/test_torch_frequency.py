"""The port's copy of ``utils/frequency.py`` against the JAX package's, from
the same numpy inputs. Counts, orders and capacities are integers, the
fractions and factors the same float arithmetic: compared exactly.
``reorder_table`` on a torch tensor gathers on its device and equals the
numpy gather.
"""

import numpy as np
import pytest
import torch

from cuembed_tpu.utils import frequency as jfreq
from cuembed_tpu_torch.utils import frequency as tfreq


def _ids(seed, shape=(64, 8), v=300):
    rng = np.random.default_rng(seed)
    u = rng.random(shape)
    return np.minimum((u ** 3 * v).astype(np.int64), v - 1).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_counts_decay_and_order(seed):
    ids = _ids(seed)
    for prior in (None, np.arange(300, dtype=np.int64)):
        got = tfreq.count_frequencies(ids, 300, prior)
        want = jfreq.count_frequencies(ids, 300, prior)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(tfreq.decay_counts(got, 0.7), jfreq.decay_counts(got, 0.7))
    for a, b in zip(tfreq.frequency_order(got), jfreq.frequency_order(got)):
        np.testing.assert_array_equal(a, b)
    for m in (tfreq, jfreq):
        with pytest.raises(ValueError, match="rate"):
            m.decay_counts(got, 1.5)


@pytest.mark.parametrize("remapped", [False, True])
def test_fractions_and_capacities(remapped):
    ids = _ids(2, (128, 16))
    remap = jfreq.frequency_order(jfreq.count_frequencies(ids, 300))[1] if remapped else None
    args = (ids, remap, 8, 64)
    assert tfreq.tier_fractions(*args) == jfreq.tier_fractions(*args)
    assert tfreq.tier_fractions(*args, margin=1.15) == jfreq.tier_fractions(*args, margin=1.15)
    assert (tfreq.calibrate_capacities(*args, 256)
            == jfreq.calibrate_capacities(*args, 256))
    assert tfreq.cold_fraction(ids, remap, 64) == jfreq.cold_fraction(ids, remap, 64)


def test_capacity_factor():
    counts = jfreq.count_frequencies(_ids(3, (256, 8)), 300)
    for shards in (1, 4):
        assert (tfreq.calibrate_capacity_factor(counts, shards, 64, 8, trials=20, seed=5)
                == jfreq.calibrate_capacity_factor(counts, shards, 64, 8, trials=20,
                                                   seed=5))
    with pytest.raises(ValueError, match="empty"):
        tfreq.calibrate_capacity_factor(np.zeros(10), 4, 8, 2)


def test_reorder_table_numpy_and_tensor():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((300, 8)).astype(np.float32)
    perm, _ = jfreq.frequency_order(jfreq.count_frequencies(_ids(4), 300))
    want = jfreq.reorder_table(table, perm)
    np.testing.assert_array_equal(tfreq.reorder_table(table, perm), want)
    got = tfreq.reorder_table(torch.from_numpy(table), perm)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
