"""The inputs made from the seed: the power law against a frozen copy of
upstream's ``translateToPowerLaw`` (as ``cuembed_tpu_torch/utils/datagen.py``
has it), ids distinct within a sample and in range, and tables drawn again
chunk by chunk equal to the first draw."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import gen


def translate_to_power_law(min_value, max_value, alpha, u):
    """Frozen copy of ``datagen.translate_to_power_law``."""
    if alpha == 1.0:
        return min_value * (max_value / min_value) ** u
    gamma = 1.0 - alpha
    return (u * (max_value**gamma - min_value**gamma) + min_value**gamma) ** (1.0 / gamma)


@pytest.mark.parametrize("alpha", [0.5, 1.0, 1.05, 1.15, 2.0])
def test_power_law_is_upstreams(alpha):
    u = np.random.default_rng(0).random(1000)
    want = translate_to_power_law(1.0, 10001.0, alpha, u)
    got = gen.power_law(torch.from_numpy(u), 1.0, 10001.0, alpha).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("rows,hotness,alpha", [(5000, 64, 1.15), (3, 1, 1.05), (155, 5, 1.05),
                                                (2209, 6, 0.0), (70, 60, 1.05)])
def test_bags_distinct_in_range_sorted(rows, hotness, alpha):
    g = gen.generator("cpu", 2**40 + 1, "ids", 0)
    ids = gen.bags(g, rows, 300, hotness, alpha)
    assert ids.shape == (300, hotness) and ids.dtype == torch.int64
    assert int(ids.min()) >= 0 and int(ids.max()) < rows
    assert bool((ids[:, 1:] > ids[:, :-1]).all())  # sorted and distinct


def test_bags_follow_the_law():
    """Unpermuted draws at alpha 1.15: the share of id 1 is the law's."""
    g = gen.generator("cpu", 7, "ids", 0)
    ids = gen.bags(g, 10_001, 20_000, 1, 1.15, permute=False)
    u_hi = ((2.0 ** -0.15 - 1.0) / (10_001 ** -0.15 - 1.0))  # u below which floor(y) == 1
    share = float((ids == 1).double().mean())
    assert abs(share - u_hi) < 4 * (u_hi * (1 - u_hi) / 20_000) ** 0.5


def test_same_seed_same_draws_other_seed_other_draws():
    a = gen.bags(gen.generator("cpu", 11, "ids", 2), 1000, 50, 8, 1.05)
    b = gen.bags(gen.generator("cpu", 11, "ids", 2), 1000, 50, 8, 1.05)
    c = gen.bags(gen.generator("cpu", 12, "ids", 2), 1000, 50, 8, 1.05)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_table_rows_drawn_again(monkeypatch):
    monkeypatch.setattr(gen, "CHUNK_ROWS", 64)
    t = gen.table(5, 3, 300, 16, torch.float16, "cpu")
    rows = torch.tensor([0, 63, 64, 65, 200, 299, 7])
    assert torch.equal(gen.table_rows(5, 3, 300, 16, torch.float16, "cpu", rows), t[rows])
    assert float(t.abs().max()) <= 0.25


def test_sizes_same_set_every_seed():
    a = gen.sizes({"uniform": [100, 700]}, 256, torch.Generator().manual_seed(1))
    b = gen.sizes({"uniform": [100, 700]}, 256, torch.Generator().manual_seed(2))
    assert sorted(a) == sorted(b) and a != b
    assert min(a) >= 100 and max(a) <= 700
    assert gen.sizes({"fixed": 65536}, 3, torch.Generator()) == [65536] * 3


def test_subseed_takes_large_seeds():
    assert 0 <= gen.subseed(2**63 + 5, "x") < 2**63
    assert gen.subseed(1, "a", 0) != gen.subseed(1, "a", 1)
