"""The port's ``utils/calibration.py`` against the JAX package's: the same
arguments give the same ``TieredConfig`` (field for field) and the same
remap and remapped ids. Both bindings take the same branch of
``calibrate_powerlaw_workload`` (``native.AVAILABLE`` is equal in both
packages); here the library is not built, so it is the numpy branch.
"""

import dataclasses

import numpy as np
import pytest

from cuembed_tpu import native as jnative
from cuembed_tpu.ops.tiered import auto_config as jauto
from cuembed_tpu.utils import calibration as jcal
from cuembed_tpu_torch import native as tnative
from cuembed_tpu_torch.ops.tiered import auto_config as tauto
from cuembed_tpu_torch.utils import calibration as tcal
from torch_chip_pin import one_chip_record  # noqa: F401 (autouse)


def _same(got, want):
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("permute", [True, False])
@pytest.mark.parametrize("rows,hot_bytes", [(20_000, None), (500_000, None),
                                            (500_000, 65536)])
def test_calibrate_powerlaw_workload(permute, rows, hot_bytes):
    """A table within the JAX hot budget (no config), and a 128 MB one past
    it (a config and a remap)."""
    assert tnative.AVAILABLE == jnative.AVAILABLE
    args = (rows, 256, 8, 1.15, 64, 4)
    kw = dict(permute=permute, seed=3, calib_batches=12, hot_bytes=hot_bytes)
    got_cfg, got_idx, got_remap = tcal.calibrate_powerlaw_workload(*args, **kw)
    want_cfg, want_idx, want_remap = jcal.calibrate_powerlaw_workload(*args, **kw)
    _same(got_cfg, want_cfg)
    np.testing.assert_array_equal(got_idx, want_idx)
    assert (want_cfg is None) == (rows == 20_000)
    if want_remap is None:
        assert got_remap is None
    else:
        np.testing.assert_array_equal(got_remap, want_remap)


def test_refine_and_csr_fields():
    rng = np.random.default_rng(5)
    cfg_t = tauto(50_000, 64, 4, 8, hot_bytes=8192, vmem_table_bytes=1024)
    cfg_j = jauto(50_000, 64, 4, 8, hot_bytes=8192, vmem_table_bytes=1024)
    _same(cfg_t, cfg_j)
    ids = np.minimum((rng.random((3, 512, 8)) ** 4 * 50_000).astype(np.int64), 49_999)
    hots = rng.integers(0, 12, 512)
    offsets = [np.concatenate([[0], np.cumsum(hots)]).astype(np.int32),
               np.concatenate([[0], np.cumsum(hots[::-1])]).astype(np.int32)]
    for kw in ({}, {"calib_offsets": offsets, "value_capacity": 6000},
               {"capacity_margin": 1.3}):
        _same(tcal.refine_tiered_config(cfg_t, ids, **kw),
              jcal.refine_tiered_config(cfg_j, ids, **kw))
    _same(tcal.refine_tiered_config(cfg_t, ids[0]), jcal.refine_tiered_config(cfg_j, ids[0]))
    _same(tcal.calibrate_csr_fields(cfg_t, offsets[0], 6000),
          jcal.calibrate_csr_fields(cfg_j, offsets[0], 6000))
