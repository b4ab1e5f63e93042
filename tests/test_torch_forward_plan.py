"""K1 and K2's launch plan (``ops/cuda_forward.py::launch_plan``), on the CPU.

The plan decides how the kernels cover a batch: workers of 8, 16 or 32
lanes, column slabs, threads and work items a block, blocks, and the
dynamic shared memory a block stages positions in. The kernels check it
again on the card; here it is held to what they need.
"""

import pytest

from cuembed_tpu_torch.ops import cuda_forward
from cuembed_tpu_torch.ops.cuda_forward import launch_plan

# (column vectors a row, lanes a worker, slabs a row).
LANES = [(1, 8, 1), (2, 8, 1), (8, 8, 1), (9, 16, 1), (16, 16, 1), (17, 32, 1),
         (32, 32, 1), (33, 32, 2), (64, 32, 2), (514, 32, 17)]


@pytest.mark.parametrize("nvec,lanes,slabs", LANES)
@pytest.mark.parametrize("csr", [False, True], ids=["K1", "K2"])
def test_workers_cover_the_row(nvec, lanes, slabs, csr):
    plan = launch_plan(nvec, 100, csr=csr, weighted=False)
    assert (plan.lanes, plan.slabs) == (lanes, slabs)
    assert plan.lanes * plan.slabs >= nvec > plan.lanes * (plan.slabs - 1)
    assert plan.threads % 32 == 0 and plan.threads % plan.lanes == 0


@pytest.mark.parametrize("batch", [1, 7, 8, 9, 257, 1024, 65536, 65537])
@pytest.mark.parametrize("nvec", [1, 8, 32, 64, 514])
@pytest.mark.parametrize("csr,weighted", [(False, False), (False, True), (True, True)])
def test_blocks_cover_the_batch(batch, nvec, csr, weighted):
    """Every (bag, slab) item falls in exactly one block, and a block fits
    an H100 SM: at most 256 threads and 227 KB of shared memory."""
    plan = launch_plan(nvec, batch, csr=csr, weighted=weighted)
    items = batch * plan.slabs
    assert plan.blocks * plan.items_per_block >= items
    assert (plan.blocks - 1) * plan.items_per_block < items
    assert plan.threads <= cuda_forward.MAX_THREADS
    staged_offsets = 8 * (plan.items_per_block + 2) if csr else 0
    assert plan.smem_bytes == plan.threads * (12 if weighted else 8) + staged_offsets
    assert plan.smem_bytes <= cuda_forward.MAX_SMEM_BYTES == 232_448


def test_flagship_and_config_1_plans():
    """The flagship (10M x 256 fp16, 16-byte loads: 32 vectors a row, batch
    65536) and BASELINE.json config 1 (32 fp32 columns: 8 vectors, batch
    1024): a warp, or 8 lanes, a bag. At the flagship each worker takes
    FIXED_ITEMS (CSR_ITEMS) bags; config 1's 1024 bags give too few blocks
    for more than one."""
    warps, items = cuda_forward.FIXED_WARPS, cuda_forward.FIXED_ITEMS
    k1 = launch_plan(32, 65536, csr=False, weighted=False)
    assert k1 == cuda_forward.LaunchPlan(32, 1, 32 * warps, warps * items,
                                         65536 // (warps * items), 256 * warps)
    assert k1.blocks >= cuda_forward.FULL_GRID
    k2 = launch_plan(32, 65536, csr=True, weighted=True)
    assert k2.items_per_block == cuda_forward.CSR_WARPS * cuda_forward.CSR_ITEMS
    assert k2.smem_bytes == 12 * 32 * cuda_forward.CSR_WARPS + 8 * (k2.items_per_block + 2)
    small = launch_plan(8, 1024, csr=False, weighted=False)
    assert (small.lanes, small.items_per_block) == (8, 4 * warps)
    assert small.blocks == 1024 // (4 * warps) < cuda_forward.FULL_GRID


@pytest.mark.parametrize("nvec,batch", [(0, 10), (8, 0)])
def test_nothing_to_launch_raises(nvec, batch):
    with pytest.raises(ValueError, match="nothing to launch"):
        launch_plan(nvec, batch, csr=False, weighted=False)


def test_a_grid_too_large_raises():
    with pytest.raises(ValueError, match="more than a grid holds"):
        launch_plan(514, 2**36, csr=True, weighted=False)
