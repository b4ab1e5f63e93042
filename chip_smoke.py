#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (nonzero exit) on any fault:

1. The card: name, count, and ``nvidia-smi``'s name and power limit.
2. The build: ``csrc/forward.cu``, ``csrc/backward.cu``,
   ``csrc/adagrad.cu`` and ``csrc/transpose.cu`` compiled from this
   checkout, with the build time and ptxas's register, spill and static
   shared-memory counts for K1, K2, K3, K4 and K5, and the launch shapes at
   the flagship calls (registers, spills, shared memory per block, threads,
   resident blocks per SM) of K1 and K2,
   as the wrappers plan them, of K3, and of K4 at widths 256 and 128.
3. Parity grids on the card. K1 (fixed-hotness) and K2 (CSR) against their
   plain PyTorch versions over the shapes of tests/test_parity_bitwise.py,
   bags of 2100 and the flagship width at hotness 64 over a ragged last
   block, fp32/fp16/bf16 tables with and without low-precision math,
   int32/int64 indices and offsets, SUM, weighted SUM and MEAN, zero-hotness
   samples and capacity padding: integer-exact tables bit for bit, random
   reals at fp32 rtol = atol = 1e-5 and fp16/bf16 at one ulp of the output;
   then their edges bit for bit (a zero-hotness batch, one CSR bag of 5000
   holding most positions, every id on one row or four, table views that
   take 8-byte and one-element loads). K3 (the
   sorted-COO backward) against its plain version over the shapes of
   tests/test_pallas_backward.py, widths 2, 36 and 514 (514 on K3's
   column-slice path), a run over more than three tiles (so across ring
   stages, a tile and several tiles), tiles of one-position runs and an
   empty COO, for fp32/fp16/bf16 grad_y, int32/int64 indices, with and
   without weights, full and compressed, with sentinel padding, an nnz
   prefix and an initial gradient; and grad_y views offset by 2, 4 and 8
   bytes, so that each of K3's copy routes (bulk, cp.async of 8 and 4
   bytes, plain 2-byte loads) launches: integer-exact data bit for bit,
   random reals each within its recursive-sum bound of a float64 sum, and
   every case launched twice with the same bits.
4. The serving path, with every kernel's launch count set to 0 first and
   read after, and the plain versions made to raise if anything calls them:
   the flagship fixed request (10M x 256 fp16 table, batch 65536, hotness
   64, alpha 1.15 power-law ids, int64) through ``embedding_lookup``; the
   flagship CSR requests (per-sample hotness U{0..64}, capacity padding),
   weighted SUM and MEAN with and without low-precision math, through
   ``embedding_lookup_csr``; and an ``EmbeddingBag`` at 100K x 32 fp32 and
   at the flagship size serving 5 batches each. Outputs are compared with
   the plain version; K1 and K2 are timed (CUDA events, L2 flushed between
   launches) beside the plain version, ``F.embedding_bag`` (a yardstick
   only; the port never calls it) and the least time an H100 could take.
5. The training path (BASELINE.json config 4), counted the same way, on a
   10M x 256 bf16 ``EmbeddingBag``: three dense steps (autograd through
   K1, the transpose and K3 full mode, then ``torch.optim.SGD``), three
   row-wise AdaGrad steps and one sparse SGD step (K3 compressed mode), and
   the CSR (weighted SUM, MEAN) and CONCAT backward. Each result is then
   compared with the plain path (``backend="xla"``) on the same inputs, and
   every gradient with float64 sums. Then K3 at the same sorted COOs (fixed,
   weighted CSR, CONCAT; full and compressed, launched twice) on
   integer-valued grad_y, bit for bit against its plain version.
6. K3 timed at the flagship batch (full mode into a zeroed buffer,
   compressed mode into an unzeroed one, CSR) beside its plain version,
   ``F.embedding_bag``'s backward, its bound and the first design's times
   (PR 2, from PERF.md);
   the transpose; a dense step and an AdaGrad step end to end, each with a
   ``torch.profiler`` breakdown of device time. Then K4, row-wise AdaGrad's
   apply, at the flagship's shapes (10M x 256 fp16, hotness 64) and at the
   DLRM-v2 table with the most ids (40M x 128 fp16, hotness 100): one
   launch on K3's unzeroed compressed sums, counted, against the plain
   apply (accumulators within 1e-6, table rows within one fp16 spacing of
   the step and one of the result, no NaN, untouched rows unchanged), then
   timed beside its bound, the plain apply and the torch ops it replaced.
   Every counted phase, in this process and in the spawned ranks, checks
   its K4 launches too (0 unless it runs an AdaGrad update on the card),
   and the ``kernels`` line carries the counted runs' K4 launches, as it
   does K1-K3's; the timing loops' and the checks' other updates print on
   a line of their own. Then K5, the COO transpose, at the same two
   lookups (4,194,304 ids into 10M rows; 6,553,600 into 40M), int64
   power-law ids with 1% the sentinel: one counted launch each, bit for bit
   the plain route (``torch.sort``, the sample ids and the gathers), then
   timed beside its bound (the ids read and the sorted ids and sample ids
   written once), its own design's bytes and the plain route. Every counted
   phase adds its K5 launches (one a transpose: each update of a table, and
   each autograd backward) to the ``kernels`` line's K5 count, each phase
   checked against its expected number as K4's are, and the total against
   ``K5_TOTAL``: this process's counted runs only, not the ranks'.
7. The TPU engines' API (ROADMAP P7) on the same kernels, each path counted
   the same way. Serving, at config 2: ``backend="tiered"`` with
   ``auto_config(10M, 256, 2, 64)`` (K1) and config 3's weighted CSR under
   ``csr_combine_config`` (K2), each equal to ``backend="auto"`` bit for
   bit; ``EmbeddingBag(layout="packed")`` at config 1, equal to the padded
   layout bit for bit; ``narrow_lookup`` at the 10M x 32 fp32 sweep point,
   which must hand K1 the packed storage itself; ``tiered_forward`` with an
   int8 head of ``int8_head_rows(256, DEFAULT_HOT_BYTES)`` rows, against a
   float32 version of its sum; and ``int8_serving_lookup`` over the whole
   table quantized, within ``sum max|row| / 254`` of the exact lookup.
   Training, at config 4: the dense step's gradient with a ``tiered_cfg``
   (the head product plus K3 over the other positions) equal to the
   untiered K3 gradient bit for bit on integer ``grad_y``, and tiered sparse
   SGD and AdaGrad steps against the untiered ones. Each is timed beside
   the kernel route it stands for.
8. Tables, collections, fused groups and models (ROADMAP P8, P9) on the
   same kernels, each call counted and the plain versions forbidden. At
   config 4, an ``EmbeddingTable`` (10M x 256 bf16) calibrated on 4
   batches: its lookups (the remap on the card, host-remapped ids, config
   3's weighted CSR) each launch K1 or K2 once and equal the lookups before
   the reorder bit for bit; a row-wise AdaGrad step on its storage launches
   K3 compressed and is held to the plain path; ``resize_table`` grows and
   shrinks it with its state. At ``DLRMConfig``'s defaults (8 tables of
   100K x 64 fp32, hotness 8, batch 65536): ``fused_lookup`` launches K1
   once and equals the 8 ``EmbeddingCollection.apply`` lookups and the
   plain path bit for bit (the collection's tables in one call into the
   library: its batched K1 forward); ``fused_adagrad_update`` launches K3
   once, and
   it, the per-table updates and the plain path's update of the fused
   table are each held to the float64 step (``check_fp32_step``: the
   step's change under the fp32 row sums' recursive-sum bound). The DLRM,
   fused and per-table, beside a per-table model on the plain path, from
   one numpy parameter set: the forward against the plain path, 5
   ``sgd_step``s (K3 full) whose losses agree with the plain path's, each
   step's host and device ms, and the tables after the first step held to
   the float64 step. Last ``examples/train_dlrm_torch.py`` with its
   defaults (examples/s, and whether the native host library loaded;
   nothing builds it here), then a collection at its shapes: one lookup
   bit for bit and one AdaGrad update held to the float64 step, beside
   the plain path. Then a collection at MLPerf DLRM-v2's shapes (26 fp16
   tables of width 128, hotness 1-100; the 40M-row tables cut to
   ``DLRMV2_ROWS_CAP`` rows): a query of 700 samples and a batch of 65,536,
   each served by one call of the batched forward (26 K1 launches) and
   equal to the 26 per-table ``embedding_lookup`` calls bit for bit; its
   launches print on a line of their own, outside the ``kernels`` line.
9. The host-offloaded table and the parallel layer (ROADMAP P10, P11
   below the planner), each call counted and the plain versions forbidden.
   ``HostOffloadTable`` at benchmarks/offload_benchmark.py's defaults (2M x
   64 fp32, a 262,144-row head on the card, batch 8192, hotness 8): its
   lookup (one K1 launch on the head and the shipped cold rows) bit for bit
   against K1 on the resident table under SUM, MEAN and weighted SUM, one
   batch prepared on the ``InputPipeline`` thread, an SGD step and two
   AdaGrad steps held to the float64 step; with ``prepare``'s host ms and
   the lookup's device ms beside K1's on the resident table. Then 4 ranks
   spawned on cuda:0 over gloo (NCCL refuses two ranks on one device),
   each counting its launches: config 2's table (10M x 256 fp16)
   row-sharded, its request through ``row_sharded_lookup``,
   ``alltoall_row_sharded_lookup`` (bit for bit against one-card K1) and
   its ``compress="int8"`` route, each within its bound; the 8 routed
   updates at ``DLRMConfig``'s table shape (100K x 64 fp32, batch 65536,
   hotness 8; column and grid on a (2, 2) mesh) held to the float64 step;
   ``examples/train_dlrm_sharded_torch.py`` at its defaults on the 4 ranks
   and at world size 1 over NCCL, the losses held to each other; and the
   fused DLRM group (8 tables): its lookup against the per-table routed
   lookups bit for bit, its AdaGrad update and theirs held to the float64
   step.
10. The placement planner (the rest of P11), each run counted in its rank
   with the plain versions forbidden. benchmarks/planner_validation.py's
   four table mixes (skewed 10M x 128 bf16, uniform 10M x 128 bf16, wide
   512K x 512 fp32, huge 16M x 256 bf16; 14.4 GB) and plan_and_train's
   genre table, planned by ``plan_placement`` from calibration counts
   (``PLAN_OVERRIDE`` printed) onto a (2, 2) mesh of 4 ranks on cuda:0 over
   gloo: every placement; 2 AdaGrad steps of ``planned_lookup`` and
   ``planned_adagrad_update`` at batch 65536, a ``planned_sgd_update`` and
   a sharded-CSR request on the replicated and the row-sharded table; every
   lookup against the plain version and the float64 combine, every update
   at its touched rows against the float64 step beside the plain path's,
   rows no step touched held to their bits. ``examples/plan_and_train_torch.py``
   at its defaults on the 4 ranks and at world size 1 over NCCL, its first
   and last steps replayed. The ``CostModel`` calibration: every feasible
   placement of each mix on one card of a (2, 4) mesh (lookup and AdaGrad
   update timed, plus the plan's comm bytes over the data sheet's NVLink
   rate) against ``plan()``'s pick, and the sweeps the defaults come from.
11. The chip record and the chained timers: the record ``chip_constants()``
   resolved (path and device kind; on an H100 the v5e fallback fails the
   run), ``python -m cuembed_tpu_torch.utils.calibrate_chip --quick``'s
   record and derived constants beside the committed record's, and config
   2's flagship request (K1 through ``embedding_lookup``) and config 1's
   ``EmbeddingBag`` request each timed three ways: ``cuda_time_ms`` (L2
   flushed), ``fori_chain_time`` (the step captured as a CUDA graph chain)
   and ``chain_time`` (the host clock), the gap between the last two the
   host's time per call. A timing harness, not a main path: its K1 wrapper
   calls (the graph captures included; a replay re-launches the captured
   kernels uncounted) are printed on their own line and stay out of the
   ``kernels`` line, whose counts are the counted main-path phases'.
12. The ``kernels`` JSON line, ``nvidia-smi``'s line, and last the result
   line ``{"ok": true, "device": {...}}``.

It exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import re
import statistics
import time

import numpy as np

# The training path holds several 5 GB snapshots of a 10M x 256 bf16 table
# beside 10 GB gradients; growable segments keep the allocator from
# fragmenting the card's memory.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import cuembed_tpu_torch as tce
from cuembed_tpu_torch import native, train
from cuembed_tpu_torch import fused as fused_mod
from cuembed_tpu_torch.models import DLRM, DLRMConfig
from cuembed_tpu_torch.models.dlrm import (bce_with_logits, interaction,
                                           params_from_numpy)
from cuembed_tpu_torch.ops import (_build, cuda_adagrad, cuda_backward, cuda_forward,
                                   cuda_transforms, dispatch, narrow, quant)
from cuembed_tpu_torch.ops import tiered as tiered_mod
from cuembed_tpu_torch.ops.head import head_grad, tiered_backward_coo
from cuembed_tpu_torch.ops.lookup_torch import SENTINEL, embedding_backward_compressed_tiered
from cuembed_tpu_torch.ops.lookup_torch import embedding_backward_compressed_torch as plain_bwd_c
from cuembed_tpu_torch.ops.lookup_torch import embedding_backward_torch as plain_bwd
from cuembed_tpu_torch.ops.lookup_torch import embedding_forward_torch as plain
from cuembed_tpu_torch.ops.transforms import transpose, transpose_position_ordered
from cuembed_tpu_torch.parallel.sharding import assemble
from cuembed_tpu_torch.utils import benchmarking as bench
from cuembed_tpu_torch.utils import calibrate_chip, chip, trace
from cuembed_tpu_torch.types import init_table_
from cuembed_tpu_torch.utils.datagen import PowerLawGenerator

# Flagship sizes (BASELINE.json configs 2 and 3, bench.py).
NUM_ROWS, WIDTH, BATCH, HOTNESS, ALPHA = 10_000_000, 256, 65536, 64, 1.15
# BASELINE.json config 1.
SMALL_ROWS, SMALL_WIDTH, SMALL_BATCH, SMALL_HOTNESS = 100_000, 32, 1024, 8
# (batch, width, hotness) of tests/test_parity_bitwise.py, then bags far
# longer than a worker's 32 staged positions, and the flagship width at
# hotness 64 over a batch that leaves the last block's workers part idle.
GRID_SHAPES = [
    (3, 2, 4), (7, 4, 1), (31, 8, 8), (129, 32, 26), (129, 36, 26),
    (65, 64, 17), (33, 128, 33), (3, 512, 63), (17, 514, 5), (255, 16, 2),
    (2, 64, 2100), (257, 256, 64),
]
# (storage dtype, low-precision math, max |value| of the integer-exact table).
GRID_TYPES = [
    (torch.float32, False, 8), (torch.float16, False, 8),
    (torch.float16, True, 2), (torch.bfloat16, False, 8),
    (torch.bfloat16, True, 1),
]
HBM_PEAK = "3.35 TB/s (H100 SXM data sheet)"
COMPARE_ROWS = 8192  # batch rows per comparison chunk
# (batch, hotness, num_categories, width) of the backward grid: the shapes
# of tests/test_pallas_backward.py, widths 2, 36 and 514, a run longer than
# three tiles (the first LONG_RUN positions of a COO longer than that share
# one index), two tiles of one-position runs, and an empty COO.
BWD_SHAPES = [
    (32, 8, 200, 128), (13, 5, 67, 256), (64, 3, 40, 128), (40, 6, 300, 2),
    (40, 6, 300, 36), (17, 5, 90, 514), (64, 20, 500, 64), (4, 0, 50, 128),
    (64, 8, 1_000_000, 256),
]
LONG_RUN = 3 * cuda_backward.TILE + 50
# K3's copy routes off the aligned one (bulk): (grad_y dtype, byte offset of
# its view), run at BWD_ROUTE_SHAPES; the aligned grid covers the bulk route.
BWD_ROUTES = [(torch.float32, 8), (torch.float32, 4), (torch.bfloat16, 8),
              (torch.bfloat16, 4), (torch.float16, 2)]
BWD_ROUTE_SHAPES = [(64, 20, 500, 256), (17, 5, 90, 514)]
# K3's times in its first design (PERF.md, PR 2's final run on an NVIDIA
# H100 80GB HBM3 at 700 W), printed beside this run's.
PR2_K3_MS = {"full": 2.0744, "dense": 1.1978, "compressed": 2.9281, "csr": 1.2157}
# K1's and K2's times in their first design (PERF.md, PR 3's final run on an
# NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's.
PR3_FWD_MS = {"fixed sum": 0.2586, "csr sum_w": 0.2248, "csr sum_w lpm": 0.2693,
              "csr mean": 0.1980, "csr mean lpm": 0.2138, "config 1": 0.0065}
BWD_PAD = 7  # sentinel entries past the live positions
# Significand bits (with the implicit one) of each storage type.
BITS = {torch.float32: 24, torch.float16: 11, torch.bfloat16: 8}
# The narrow sweep point (benchmarks/sweep_parameters.sh:9-24): a 10M x 32
# fp32 table, batch 131072, hotness 64, alpha 1.15.
SWEEP_ROWS, SWEEP_WIDTH, SWEEP_BATCH = 10_000_000, 32, 131072
# Learning rates of the sparse steps: large enough that a bf16 table moves.
ADAGRAD_LR, SGD_LR = 0.01, 1e-4
DENSE_STEPS, ADAGRAD_STEPS = 3, 3


nvidia_smi_line = calibrate_chip.nvidia_smi_line


def ulp(x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """One ulp of each value of ``x`` in ``dtype`` (default: its own
    floating type), as fp32."""
    dtype = dtype or x.dtype
    info = torch.finfo(dtype)
    _, exp = torch.frexp(x.float().abs())
    exp = exp.clamp(min=int(np.log2(info.tiny)) + 1)
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - BITS[dtype])


def within_tolerance(got: torch.Tensor, want: torch.Tensor) -> bool:
    """fp32: rtol = atol = 1e-5; fp16/bf16: one ulp of the output."""
    if got.dtype == torch.float32:
        return torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    return bool(((got.float() - want.float()).abs() <= ulp(want)).all())


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item() if got.numel() else 0.0


def check_sparse_step(name, got, want, old, touched):
    """One sparse step of a bf16 table on the K3 path (``got``) against the
    plain path (``want``), both from the same table, whose rows at
    ``touched`` were ``old``. ``got`` and ``want`` are each the whole
    table, or its rows at ``touched`` when it has as many rows. (An fp32
    table: ``check_fp32_step``.)

    Each path adds its fp32 update u to the table as ``old + bf16(u)``,
    rounded to bf16. The two paths' u differ by the order of their fp32
    sums (the plain path's ``index_add_`` uses atomics on the card), so
    bf16(u) may differ by one ulp of u; where old and u nearly cancel, that
    is many ulps of the result. Allowed at the touched rows: one ulp of
    the larger result plus one bf16 ulp of twice the larger step
    |new - old|. Every other row must be equal. Returns max |got - want|.
    """
    def rows(t):
        return t if t.shape[0] == touched.numel() else t[touched]
    g, w = rows(got), rows(want)
    full = got.shape[0] == want.shape[0] != touched.numel()
    larger = torch.maximum(g.abs(), w.abs())
    step = torch.maximum((g.float() - old.float()).abs(), (w.float() - old.float()).abs())
    diff = (g.float() - w.float()).abs()
    tol = ulp(larger) + ulp(2 * step, torch.bfloat16)
    over_ulp = int((diff > ulp(larger)).sum())
    ratio = (diff / tol).max().item() if diff.numel() else 0.0
    err = diff.max().item() if diff.numel() else 0.0
    del g, w, larger, step, diff, tol
    untouched_ok = True
    if full:
        untouched = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
        untouched[touched] = False
        for r0 in range(0, got.shape[0], 1 << 20):
            keep = untouched[r0:r0 + (1 << 20)]
            untouched_ok = untouched_ok and torch.equal(got[r0:r0 + (1 << 20)][keep],
                                                        want[r0:r0 + (1 << 20)][keep])
    print(f"[{name}] max |table, K3 path - plain path| {err}; {over_ulp} elements more "
          f"than one ulp of the result apart; worst difference over its bound "
          f"{ratio:.3g} (at most 1 passes); untouched rows "
          f"{'equal' if untouched_ok else 'CHANGED'}")
    if ratio > 1 or not untouched_ok:
        raise SystemExit(f"[{name}] the table disagrees with the plain path")
    return err


PLAIN_NAMES = ("embedding_forward_torch", "embedding_backward_torch",
               "embedding_backward_compressed_torch", "rowwise_adagrad_apply_torch",
               "coo_transpose_torch")


@contextlib.contextmanager
def plain_path_forbidden(*modules):
    """Make the plain versions raise if the kernels' callers reach them;
    where K3's are forbidden, so is K4's (an AdaGrad update's apply)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the main path took the plain version")
    if cuda_backward in modules:
        modules += (cuda_adagrad,)
    saved = [(m, n, getattr(m, n)) for m in modules for n in PLAIN_NAMES
             if hasattr(m, n)]
    for m, n, _ in saved:
        setattr(m, n, refuse)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


COUNTED = ("launch.k1", "launch.k2", "launch.k3_full", "launch.k3_compressed")
_counted_from = trace.counters()
# K4's launches in the counted runs: this process's, and the spawned ranks'
# (each rank saves its own "counted" for the parent to add).
K4_COUNTED = {"counted": 0, "ranks": 0}
# K5's launches in this process's counted runs: one a transpose (each update
# of a table, each autograd backward), checked a phase as K4's are. The
# counted phases' total: the training path 10, p7 training 3, the P8 table,
# fused and collection updates 1 + 1 + 8, the DLRM steps 5 + 40 and its
# trainer 80, the offloaded table 1 + 2, the planner's example at world
# size 1 15. (The sharded updates sort their own COO; the ranks are not
# counted here.)
K5_COUNTED = {"counted": 0}
K5_TOTAL = 166


def zero_counts():
    """Count launches from here on (a snapshot of ``trace.counters()``)."""
    global _counted_from
    _counted_from = trace.counters()


def launch_counts() -> tuple:
    """The launches of K1, K2, K3 full and K3 compressed since
    :func:`zero_counts`, in that order."""
    now = trace.counters()
    return tuple(now[k] - _counted_from[k] for k in COUNTED)


def k4_checked(name, k4):
    """K4's launches since :func:`zero_counts`; fail unless there are ``k4``
    of them, else add them to ``K4_COUNTED``."""
    got = trace.counters()["launch.k4"] - _counted_from["launch.k4"]
    if got != k4:
        raise SystemExit(f"[{name}] launched K4 {got} times, expected {k4}")
    K4_COUNTED["counted"] += got
    return got


@contextlib.contextmanager
def counted(expect, name, k4=0, k5=0):
    """Set the counts to 0, run the body, and fail unless it launched
    exactly ``expect`` of K1, K2, K3 full and K3 compressed (in that order),
    ``k4`` of K4 (one an AdaGrad update on the card) and ``k5`` of K5 (one a
    transpose: each update of a table, each autograd backward). Every phase
    counts its launches so, and returns them in that order."""
    zero_counts()
    yield
    torch.cuda.synchronize()
    got = launch_counts()
    if got != tuple(expect):
        raise SystemExit(f"[{name}] launched (K1, K2, K3 full, K3 compressed) "
                         f"{got}, expected {tuple(expect)}")
    k4_checked(name, k4)
    got_k5 = trace.counters()["launch.k5"] - _counted_from["launch.k5"]
    if got_k5 != k5:
        raise SystemExit(f"[{name}] launched K5 {got_k5} times, expected {k5}")
    K5_COUNTED["counted"] += k5
    print(f"[{name}] launches (K1, K2, K3 full, K3 compressed): {got}"
          + (f"; K4: {k4}" if k4 else "") + (f"; K5: {k5}" if k5 else ""))


def phase_build():
    """Build from the sources in this checkout and report ptxas's counts."""
    _build.library_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
          f"{time.perf_counter() - t0:.1f} s")
    log = _build.build_log_path().read_text()
    m = re.search(r"build times: (.*)", log)
    per_source = [float(t) for t in re.findall(
        r"\.cu (\d+\.\d+) s", m.group(1))] if m else []
    if len(per_source) != len(_build.SOURCES):
        raise SystemExit("[build] the log holds no time for each source")
    print(f"[build] one nvcc per source, started together: {m.group(1)}; one after "
          f"the other the compiles would take about their sum, {sum(per_source):.1f} s")
    # K1's and K2's flagship launches, from the built library: fp16 rows of
    # 256, int64 ids, 16-byte loads, as the wrappers plan them.
    for label, kw in (("K1 fixed sum", {}),
                      ("K2 csr sum_w", {"csr": True, "weighted": True}),
                      ("K2 csr sum_w lpm", {"csr": True, "weighted": True,
                                            "low_precision_math": True}),
                      ("K2 csr mean", {"csr": True})):
        shape = cuda_forward.launch_shape(torch.float16, WIDTH, BATCH, **kw)
        print(f"[build] {label} at width {WIDTH} fp16: {shape['registers']} registers, "
              f"{shape['spill_bytes']} spill bytes, {shape['smem_bytes']} bytes shared "
              f"memory a block, {shape['threads']} threads ({shape['lanes']} lanes a "
              f"worker), {shape['blocks_per_sm']} blocks resident per SM")
        if shape["spill_bytes"]:
            raise SystemExit(f"[build] {label}'s flagship instantiation spills")
    kernels, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            kernels[current] = {"regs": None, "spill": 0, "smem": 0}
        elif current and (m := re.search(r"Used (\d+) registers", line)):
            kernels[current]["regs"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", line):
                kernels[current]["smem"] = int(m.group(1))
        elif current and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            kernels[current]["spill"] = int(m.group(1)) + int(m.group(2))
    # The flagship instantiations: fp16 rows (forward) or fp32 and bf16
    # grad_y rows (backward), int64 ids, 16-byte loads.
    bwd = ("Ifl", "I13__nv_bfloat16l")
    flagship_spills = 0
    for family, flagship in (("fixed_forward_kernel", ("I6__halfl",)),
                             ("csr_forward_kernel", ("I6__halfl",)),
                             ("coo_backward_kernel", bwd),
                             ("coo_backward_fixup_kernel", bwd),
                             ("run_count_kernel", None), ("run_scan_kernel", None)):
        mine = {k: v for k, v in kernels.items() if f"{len(family)}{family}" in k}
        if not mine:
            raise SystemExit(f"[build] ptxas reported no {family}")
        regs = [v["regs"] for v in mine.values()]
        spills = sum(v["spill"] for v in mine.values())
        print(f"[build] {family}: {len(mine)} instantiations, registers "
              f"{min(regs)}..{max(regs)}, spill bytes {spills}")
        for name, v in mine.items():
            if flagship is None or (any(f in name for f in flagship) and "Li16E" in name):
                print(f"[build]   {name}: {v['regs']} registers, {v['spill']} spill bytes, "
                      f"{v['smem']} bytes static shared memory")
                if family == "coo_backward_kernel":
                    flagship_spills += v["spill"]
    if flagship_spills:
        raise SystemExit(f"[build] K3's flagship instantiations spill {flagship_spills} bytes")
    # K3's shared memory is dynamic: the ring of grad_y rows (and of old
    # rows in full mode, unless the output was zeroed here), its barriers
    # and the tile's COO.
    for label, dtype, kw in (("fp32 full", torch.float32, {}),
                             ("fp32 full, zeroed output", torch.float32, {"zeroed": True}),
                             ("fp32 compressed", torch.float32, {"compressed": True}),
                             ("bf16 full, zeroed output (the dense step)", torch.bfloat16,
                              {"zeroed": True}),
                             ("fp32 full, weighted (CSR)", torch.float32, {"weighted": True})):
        shape = cuda_backward.launch_shape(dtype, WIDTH, **kw)
        print(f"[build] K3 at width {WIDTH}, {label}: {shape['smem_bytes']} bytes dynamic "
              f"shared memory a block, {shape['threads']} threads, "
              f"{shape['blocks_per_sm']} blocks resident per SM, {shape['slices']} column "
              f"slice(s) a row")
    # K4: every instantiation spill-free; its launches at the flagship's and
    # the DLRM-v2 tables' fp16 widths (int64 ids, 16-byte gradient loads).
    mine = {k: v for k, v in kernels.items() if "28rowwise_adagrad_apply_kernel" in k}
    if not mine:
        raise SystemExit("[build] ptxas reported no rowwise_adagrad_apply_kernel")
    regs = [v["regs"] for v in mine.values()]
    spills = sum(v["spill"] for v in mine.values())
    print(f"[build] rowwise_adagrad_apply_kernel: {len(mine)} instantiations, registers "
          f"{min(regs)}..{max(regs)}, spill bytes {spills}")
    if spills:
        raise SystemExit(f"[build] K4 spills {spills} bytes")
    # K5: its histogram and digit-pass kernels, each instantiation.
    for family in ("histogram_kernel", "digit_pass_kernel"):
        mine = {k: v for k, v in kernels.items() if f"{len(family)}{family}" in k}
        if not mine:
            raise SystemExit(f"[build] ptxas reported no {family}")
        print(f"[build] {family}: " + "; ".join(
            f"{re.sub(r'.*' + family, '', k)[:24]} {v['regs']} registers, {v['spill']} spill "
            f"bytes, {v['smem']} bytes static shared memory" for k, v in mine.items()))
    for width in (WIDTH, K4_SHAPES[1][2]):
        shape = cuda_adagrad.launch_shape(torch.float16, width)
        print(f"[build] K4 at width {width} fp16: {shape['threads']} threads, "
              f"{shape['blocks_per_sm']} blocks resident per SM, {shape['rows_in_flight']} "
              f"rows in flight a warp, {shape['chunks']} register chunk(s) a row")


def grid_problem(gen, batch, width, hotness, dtype, vmax, integer, csr, index_dtype,
                 offset_dtype, weighted):
    V = 200
    if integer:
        table = torch.randint(-vmax, vmax + 1, (V, width), device="cuda", generator=gen)
    else:
        table = torch.randn((V, width), device="cuda", generator=gen)
    table = table.to(dtype)
    if csr:
        hots = torch.randint(0, hotness + 1, (batch,), device="cuda", generator=gen)
        hots[::5] = 0  # zero-hotness samples
        offsets = torch.cat([hots.new_zeros(1), hots.cumsum(0)]).to(offset_dtype)
        shape = (int(offsets[-1]) + 3,)  # capacity padding past offsets[-1]
    else:
        offsets, shape = None, (batch, hotness)
    idx = torch.randint(0, V, shape, device="cuda", generator=gen).to(index_dtype)
    weights = None
    if weighted:
        if integer:
            weights = torch.tensor([0.5, 0.25], device="cuda")[
                torch.randint(0, 2, shape, device="cuda", generator=gen)]
        else:
            weights = torch.rand(shape, device="cuda", generator=gen)
    return table, idx, offsets, weights


def phase_grid():
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases, failures, worst = 0, [], {"bitwise": 0.0, "tolerance": 0.0}
    for batch, width, hotness in GRID_SHAPES:
        for dtype, lpm, vmax in GRID_TYPES:
            for index_dtype in (torch.int32, torch.int64):
                variants = [(False, None)] + [(True, o) for o in (torch.int32, torch.int64)]
                for csr, offset_dtype in variants:
                    for mode in ("sum", "sum_w", "mean"):
                        for integer in (True, False):
                            m = tce.CombineMode(mode.removesuffix("_w"))
                            table, idx, offsets, w = grid_problem(
                                gen, batch, width, hotness, dtype, vmax, integer,
                                csr, index_dtype, offset_dtype, mode == "sum_w")
                            if csr:
                                got = cuda_forward.embedding_forward_cuda_csr(
                                    table, idx, offsets, w, mode=m, low_precision_math=lpm)
                            else:
                                got = cuda_forward.embedding_forward_cuda(
                                    table, idx, w, mode=m, low_precision_math=lpm)
                            want = plain(table, idx, offsets, w, mode=m,
                                         low_precision_math=lpm)
                            torch.cuda.synchronize()
                            cases += 1
                            err = max_abs_err(got, want)
                            key = "bitwise" if integer else "tolerance"
                            worst[key] = max(worst[key], err)
                            ok = torch.equal(got, want) if integer else within_tolerance(got, want)
                            if csr:
                                zero = (offsets[1:] == offsets[:-1]).nonzero().squeeze(1)
                                ok = ok and not got[zero].any()
                            if not ok:
                                failures.append((batch, width, hotness, str(dtype), lpm,
                                                 str(index_dtype), csr, str(offset_dtype),
                                                 mode, integer, err))
    print(f"[grid] {cases} cases: max |kernel - plain| {worst['bitwise']} on "
          f"integer-exact tables (bitwise), {worst['tolerance']} on random reals "
          f"(fp32 rtol=atol=1e-5, fp16/bf16 1 ulp)")
    for f in failures[:20]:
        print(f"[grid] MISMATCH {f}")
    if failures:
        raise SystemExit(f"[grid] {len(failures)} of {cases} cases disagree")

    # An independent reference: a float64 numpy sum of an integer table.
    rng = np.random.default_rng(5)
    table = rng.integers(-8, 9, (50, 130)).astype(np.float32)
    idx = rng.integers(0, 50, (9, 11))
    want = table[idx].astype(np.float64).sum(axis=1)
    got = tce.embedding_lookup(torch.from_numpy(table).cuda(), torch.from_numpy(idx).cuda())
    if not np.array_equal(got.cpu().numpy().astype(np.float64), want):
        raise SystemExit("[grid] K1 disagrees with a float64 numpy sum")
    print("[grid] K1 equals a float64 numpy sum on a 9 x 11 integer problem")


def phase_edges():
    """K1 and K2 at the edges of their design, bit for bit against the plain
    version on integer-exact tables of every grid type: a zero-hotness
    batch; a CSR batch where one bag of 5000 holds most positions; every id
    on one row, and on four, at width 256 and hotness 64; and table views 8
    bytes and one element into their storage, so that the 8-byte and the
    one-element loads launch (the 16-byte ones launch everywhere else)."""
    gen = torch.Generator(device="cuda").manual_seed(77)
    cases, failures, loads = 0, [], set()

    def check(label, table, idx, offsets, lpm, modes=("sum", "sum_w", "mean")):
        nonlocal cases
        for mode in modes:
            w = (torch.tensor([0.5, 0.25], device="cuda")[
                torch.randint(0, 2, idx.shape, device="cuda", generator=gen)]
                if mode == "sum_w" else None)
            m = tce.CombineMode(mode.removesuffix("_w"))
            if offsets is None:
                got = cuda_forward.embedding_forward_cuda(table, idx, w, mode=m,
                                                          low_precision_math=lpm)
            else:
                got = cuda_forward.embedding_forward_cuda_csr(table, idx, offsets, w, mode=m,
                                                              low_precision_math=lpm)
            want = plain(table, idx, offsets, w, mode=m, low_precision_math=lpm)
            cases += 1
            if not torch.equal(got, want):
                failures.append((label, str(table.dtype), lpm, mode, max_abs_err(got, want)))

    for dtype, lpm, vmax in GRID_TYPES:
        def table_of(rows, width, shift=0):
            t = torch.randint(-vmax, vmax + 1, (rows * width + shift,), device="cuda",
                              generator=gen).to(dtype)
            view = t[shift:].view(rows, width)
            size = view.element_size()
            loads.add(cuda_forward._vec_bytes(
                width * size | view.data_ptr() | torch.empty_like(view[:1]).data_ptr(), size))
            return view
        check("hotness 0", table_of(40, 256), torch.zeros((9, 0), dtype=torch.int64,
                                                         device="cuda"), None, lpm,
              ("sum", "sum_w"))
        # Integer-exact under every type: a bag of 5000 adds values of at
        # most vmax, 7 in 8 of them 0, so that its sums stay exact.
        sparse = table_of(300, 64)
        sparse *= (torch.rand(sparse.shape, device="cuda", generator=gen) < 0.125).to(dtype)
        hots = torch.tensor([5000, 3, 0, 64, 1, 17], device="cuda")
        offsets = torch.cat([hots.new_zeros(1), hots.cumsum(0)])
        flat = torch.randint(0, 300, (int(offsets[-1]) + 4,), device="cuda", generator=gen)
        check("one bag of 5000", sparse, flat, offsets, lpm)
        wide = table_of(1000, 256)
        for label, idx in (("one row", torch.full((70, 64), 617, device="cuda")),
                           ("four rows", torch.randint(0, 4, (70, 64), device="cuda",
                                                       generator=gen) * 211)):
            small = wide * (torch.rand(wide.shape, device="cuda", generator=gen)
                            < 0.125).to(dtype)
            check(label, small, idx, None, lpm)
            hots = torch.randint(0, 65, (70,), device="cuda", generator=gen)
            check(f"{label} csr", small, idx.reshape(-1),
                  torch.cat([hots.new_zeros(1), hots.cumsum(0)]), lpm)
        for shift in (8 // (torch.finfo(dtype).bits // 8), 1):
            idx = torch.randint(0, 200, (37, 19), device="cuda", generator=gen)
            view = table_of(200, 256, shift)
            check(f"view +{shift} elements", view, idx, None, lpm)
            hots = torch.randint(0, 20, (37,), device="cuda", generator=gen)
            check(f"view +{shift} elements csr", view, idx.reshape(-1),
                  torch.cat([hots.new_zeros(1), hots.cumsum(0)]).int(), lpm)
    torch.cuda.synchronize()
    print(f"[edges] {cases} cases: {len(failures)} differ from the plain version; load "
          f"widths that ran (bytes): {sorted(loads)}")
    for f in failures[:20]:
        print(f"[edges] MISMATCH {f}")
    if failures:
        raise SystemExit(f"[edges] {len(failures)} of {cases} cases disagree")
    if not {16, 8, 4, 2} <= loads:
        raise SystemExit(f"[edges] not every load width ran: {sorted(loads)}")


def float64_runs(gy, t_idx, t_sid, coeff, live, num_rows=None):
    """The float64 sum of each distinct index's terms over the live prefix
    of a sorted COO, the sum of the terms' magnitudes and their count:
    ``(uniq, exact, mass, count)``. ``num_rows`` drops out-of-range indices
    (full mode); without it every run counts (compressed mode)."""
    idx, sid = t_idx[:live], t_sid[:live].long()
    c = None if coeff is None else coeff[:live]
    if num_rows is not None:
        keep = (idx >= 0) & (idx < num_rows)
        idx, sid = idx[keep], sid[keep]
        c = None if c is None else c[keep]
    uniq, inv = torch.unique(idx, return_inverse=True)
    uniq = uniq.long()
    exact = torch.zeros((uniq.numel(), gy.shape[1]), dtype=torch.float64, device=gy.device)
    mass = torch.zeros_like(exact)
    for p0 in range(0, idx.numel(), 1 << 20):
        p1 = min(p0 + (1 << 20), idx.numel())
        terms = gy.index_select(0, sid[p0:p1]).double()
        if c is not None:
            terms *= c[p0:p1].double()[:, None]
        exact.index_add_(0, inv[p0:p1], terms)
        mass.index_add_(0, inv[p0:p1], terms.abs())
    count = torch.bincount(inv, minlength=uniq.numel()).double()[:, None]
    return uniq, exact, mass, count


def sum_bound(exact, mass, count, sum_bits, out_dtype):
    """The error bound of a recursive sum of ``count`` terms (and one
    product per term) with unit roundoff 2^-sum_bits, then one rounding to
    ``out_dtype``, about the float64 sum ``exact`` of terms whose
    magnitudes sum to ``mass``."""
    tiny = torch.finfo(out_dtype).tiny
    return ((count + 2) * (2.0**-sum_bits * mass + tiny)
            + 2.0**-BITS[out_dtype] * exact.abs())


def sum_error_ratio(got, exact, mass, count, sum_bits):
    """max |got - exact| over its bound (``sum_bound`` in ``got``'s type);
    at most 1 means within the bound."""
    if got.numel() == 0:
        return 0.0
    tol = sum_bound(exact, mass, count, sum_bits, got.dtype)
    return ((got.double() - exact).abs() / tol).max().item()


def adagrad_accum_bound(a0, exact, e):
    """The float64 row-wise AdaGrad accumulator ``a0 + mean(g^2)`` from the
    float64 row sums ``exact`` of fp32 sums within ``e`` of them, and the
    bound on an fp32 path's error there (the sums' error, the squares, the
    mean and the add): ``(a, da)``."""
    u, big = 2.0 ** -24, exact.abs() + e
    a = a0 + (exact * exact).mean(dim=1)
    da = ((2 * exact.abs() * e + e * e).mean(dim=1)
          + (exact.shape[1] + 3) * u * (a0 + (big * big).mean(dim=1)))
    return a, da


def check_accumulators(name, after, before, sums):
    """Row-wise AdaGrad accumulators after one step ({label: accumulator at
    the step's rows}) from ``before`` (at the same rows), held to the
    float64 accumulator from the row sums ``sums`` = (exact, mass, count)
    within ``adagrad_accum_bound`` plus one ulp. Returns the worst ratio."""
    exact, mass, count = sums
    a, da = adagrad_accum_bound(before.double(), exact,
                                sum_bound(exact, mass, count, 24, torch.float32))
    tol = da + ulp(a.float()).double()
    ratios = {k: ((v.double() - a).abs() / tol).max().item() if v.numel() else 0.0
              for k, v in after.items()}
    print(f"[{name}] accumulators against the float64 step, error over its bound (at most 1 "
          f"passes): {', '.join(f'{k} {v:.3g}' for k, v in ratios.items())}")
    if max(ratios.values()) > 1:
        raise SystemExit(f"[{name}] an accumulator is off the float64 step")
    return max(ratios.values())


def check_fp32_step(name, after, before, uniq, sums, lr, acc=None, eps=1e-8):
    """One sparse step of an fp32 table from ``before`` on each path of
    ``after`` ({label: table after}, one of them "plain path"), held to the
    float64 step from the float64 row sums ``sums`` = (exact, mass, count)
    of the rows ``uniq``: SGD, ``p - lr * g``, or with ``acc`` =
    (accumulator before, {label: accumulator after}) row-wise AdaGrad.

    Each path sums a row in fp32 in its own order (K3 once a run, the plain
    path by atomics). Where a column of a hot row cancels, that order moves
    the step by many ulps of the result, so a bound relative to the step
    does not hold there. Allowed: the step's change under the row sums'
    recursive-sum bound (``sum_bound``), the roundings of the update (of the
    accumulator, the square root and the scale), and one ulp of the result.
    Every other row (and its accumulator) must equal ``before``. Returns
    max |path - plain path| over the touched rows."""
    exact, mass, count = sums
    e = sum_bound(exact, mass, count, 24, torch.float32)
    g, big, u = exact, exact.abs() + e, 2.0 ** -24
    old = before[uniq].double()
    if acc is None:
        ref = old - lr * g
        tol = lr * e + 4 * u * lr * big
    else:
        acc_before, acc_after = acc
        a, da = adagrad_accum_bound(acc_before[uniq].double(), g, e)
        amin = (a - da).clamp(min=0) + eps
        smax = lr / torch.sqrt(amin)
        ds = lr * da / (2 * amin ** 1.5) + 4 * u * smax
        ref = old - (lr / torch.sqrt(a + eps))[:, None] * g
        tol = smax[:, None] * e + big * ds[:, None] + 4 * u * smax[:, None] * big
    tol = tol + ulp((ref.abs() + tol).float()).double()
    untouched = torch.ones(before.shape[0], dtype=torch.bool, device=before.device)
    untouched[uniq] = False
    ratios, ok = {}, True
    for label, t in after.items():
        ratios[label] = ((t[uniq].double() - ref).abs() / tol).max().item()
        ok = ok and torch.equal(t[untouched], before[untouched])
    acc_ratios = {}
    if acc is not None:
        for label, t in acc_after.items():
            acc_ratios[label] = ((t[uniq].double() - a).abs()
                                 / (da + ulp(a.float()).double())).max().item()
            ok = ok and torch.equal(t[untouched], acc_before[untouched])
    want = after["plain path"][uniq]
    err = max(max_abs_err(t[uniq], want) for t in after.values())
    print(f"[{name}] {uniq.numel()} rows against the float64 step, error over its bound "
          f"(at most 1 passes): {', '.join(f'{k} {v:.3g}' for k, v in ratios.items())}"
          + (f"; accumulators: {', '.join(f'{k} {v:.3g}' for k, v in acc_ratios.items())}"
             if acc is not None else "")
          + f"; max |K3 path - plain path| {err}; untouched rows "
          f"{'equal' if ok else 'CHANGED'}")
    if not ok or max(ratios.values()) > 1 or max(acc_ratios.values(), default=0) > 1:
        raise SystemExit(f"[{name}] a path is off the float64 step")
    return err


def check_full_grad(name, got, init, uniq, exact, mass, count, sum_bits):
    """A full gradient against float64 sums: the touched rows within the
    bound, every other row equal to its initial value (zero without one).
    Returns the ratio of the worst error to its bound."""
    base = None if init is None else init[uniq].double()
    ratio = sum_error_ratio(
        got[uniq], exact if base is None else exact + base,
        mass if base is None else mass + base.abs(), count + (base is not None), sum_bits)
    if init is None:
        untouched_ok = int(torch.count_nonzero(got)) == int(torch.count_nonzero(got[uniq]))
    else:
        rest = got.clone()
        rest[uniq] = init[uniq]
        untouched_ok = torch.equal(rest, init)
    if ratio > 1 or not untouched_ok:
        raise SystemExit(f"[{name}] gradient off: error/bound {ratio}, untouched rows "
                         f"{'ok' if untouched_ok else 'changed'}")
    return ratio


def shifted(t, shift_bytes):
    """``t`` copied into a view that starts ``shift_bytes`` into its
    storage: a narrower alignment for K3's copy route."""
    shift = shift_bytes // t.element_size()
    base = torch.zeros(t.numel() + shift, dtype=t.dtype, device=t.device)
    view = base[shift:].view(t.shape)
    view.copy_(t)
    return view


def backward_problem(gen, batch, hotness, V, width, dtype, index_dtype, weighted,
                     integer, long_run, shift=0):
    """An index-sorted COO of a fixed-hotness batch with BWD_PAD sentinel
    entries, grad_y rows (a view ``shift`` bytes into its storage), weights
    and an initial gradient. Integer-exact data keeps every partial sum
    exact in fp32 and in the half types (values in {-1, 0, 1}, seven in
    eight of them 0 for fp16/bf16, weights in {0.5, 1}); otherwise normal
    reals and U(0, 1) weights."""
    n = batch * hotness
    idx = torch.randint(0, V, (n,), device="cuda", generator=gen)
    idx[:long_run] = V // 2
    sid = torch.arange(n, device="cuda") // max(hotness, 1)
    order = torch.sort(idx, stable=True).indices
    t_idx = torch.cat([idx[order], torch.full((BWD_PAD,), SENTINEL, device="cuda")])
    t_sid = torch.cat([sid[order], torch.zeros(BWD_PAD, dtype=sid.dtype, device="cuda")])
    t_idx, t_sid = t_idx.to(index_dtype), t_sid.to(torch.int32)
    if integer:
        vmax = 8 if dtype == torch.float32 else 1
        gy = torch.randint(-vmax, vmax + 1, (batch, width), device="cuda", generator=gen)
        init = torch.randint(-2, 3, (V, width), device="cuda", generator=gen)
        if dtype != torch.float32:
            gy *= torch.rand((batch, width), device="cuda", generator=gen) < 0.125
        w = torch.tensor([0.5, 1.0], device="cuda")[
            torch.randint(0, 2, t_idx.shape, device="cuda", generator=gen)]
    else:
        gy = torch.randn((batch, width), device="cuda", generator=gen)
        init = torch.randn((V, width), device="cuda", generator=gen)
        w = torch.rand(t_idx.shape, device="cuda", generator=gen)
    return shifted(gy.to(dtype), shift), t_idx, t_sid, w if weighted else None, init.to(dtype)


def phase_backward_grid():
    """K3 against its plain version over the backward grid, full and
    compressed, with sentinel padding, an nnz prefix and an initial
    gradient, and on misaligned grad_y views (BWD_ROUTES). Integer-exact
    data: bit for bit. Random reals: each within its recursive-sum bound of
    a float64 sum (K3 sums in fp32, the plain version in grad_y's type).
    Every case launches K3 twice and needs the same bits both times, and
    every copy route must have launched."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    cases, failures, routes, slices = 0, [], {}, 1
    worst = {"bitwise": 0.0, "k3 bound": 0.0, "plain bound": 0.0}
    specs = [(shape, dtype, 0) for shape in BWD_SHAPES
             for dtype in (torch.float32, torch.float16, torch.bfloat16)]
    specs += [(shape, dtype, shift) for shape in BWD_ROUTE_SHAPES
              for dtype, shift in BWD_ROUTES]
    for ((batch, hotness, V, width), dtype, shift), index_dtype, weighted, integer in (
            itertools.product(specs, (torch.int32, torch.int64), (False, True), (True, False))):
        long_run = LONG_RUN if batch * hotness > LONG_RUN else 0
        gy, t_idx, t_sid, w, init = backward_problem(
            gen, batch, hotness, V, width, dtype, index_dtype, weighted,
            integer, long_run, shift)
        if batch * hotness:
            vec = cuda_backward.vec_bytes(gy, init)
            route = cuda_backward.ROUTES[vec]
            routes[route] = routes.get(route, 0) + 1
            slices = max(slices, cuda_backward.launch_shape(
                dtype, width, vec=vec)["slices"])
        n = batch * hotness
        variants = [("full", None, None), ("prefix", max(n - 5, 0), None),
                    ("init", n, init)]
        variants += [("compressed", None, "c"),
                     ("compressed prefix", max(n - 5, 0), "c")]
        for label, nnz, extra in variants:
            cases += 1
            compressed = extra == "c"
            start = None if compressed or extra is None else extra
            live = t_idx.shape[0] if nnz is None else nnz
            if compressed:
                runs = [cuda_backward.embedding_backward_cuda_compressed(
                    gy, t_idx, t_sid, w, nnz=nnz) for _ in range(2)]
                want = plain_bwd_c(gy, t_idx, t_sid, w, nnz=nnz)
                # Only the first num_unique entries are K3's output.
                nu = int(want.num_unique)
                got, again = runs[0].rows[:nu], runs[1].rows[:nu]
                ok = (torch.equal(got, again)
                      and int(runs[0].num_unique) == nu
                      and torch.equal(runs[0].unique_indices[:nu],
                                      want.unique_indices[:nu]))
                want = want.rows[:nu]
            else:
                got, again = (cuda_backward.embedding_backward_cuda(
                    gy, V, t_idx, t_sid, w, nnz=nnz,
                    initial_grad=None if start is None else start.clone())
                    for _ in range(2))
                want = plain_bwd(gy, V, t_idx, t_sid, w, nnz=nnz,
                                 initial_grad=None if start is None
                                 else start.clone())
                ok = torch.equal(got, again)
            if integer:
                err = max_abs_err(got, want)
                worst["bitwise"] = max(worst["bitwise"], err)
                ok = ok and torch.equal(got, want)
            else:
                uniq, exact, mass, count = float64_runs(
                    gy, t_idx, t_sid, w, live, None if compressed else V)
                if compressed:
                    nu = uniq.numel()
                    k3 = sum_error_ratio(got[:nu], exact, mass, count, 24)
                    pl = sum_error_ratio(want[:nu], exact, mass, count,
                                         BITS[dtype])
                    ok = ok and got.shape[0] == nu
                else:
                    try:
                        k3 = check_full_grad("grid", got, start, uniq, exact,
                                             mass, count, 24)
                        pl = check_full_grad("grid", want, start, uniq,
                                             exact, mass, count, BITS[dtype])
                    except SystemExit:
                        k3 = pl = float("inf")
                worst["k3 bound"] = max(worst["k3 bound"], k3)
                worst["plain bound"] = max(worst["plain bound"], pl)
                ok = ok and k3 <= 1 and pl <= 1
            torch.cuda.synchronize()
            if not ok:
                failures.append((batch, hotness, V, width, str(dtype), shift,
                                 str(index_dtype), weighted, integer, label))
    print(f"[backward grid] {cases} cases, each launched twice with the same bits: "
          f"max |K3 - plain| {worst['bitwise']} on integer-exact data (bitwise); on "
          f"random reals the worst error over its recursive-sum bound is "
          f"{worst['k3 bound']:.3g} for K3 (fp32 sums) and {worst['plain bound']:.3g} for "
          f"the plain version (sums in grad_y's type); at most 1 passes")
    print(f"[backward grid] problems by K3's copy route: {routes}; up to {slices} column "
          f"slices a row")
    for f in failures[:20]:
        print(f"[backward grid] MISMATCH {f}")
    if failures:
        raise SystemExit(f"[backward grid] {len(failures)} of {cases} cases disagree")
    if set(routes) != set(cuda_backward.ROUTES.values()) or slices < 3:
        raise SystemExit(f"[backward grid] not every copy route or slice count ran: {routes}")
    return worst["bitwise"]


def flagship_exact(idx, flat, offsets, gen):
    """K3 against its plain version at the main path's sorted COOs (the
    fixed batch, the weighted CSR batch and CONCAT), full and compressed
    mode, each launched twice. grad_y is integer-valued fp32 with |g| <= 8
    and the CSR coefficients are 0.5 or 1, so every partial sum of a run is
    a multiple of 0.5 below 2^22 and exact in fp32, whatever the order:
    both must give the same bits, the fix-up of the runs that cross tile
    edges included. Returns max |K3 - plain| (0 when it passes)."""
    kb, kc = cuda_backward.embedding_backward_cuda, cuda_backward.embedding_backward_cuda_compressed
    nnz = int(offsets[-1])
    w = torch.tensor([0.5, 1.0], device="cuda")[
        torch.randint(0, 2, flat.shape, device="cuda", generator=gen)]
    cases = (("fixed", (*fixed_coo(idx), None), BATCH, None),
             ("csr weighted", csr_coo(flat, offsets, w, tce.CombineMode.SUM), BATCH, nnz),
             ("concat", (*fixed_coo(idx, tce.CombineMode.CONCAT), None),
              BATCH * HOTNESS, None))
    err = 0.0
    for name, (t_idx, t_sid, t_c), rows, n in cases:
        live = t_idx.numel() if n is None else n
        runs = torch.unique_consecutive(t_idx[:live], return_counts=True)[1]
        longest = int(runs.max())
        if longest * 8 >= 1 << 22:
            raise SystemExit(f"[{name} exact] a run of {longest} could round")
        gy = torch.randint(-8, 9, (rows, WIDTH), device="cuda", generator=gen).float()
        got = kb(gy, NUM_ROWS, t_idx, t_sid, t_c, nnz=n)
        same = torch.equal(got, kb(gy, NUM_ROWS, t_idx, t_sid, t_c, nnz=n))
        want = plain_bwd(gy, NUM_ROWS, t_idx, t_sid, t_c, nnz=n)
        full_err = max_abs_err(got, want)
        full_ok = same and torch.equal(got, want)
        del got, want
        got = kc(gy, t_idx, t_sid, t_c, nnz=n)
        again = kc(gy, t_idx, t_sid, t_c, nnz=n)
        want = plain_bwd_c(gy, t_idx, t_sid, t_c, nnz=n)
        nu = runs.numel()  # only the first num_unique entries are K3's output
        comp_err = max_abs_err(got.rows[:nu], want.rows[:nu])
        comp_ok = (torch.equal(got.rows[:nu], again.rows[:nu])
                   and torch.equal(got.rows[:nu], want.rows[:nu])
                   and torch.equal(got.unique_indices[:nu], want.unique_indices[:nu])
                   and int(got.num_unique) == int(want.num_unique) == nu)
        del got, again, want, gy
        torch.cuda.empty_cache()
        print(f"[{name} exact] {live} sorted positions in {runs.numel()} runs, the "
              f"longest {longest} ({-(-longest // cuda_backward.TILE)} tiles), "
              f"{int((runs > cuda_backward.TILE).sum())} longer than a tile; integer "
              f"grad_y: max |K3 - plain| {full_err} (full), {comp_err} (compressed); "
              f"two launches {'equal' if same else 'DIFFERENT'}")
        if not (full_ok and comp_ok):
            raise SystemExit(f"[{name} exact] K3 is not bit for bit the plain version")
        err = max(err, full_err, comp_err)
    return err


def compact_grad(grad, touched):
    """What the checks need of a [V, W] gradient: its rows at the touched
    indices, and the number of its nonzero elements."""
    return grad[touched], int(torch.count_nonzero(grad))


def check_compact(name, compact, exact, mass, count, sum_bits):
    """A compacted full gradient against float64 sums of its touched rows:
    within the bound, and no nonzero element elsewhere. Returns the ratio of
    the worst error to its bound."""
    rows, nonzero = compact
    ratio = sum_error_ratio(rows, exact, mass, count, sum_bits)
    in_rows = int(torch.count_nonzero(rows))
    if ratio > 1 or nonzero != in_rows:
        raise SystemExit(f"[{name}] gradient off: error/bound {ratio}, nonzero elements "
                         f"{nonzero} against {in_rows} in touched rows")
    return ratio


def fixed_coo(idx, mode=tce.CombineMode.SUM):
    """The sorted COO the lookup's backward builds for a fixed batch."""
    batch, hotness = idx.shape
    pos = torch.arange(batch * hotness, dtype=torch.int32, device=idx.device)
    sid = pos if mode == tce.CombineMode.CONCAT else pos // hotness
    t_idx, t_sid, _ = transpose_position_ordered(sid, idx.reshape(-1))
    return t_idx, t_sid


def csr_coo(flat, offsets, weights, mode):
    """The sorted COO (with coefficients) of a CSR batch, as the lookup's
    backward builds it: padding sorts last as the sentinel."""
    live = torch.arange(flat.numel(), device=flat.device) < offsets[-1]
    idx = torch.where(live, flat, torch.full_like(flat, SENTINEL))
    sid = tce.extract_row_ids_from_csr(offsets, flat).to(torch.int32)
    coeff = live.float() if weights is None else weights * live
    if mode == tce.CombineMode.MEAN:
        hot = (offsets[1:] - offsets[:-1]).float()
        coeff = coeff * torch.where(hot == 0, 0.0, 1.0 / hot.clamp(min=1.0))[sid.long()]
    return transpose_position_ordered(sid, idx, coeff)


def timed(fn):
    """fn() and its host time in ms, to a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def dense_loss(out):
    return (out.float() ** 2).sum() * 1e-9


def sparse_loss(pooled):
    return 0.5 * (pooled.float() ** 2).sum()


def drive_training(bag, idx, flat, offsets, csr_w):
    """The training path, counted: dense SGD steps through autograd,
    row-wise AdaGrad and sparse SGD steps, and the CSR and CONCAT backward.
    Keeps what the checks outside the counted region need."""
    keep = {"dense_ms": [], "adagrad_ms": []}
    table = bag.weight.data
    touched = torch.unique(idx)
    csr_touched = torch.unique(flat[:int(offsets[-1])])
    # (a) Dense steps: K1, transpose, K3 full, torch.optim.SGD.
    keep["w0"] = table.clone()
    opt = torch.optim.SGD(bag.parameters(), lr=1e-6)
    for step in range(DENSE_STEPS):
        gys = []

        def dense_step():
            opt.zero_grad(set_to_none=True)
            out = bag(idx)
            out.register_hook(gys.append)
            loss = dense_loss(out)
            loss.backward()
            opt.step()
            return loss
        loss, ms = timed(dense_step)
        keep["dense_ms"].append(ms)
        if not torch.isfinite(loss):
            raise SystemExit(f"[dense step] loss {loss.item()} at step {step + 1}")
        if step == 0:
            keep["dense"] = (compact_grad(bag.weight.grad, touched), gys[0])
    bag.weight.grad = None
    del opt
    torch.cuda.empty_cache()
    # (b) Row-wise AdaGrad steps: K1 under no_grad, embedding_grad_y, K3
    # compressed; then one sparse SGD step.
    accum = train.rowwise_adagrad_init(NUM_ROWS, device="cuda")
    for step in range(ADAGRAD_STEPS):
        if step in (0, ADAGRAD_STEPS - 1):
            keep[f"adagrad_in{step}"] = (table.clone(), accum.clone())

        def adagrad_step():
            with torch.no_grad():
                pooled = bag(idx)
            gy = train.embedding_grad_y(sparse_loss, pooled)
            train.rowwise_adagrad_sparse_update(table, accum, idx, gy, lr=ADAGRAD_LR)
        _, ms = timed(adagrad_step)
        keep["adagrad_ms"].append(ms)
        if step == 0:
            keep["adagrad_out0"] = (table[touched], accum.clone())
    keep["adagrad_out_last"] = (table.clone(), accum)
    with torch.no_grad():
        gy = train.embedding_grad_y(sparse_loss, bag(idx))
    train.sgd_sparse_update(table, idx, gy, lr=SGD_LR)
    keep["sgd_gy"] = gy
    torch.cuda.empty_cache()
    # (c) CSR backward, weighted SUM and MEAN: K2, transpose, K3 full, and
    # the weights gradient.
    for mode in (tce.CombineMode.SUM, tce.CombineMode.MEAN):
        w = csr_w.clone().requires_grad_() if mode == tce.CombineMode.SUM else None
        gys = []
        out = tce.embedding_lookup_csr(bag.weight, flat, offsets, w, mode=mode)
        out.register_hook(gys.append)
        dense_loss(out).backward()
        keep[f"csr_{mode.value}"] = (compact_grad(bag.weight.grad, csr_touched),
                                     None if w is None else w.grad, gys[0])
        bag.weight.grad = None
        torch.cuda.empty_cache()
    # (d) CONCAT backward: index_select forward, K3 full over one grad_y row
    # per position.
    gys = []
    out = tce.embedding_lookup(bag.weight, idx, mode=tce.CombineMode.CONCAT)
    out.register_hook(gys.append)
    dense_loss(out).backward()
    keep["concat"] = (compact_grad(bag.weight.grad, touched), gys[0])
    bag.weight.grad = None
    return keep


def plain_grad(lookup, table, *args, weights=None, **kw):
    """The table (and weights) gradient of dense_loss on the plain path."""
    leaf = table.detach().clone().requires_grad_()
    wl = None if weights is None else weights.detach().clone().requires_grad_()
    dense_loss(lookup(leaf, *args, wl, backend="xla", **kw)).backward()
    return leaf.grad, None if wl is None else wl.grad


def check_grad(name, got, gy, coo, live, plain_args, touched, plain_kw=None):
    """A gradient of the K3 path, and the plain path's on the same inputs,
    each against float64 sums. Returns max |K3 path - plain path|."""
    t_idx, t_sid, t_c = coo
    _, exact, mass, count = float64_runs(gy.float(), t_idx, t_sid, t_c, live, NUM_ROWS)
    want, want_w = plain_grad(*plain_args, **(plain_kw or {}))
    want = compact_grad(want, touched)
    k3 = check_compact(name, got, exact, mass, count, 24)
    pl = check_compact(f"{name}, plain path", want, exact, mass, count, 24)
    err = max_abs_err(got[0], want[0])
    print(f"[{name}] gradient error/bound {k3:.3g} (K3 path), {pl:.3g} (plain path; "
          f"both sum in fp32, bound at 1); max |K3 path - plain path| {err}")
    return err, want_w


def check_training(bag, idx, flat, offsets, csr_w, keep):
    """Every result of the training path against the plain path
    (``backend="xla"``) on the same inputs, the gradients also against
    float64 sums. Returns max |K3 path - plain path| over the gradients."""
    touched = torch.unique(idx)
    nnz = int(offsets[-1])
    csr_touched = torch.unique(flat[:nnz])
    # (a) The first dense step's gradient.
    got, gy = keep.pop("dense")
    t_idx, t_sid = fixed_coo(idx)
    err, _ = check_grad("dense step 1", got, gy, (t_idx, t_sid, None), t_idx.numel(),
                        (tce.embedding_lookup, keep.pop("w0"), idx), touched)

    # (b) AdaGrad after its first and its last step, and the sparse SGD
    # step, each from the same inputs on the plain path (the tables as
    # check_sparse_step says). The accumulator, mean(G^2) of the same fp32
    # sums taken in two orders: 1e-4 relative.
    for step in (0, ADAGRAD_STEPS - 1):
        tbl, acc = keep.pop(f"adagrad_in{step}")
        old = tbl[touched]
        with torch.no_grad():
            pooled = tce.embedding_lookup(tbl, idx, backend="xla")
        gy = train.embedding_grad_y(sparse_loss, pooled)
        train.rowwise_adagrad_sparse_update(tbl, acc, idx, gy, lr=ADAGRAD_LR,
                                            backend="xla")
        got_table, got_accum = keep.pop("adagrad_out0" if step == 0 else "adagrad_out_last")
        check_sparse_step(f"adagrad step {step + 1}", got_table, tbl, old, touched)
        rel_a = ((got_accum - acc).abs() / acc.abs().clamp(min=1e-30)).max().item()
        print(f"[adagrad step {step + 1}] accumulator max relative difference "
              f"{rel_a:.3g} (1e-4 allowed); {int(acc.count_nonzero())} rows have state")
        if not torch.allclose(got_accum, acc, rtol=1e-4, atol=1e-12):
            raise SystemExit(f"[adagrad] step {step + 1}: the accumulator disagrees")
        if step == ADAGRAD_STEPS - 1:
            # The sparse SGD step, from the K3 path's table after AdaGrad.
            old = got_table[touched]
            train.sgd_sparse_update(got_table, idx, keep.pop("sgd_gy"), lr=SGD_LR,
                                    backend="xla")
            check_sparse_step("sgd sparse", bag.weight.data, got_table, old, touched)
        del tbl, acc, got_table, old

    # (c) CSR, weighted SUM and MEAN; the weights gradient is the same code
    # on the same inputs on both paths, so it must be bit for bit the same.
    for mode in (tce.CombineMode.SUM, tce.CombineMode.MEAN):
        got, wgrad, gy = keep.pop(f"csr_{mode.value}")
        w = csr_w if mode == tce.CombineMode.SUM else None
        e, want_w = check_grad(
            f"csr {mode.value}", got, gy, csr_coo(flat, offsets, w, mode), nnz,
            (tce.embedding_lookup_csr, bag.weight, flat, offsets), csr_touched,
            {"weights": w, "mode": mode})
        err = max(err, e)
        if w is not None:
            if not torch.equal(wgrad, want_w):
                raise SystemExit("[csr sum] the weights gradient differs from the plain path")
            print("[csr sum] weights gradient equal to the plain path's")

    # (d) CONCAT.
    got, gy = keep.pop("concat")
    t_idx, t_sid = fixed_coo(idx, tce.CombineMode.CONCAT)
    e, _ = check_grad("concat", got, gy, (t_idx, t_sid, None), t_idx.numel(),
                      (tce.embedding_lookup, bag.weight, idx), touched,
                      {"mode": tce.CombineMode.CONCAT})
    return max(err, e)


def compare_in_chunks(out, table, idx, offsets=None, weights=None, **kw):
    """Max |out - plain| over the batch, in chunks of batch rows; fails
    unless within tolerance."""
    err = 0.0
    batch = out.shape[0]
    for s0 in range(0, batch, COMPARE_ROWS):
        s1 = min(batch, s0 + COMPARE_ROWS)
        if offsets is None:
            want = plain(table, idx[s0:s1], None,
                         None if weights is None else weights[s0:s1], **kw)
        else:  # offsets stay absolute positions into the whole index array
            want = plain(table, idx, offsets[s0:s1 + 1], weights, **kw)
        got = out[s0:s1]
        if not torch.isfinite(got).all() or not within_tolerance(got, want):
            raise SystemExit(f"output rows {s0}:{s1} disagree with the plain version")
        err = max(err, max_abs_err(got, want))
    return err


def check_lookup_plain(name, outs, table, idx, weights=None, mode=tce.CombineMode.SUM,
                       hot=None):
    """Lookups of a fixed batch ({label: output}) and the plain version on
    the same table and ids, each held to the float64 combine within the
    row sums' recursive-sum bound (``sum_bound``); in chunks of batch rows.
    With ``hot`` the lookups are a hybrid table's (SUM only): its head
    (rows below ``hot``) and its tail each round their partial sum to the
    table's type before the two are added, so the plain version is the same
    split, a plain head lookup and a plain tail lookup rounded the same way,
    and the bound gains one rounding of the terms' magnitudes a part. The
    hybrid's difference from the plain lookup of the whole table is printed
    on its own line. Returns max |output - plain| at the same arithmetic."""
    hotness = idx.shape[1]
    if hot is not None and mode != tce.CombineMode.SUM:
        raise ValueError("a hybrid lookup is checked in SUM mode")
    ratios, err, split_err = dict.fromkeys(list(outs) + ["plain path"], 0.0), 0.0, 0.0
    for s0 in range(0, idx.shape[0], COMPARE_ROWS):
        ids = idx[s0:s0 + COMPARE_ROWS]
        w = None if weights is None else weights[s0:s0 + COMPARE_ROWS]
        want = plain(table, ids, None, w, mode=mode)
        rows = table.index_select(0, ids.reshape(-1).long()).double().view(
            *ids.shape, table.shape[1])
        c = torch.ones(ids.shape, dtype=torch.float64, device=ids.device)
        if w is not None:
            c = w.double()
        if mode == tce.CombineMode.MEAN:
            c = c / hotness
        terms = rows * c[..., None]
        exact, mass = terms.sum(dim=1), terms.abs().sum(dim=1)
        bound = sum_bound(exact, mass, hotness, 24, table.dtype)
        chunk = {label: out[s0:s0 + COMPARE_ROWS] for label, out in outs.items()}
        if hot is not None:
            bound = bound + 2 * 2.0 ** -BITS[table.dtype] * mass
            is_hot = ids < hot
            cw = torch.ones(ids.shape, dtype=torch.float32, device=ids.device) if w is None else w
            head = plain(table[:hot], torch.where(is_hot, ids, torch.zeros_like(ids)), None,
                         torch.where(is_hot, cw, torch.zeros_like(cw)))
            tail = plain(table, ids, None, torch.where(is_hot, torch.zeros_like(cw), cw))
            whole, want = want, (head.float() + tail.float()).to(table.dtype)
            split_err = max(split_err, max(max_abs_err(got, whole) for got in chunk.values()))
        for label, got in list(chunk.items()) + [("plain path", want)]:
            if not torch.isfinite(got).all():
                raise SystemExit(f"[{name}] {label}: a non-finite output")
            ratios[label] = max(ratios[label],
                                ((got.double() - exact).abs() / bound).max().item())
            err = max(err, max_abs_err(got, want))
    print(f"[{name}] {idx.shape[0]} x {hotness} against the float64 combine, error over its "
          f"bound (at most 1 passes): {', '.join(f'{k} {v:.3g}' for k, v in ratios.items())}"
          f"; max |kernel path - plain path| {err}")
    if hot is not None:
        print(f"[{name}] hybrid (head and tail rounded apart) against the plain lookup of the "
              f"whole table: max |difference| {split_err} (the split's roundings, within "
              f"the bound above)")
    if max(ratios.values()) > 1:
        raise SystemExit(f"[{name}] a lookup is off the float64 combine")
    return err


def timings(name, kernel_fn, plain_fn, library_fn, bound, app_bytes):
    k = bench.cuda_time_ms(kernel_fn)
    p = bench.cuda_time_ms(plain_fn, warmup=1, iters=5)
    lib = bench.cuda_time_ms(library_fn)
    print(f"[{name}] kernel {k:.4f} ms (PR 3: {PR3_FWD_MS[name[:-5]]} ms), "
          f"{app_bytes / k / 1e6:.1f} app GB/s; "
          f"plain {p:.4f} ms; F.embedding_bag {lib:.4f} ms; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
          f"{bound['unique_rows']} unique rows, {bound['bytes']} bytes at {HBM_PEAK}), "
          f"kernel at {bound['bound_ms'] / k:.1%} of the bound")
    return {"ms": k, "plain_ms": p, "library_ms": lib, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"]}


def serve(bag, batches, name):
    times = []
    with torch.inference_mode():
        for idx in batches:
            t0 = time.perf_counter()
            out = bag(idx)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(times)
    print(f"[{name}] {len(batches)} requests of {tuple(batches[0].shape)}: host ms "
          f"{[round(t, 4) for t in times]}, median {median:.4f}")
    return out, median


def backward_timings(table, idx, flat, offsets, csr_w, gy):
    """K3 at the flagship shapes, timed beside its plain version,
    ``F.embedding_bag``'s backward and its bound; the transpose; and K3's
    compressed result held to float64 sums at that size."""
    V, nnz = NUM_ROWS, int(offsets[-1])
    kb, kc = cuda_backward.embedding_backward_cuda, cuda_backward.embedding_backward_cuda_compressed
    t_idx, t_sid = fixed_coo(idx)
    live = t_idx.numel()
    gy32 = gy.float()
    nu = int(torch.unique(idx).numel())
    # Full mode, into a zeroed buffer (initial_grad): the kernel's own work.
    buf = torch.zeros((V, WIDTH), dtype=torch.float32, device="cuda")
    bound = bench.backward_bound(gy_rows=BATCH, width=WIDTH, elem_bytes=4, live=live,
                                 index_bytes=8, num_unique=nu, weighted=False,
                                 compressed=False)
    k = bench.cuda_time_ms(lambda: kb(gy32, V, t_idx, t_sid, initial_grad=buf))
    p = bench.cuda_time_ms(lambda: plain_bwd(gy32, V, t_idx, t_sid, initial_grad=buf),
                           warmup=1, iters=5)
    zero = bench.cuda_time_ms(lambda: torch.zeros((V, WIDTH), device="cuda"), iters=5)
    del buf
    # The library yardstick: F.embedding_bag's backward on an fp32 table
    # that requires grad, for the same dense gradient (it allocates and
    # zeroes its own output).
    tbl32 = table.float().requires_grad_()
    out = F.embedding_bag(idx, tbl32, mode="sum")
    lib = bench.cuda_time_ms(
        lambda: torch.autograd.grad(out, tbl32, gy32, retain_graph=True), iters=10)
    del tbl32, out
    app = bench.backward_app_bytes(nnz=live, batch=BATCH, width=WIDTH, num_unique=nu,
                                   elem_bytes=4, index_bytes=8)
    print(f"[K3 full] fixed flagship (fp32 grad_y [{BATCH}, {WIDTH}], {live} sorted "
          f"positions, {nu} distinct rows): kernel {k:.4f} ms into a zeroed buffer "
          f"(PR 2: {PR2_K3_MS['full']} ms), "
          f"{app / k / 1e6:.1f} app GB/s; plain {p:.4f} ms; F.embedding_bag backward "
          f"{lib:.4f} ms (with its own zeroed output); zeroing the [{V}, {WIDTH}] fp32 "
          f"gradient alone {zero:.4f} ms; bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}: {bound['bytes']} bytes at {HBM_PEAK}), kernel at "
          f"{bound['bound_ms'] / k:.1%} of the bound")
    k3 = {"ms": k, "plain_ms": p, "library_ms": lib, "bound_ms": bound["bound_ms"],
          "bound_by": bound["bound_by"]}

    # Full mode as the dense step runs it: the bf16 grad_y as it is, into a
    # zeroed bf16 gradient.
    buf = torch.zeros((V, WIDTH), dtype=gy.dtype, device="cuda")
    khalf = bench.cuda_time_ms(lambda: kb(gy, V, t_idx, t_sid, initial_grad=buf))
    del buf
    hbound = bench.backward_bound(gy_rows=BATCH, width=WIDTH, elem_bytes=gy.element_size(),
                                  live=live, index_bytes=8, num_unique=nu, weighted=False,
                                  compressed=False)
    print(f"[K3 full] the dense step's call ({gy.dtype} grad_y and gradient): kernel "
          f"{khalf:.4f} ms (PR 2: {PR2_K3_MS['dense']} ms); bound "
          f"{hbound['bound_ms']:.4f} ms ({hbound['bytes']} bytes), "
          f"kernel at {hbound['bound_ms'] / khalf:.1%} of the bound")

    # Compressed mode, checked at this size against float64 sums.
    got = kc(gy32, t_idx, t_sid)
    _, exact, mass, count = float64_runs(gy32, t_idx, t_sid, None, live)
    ratio = sum_error_ratio(got.rows[:nu], exact, mass, count, 24)
    if int(got.num_unique) != nu or ratio > 1:
        raise SystemExit(f"[K3 compressed] off at the flagship size: num_unique "
                         f"{int(got.num_unique)} of {nu}, error/bound {ratio}")
    del got, exact, mass, count
    cbound = bench.backward_bound(gy_rows=BATCH, width=WIDTH, elem_bytes=4, live=live,
                                  index_bytes=8, num_unique=nu, weighted=False,
                                  compressed=True)
    kcm = bench.cuda_time_ms(lambda: kc(gy32, t_idx, t_sid), iters=10)
    pcm = bench.cuda_time_ms(lambda: plain_bwd_c(gy32, t_idx, t_sid), warmup=1, iters=3)
    print(f"[K3 compressed] fixed flagship: kernel {kcm:.4f} ms (into an unzeroed "
          f"[{live}, {WIDTH}] fp32 output; PR 2, into zeros: {PR2_K3_MS['compressed']} ms); "
          f"plain {pcm:.4f} ms; bound "
          f"{cbound['bound_ms']:.4f} ms for the touched rows ({cbound['bytes']} bytes); "
          f"error/bound against float64 sums {ratio:.3g}")

    # CSR, weighted: K3 full over the live prefix.
    c_idx, c_sid, c_w = csr_coo(flat, offsets, csr_w, tce.CombineMode.SUM)
    gyc = torch.randn((BATCH, WIDTH), device="cuda")
    cnu = int(torch.unique(flat[:nnz]).numel())
    buf = torch.zeros((V, WIDTH), dtype=torch.float32, device="cuda")
    kcsr = bench.cuda_time_ms(lambda: kb(gyc, V, c_idx, c_sid, c_w, nnz=nnz,
                                         initial_grad=buf))
    del buf
    csr_bound = bench.backward_bound(gy_rows=BATCH, width=WIDTH, elem_bytes=4, live=nnz,
                                     index_bytes=8, num_unique=cnu, weighted=True,
                                     compressed=False)
    print(f"[K3 full] CSR weighted flagship (nnz {nnz}, {cnu} distinct rows): kernel "
          f"{kcsr:.4f} ms (PR 2: {PR2_K3_MS['csr']} ms); bound {csr_bound['bound_ms']:.4f} ms "
          f"({csr_bound['bytes']} bytes), kernel at {csr_bound['bound_ms'] / kcsr:.1%}")

    # The transpose: K5 (the lookup's path), one stable torch.sort by index
    # (its plain route), and the general two-key sort; bound: the index and
    # sample-id streams read and written once.
    sid = torch.arange(live, dtype=torch.int32, device="cuda") // HOTNESS
    flat_idx = idx.reshape(-1)
    tk = bench.cuda_time_ms(lambda: cuda_transforms.coo_transpose_cuda(flat_idx, NUM_ROWS,
                                                                      hotness=HOTNESS))
    tp = bench.cuda_time_ms(lambda: transpose_position_ordered(sid, flat_idx))
    tg = bench.cuda_time_ms(lambda: transpose(sid, flat_idx))
    tbytes = live * (8 + 4) * 2
    print(f"[transpose] {live} positions: K5 {tk:.4f} ms (the lookup's path), one stable "
          f"sort by index {tp:.4f} ms, two-key {tg:.4f} ms; bound "
          f"{tbytes / bench.H100_HBM_BYTES_PER_S * 1e3:.4f} ms ({tbytes} bytes); "
          f"reference app bytes {bench.transpose_app_bytes(nnz=live, index_bytes=8)}")
    return k3


def device_breakdown(label, fn, top=8):
    """One call of fn under torch.profiler: device time by kernel (the top
    ones), their sum against the host time of the call (the device's idle
    share), printed on one line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, host_ms = timed(fn)
    # Kernels and memsets; not the annotations of regions ("...#..."), whose
    # device time is that of the kernels inside them.
    kernels = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0
               and "#" not in e.key]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    parts = "; ".join(f"{name[:60]} x{n} {ms:.4f}" for name, ms, n in kernels[:top])
    print(f"[{label} profile] host {host_ms:.4f} ms, device busy {busy:.4f} ms "
          f"(idle {1 - busy / host_ms:.1%}); top kernels (ms): {parts}")


def step_timings(bag, idx, steps=5):
    """Host ms of a dense step (autograd + torch.optim.SGD) and of a
    row-wise AdaGrad step, each to a synchronize, after two warm-up steps;
    medians of ``steps``."""
    opt = torch.optim.SGD(bag.parameters(), lr=1e-6)
    accum = train.rowwise_adagrad_init(NUM_ROWS, device="cuda")
    table = bag.weight.data

    def dense_step():
        opt.zero_grad(set_to_none=True)
        dense_loss(bag(idx)).backward()
        opt.step()

    def adagrad_step():
        with torch.no_grad():
            pooled = bag(idx)
        gy = train.embedding_grad_y(sparse_loss, pooled)
        train.rowwise_adagrad_sparse_update(table, accum, idx, gy, lr=ADAGRAD_LR)
    out = {}
    for name, fn in (("dense step", dense_step), ("adagrad step", adagrad_step)):
        times = [timed(fn)[1] for _ in range(steps + 2)][2:]
        out[name] = statistics.median(times)
        print(f"[{name}] host ms {[round(t, 4) for t in times]}, median {out[name]:.4f}")
        device_breakdown(name, fn)
    bag.weight.grad = None
    return out


# K4 at the flagship's shapes (BASELINE.json config 2's table and ids) and
# at the DLRM-v2 table with the most ids (portbench's dlrmv2-criteo-mh,
# feature 21: 40M x 128, hotness 100, alpha 1.05), fp16 as portbench's
# cells store them: (label, rows, width, hotness, alpha).
K4_SHAPES = (("flagship 10M x 256 fp16, hotness 64", NUM_ROWS, WIDTH, HOTNESS, ALPHA),
             ("DLRM-v2 feature 21: 40M x 128 fp16, hotness 100", 40_000_000, 128, 100, 1.05))
K4_GRAD_SCALE = 0.01  # grad_y ~ N(0, 0.01^2), portbench's train traffic


def k4_bound_ms(rows, width, elem, index_bytes):
    """K4's least time for ``rows`` applied rows at the data sheet's HBM
    rate: each reads its fp32 gradient row, its index and its accumulator,
    and reads and writes its table row and accumulator."""
    return rows * (width * (4 + 2 * elem) + index_bytes + 8) / bench.H100_HBM_BYTES_PER_S * 1e3


def replaced_chain(table, accum, cg, lr, eps=1e-8):
    """The torch ops K4 replaced (the update before it): the count and the
    in-range runs read back to the host, then the gathers, the mean,
    ``index_copy_``, the root, the scale, the cast and ``index_add_``."""
    nu = min(int(cg.num_unique), cg.rows.shape[0])
    rows, uniq = cg.rows[:nu], cg.unique_indices[:nu]
    keep = torch.nonzero((uniq >= 0) & (uniq < table.shape[0]))[:, 0]
    rows, uniq = rows.index_select(0, keep), uniq.index_select(0, keep).long()
    new_acc = accum.index_select(0, uniq) + (rows * rows).mean(dim=1)
    accum.index_copy_(0, uniq, new_acc)
    scale = -lr / torch.sqrt(new_acc + eps)
    table.index_add_(0, uniq, (rows * scale[:, None]).to(table.dtype))


def phase_k4(gen):
    """K4 against the plain version at ``K4_SHAPES``: K3's compressed sums of
    a power-law batch (its buffers unzeroed, as the update leaves them), then
    one K4 launch (counted) and the plain apply on the same state; the
    touched rows' accumulators within 1e-6 and their table rows within one
    fp16 spacing of the step and one of the result (the two take a row's
    sum of squares in other orders), no NaN, and a sample of the untouched
    rows unchanged. Then K4 timed beside its bound (the applied rows'
    bytes at the data sheet's rate), the plain apply and the torch ops it
    replaced. Returns (the worst error over its bound, the flagship's
    times)."""
    worst, flagship_t = 0.0, None
    for label, rows, width, hotness, alpha in K4_SHAPES:
        table = torch.empty((rows, width), dtype=torch.float16, device="cuda")
        table.uniform_(-width ** -0.5, width ** -0.5, generator=gen)
        accum = torch.rand(rows, device="cuda", generator=gen)
        perm = torch.randperm(rows, device="cuda", generator=gen)
        ids = perm[card_ids(rows, hotness, alpha, gen)]
        del perm
        gy = torch.randn((BATCH, width), device="cuda", generator=gen) * K4_GRAD_SCALE
        cg = train._compressed_sums(table, ids, gy, None, None, tce.CombineMode.SUM, "auto",
                                    drop_zero_coeff=True)
        nu = int(cg.num_unique)
        uniq = cg.unique_indices[:nu]
        touched = uniq[(uniq >= 0) & (uniq < rows)].long()
        n = touched.numel()
        spare = torch.ones(rows, dtype=torch.bool, device="cuda")
        spare[touched] = False
        sample = torch.nonzero(spare)[:, 0]
        sample = sample[torch.randperm(sample.numel(), device="cuda", generator=gen)[:1 << 20]]
        del spare
        t0, a0, s0 = table[touched].clone(), accum[touched].clone(), table[sample].clone()
        with plain_path_forbidden(cuda_adagrad), counted((0, 0, 0, 0), f"k4 {label}", k4=1):
            cuda_adagrad.rowwise_adagrad_apply_cuda(table, accum, cg, lr=ADAGRAD_LR, eps=1e-8)
        kt, ka = table[touched].clone(), accum[touched].clone()
        if not torch.equal(table[sample], s0):
            raise SystemExit(f"[k4 {label}] K4 changed a row it did not touch")
        table[touched], accum[touched] = t0, a0
        cuda_adagrad.rowwise_adagrad_apply_torch(table, accum, cg, lr=ADAGRAD_LR, eps=1e-8)
        pt, pa = table[touched], accum[touched]
        if kt.isnan().any() or ka.isnan().any():
            raise SystemExit(f"[k4 {label}] NaN reached the table or the accumulators")
        acc_ratio = ((ka.double() - pa.double()).abs() / (1e-6 * pa.double().abs())).max().item()
        want, old = pt.float(), t0.float()
        bound = ulp(want - old, torch.float16) + ulp(want, torch.float16)
        row_ratio = ((kt.float() - want).abs() / bound).max().item()
        equal = (kt == pt).all(dim=1).float().mean().item()
        print(f"[k4 {label}] {n} rows applied of {cg.rows.shape[0]} positions "
              f"(num_unique {nu}); K4 against the plain apply: accumulators {acc_ratio:.3g} "
              f"of 1e-6, table rows {row_ratio:.3g} of one fp16 spacing of the step and "
              f"one of the result (at most 1 passes), {equal:.2%} of rows bit for bit; "
              f"1 launch; {sample.numel()} untouched rows unchanged")
        worst = max(worst, acc_ratio, row_ratio)
        if acc_ratio > 1 or row_ratio > 1:
            raise SystemExit(f"[k4 {label}] K4 is off the plain apply")
        del t0, a0, s0, kt, ka, pt, pa, want, old, bound, sample
        # Times: each call applies the same rows again, in place.
        k = bench.cuda_time_ms(lambda: cuda_adagrad.rowwise_adagrad_apply_cuda(
            table, accum, cg, lr=ADAGRAD_LR, eps=1e-8))
        p = bench.cuda_time_ms(lambda: cuda_adagrad.rowwise_adagrad_apply_torch(
            table, accum, cg, lr=ADAGRAD_LR, eps=1e-8), warmup=1, iters=5)
        lib = bench.cuda_time_ms(lambda: replaced_chain(table, accum, cg, ADAGRAD_LR),
                                 warmup=1, iters=5)
        b = k4_bound_ms(n, width, 2, cg.unique_indices.element_size())
        print(f"[k4 {label}] K4 {k:.4f} ms; bound {b:.4f} ms ({n} rows' bytes at "
              f"{HBM_PEAK}), K4 at {b / k:.1%} of it; plain apply {p:.4f} ms; the torch ops "
              f"it replaced (two host reads, gathers, index_copy_, index_add_) {lib:.4f} ms")
        if flagship_t is None:
            flagship_t = {"ms": k, "plain_ms": p, "library_ms": lib, "bound_ms": b,
                          "bound_by": "bytes", "num_unique": nu, "rows_applied": n}
        del table, accum, ids, gy, cg, uniq, touched
        torch.cuda.empty_cache()
    return worst, flagship_t


def k5_bound_ms(n, id_bytes, sid_bytes=4):
    """K5's least time for ``n`` positions at the data sheet's HBM rate: the
    ids read once, the sorted ids and sample ids written once."""
    return n * (2 * id_bytes + sid_bytes) / bench.H100_HBM_BYTES_PER_S * 1e3


def k5_design_ms(n, id_bytes, passes, sid_bytes=4):
    """The bytes K5's own design moves, at the same rate: the ids read for the
    digit counts and by the first pass, 4-byte keys and positions written
    and read between passes, the sorted ids and sample ids written."""
    return (n * (2 * id_bytes + 16 * (passes - 1) + id_bytes + sid_bytes)
            / bench.H100_HBM_BYTES_PER_S * 1e3)


def phase_k5(gen):
    """K5 against the plain route at ``K4_SHAPES``' lookups: int64 power-law
    ids, 1% of them the sentinel (at most one value at or past the rows, so
    the two agree bit for bit); one counted launch each, with the plain
    route forbidden, then the plain route on the same ids. Then K5 timed
    beside its bound, its design's bytes and the plain route. Returns the
    flagship's times."""
    flagship_t = None
    for label, rows, _, hotness, alpha in K4_SHAPES:
        perm = torch.randperm(rows, device="cuda", generator=gen)
        ids = perm[card_ids(rows, hotness, alpha, gen)].reshape(-1)
        del perm
        ids = torch.where(torch.rand(ids.shape, device="cuda", generator=gen) < 0.01,
                          SENTINEL, ids)
        n = ids.numel()
        before = trace.counters()["launch.k5"]
        with plain_path_forbidden(cuda_transforms):
            got = cuda_transforms.coo_transpose_cuda(ids, rows, hotness=hotness)
        torch.cuda.synchronize()
        launches = trace.counters()["launch.k5"] - before
        want = cuda_transforms.coo_transpose_torch(ids, rows, hotness=hotness)
        same = all(torch.equal(g, w) and g.dtype == w.dtype for g, w in zip(got[:2], want[:2]))
        bits, passes, _ = cuda_transforms.library_plan(n, rows)
        print(f"[k5 {label}] {n} positions, {bits} key bits in {passes} passes: {launches} "
              f"launch, bit for bit the plain route: {same}")
        if launches != 1 or not same:
            raise SystemExit(f"[k5 {label}] K5 is off the plain route")
        del got, want
        k = bench.cuda_time_ms(lambda: cuda_transforms.coo_transpose_cuda(ids, rows,
                                                                        hotness=hotness))
        p = bench.cuda_time_ms(lambda: cuda_transforms.coo_transpose_torch(ids, rows,
                                                                         hotness=hotness),
                               warmup=1, iters=5)
        b, dsn = k5_bound_ms(n, 8), k5_design_ms(n, 8, passes)
        print(f"[k5 {label}] K5 {k:.4f} ms; bound {b:.4f} ms (the ids read and the sorted ids "
              f"and sample ids written once, at {HBM_PEAK}), K5 at {b / k:.1%} of it; its "
              f"design's bytes {dsn:.4f} ms; the plain route (torch.sort, the sample ids, "
              f"two gathers) {p:.4f} ms")
        if flagship_t is None:
            flagship_t = {"ms": k, "plain_ms": p, "bound_ms": b, "bound_by": "bytes",
                          "design_bytes_ms": dsn, "positions": n, "passes": passes}
        del ids
        torch.cuda.empty_cache()
    return flagship_t


@contextlib.contextmanager
def k1_tables(seen):
    """Record the data pointer of every table K1's wrapper is handed."""
    real = cuda_forward.embedding_forward_cuda

    def spy(table, *args, **kwargs):
        seen.append(table.data_ptr())
        return real(table, *args, **kwargs)
    cuda_forward.embedding_forward_cuda = spy
    try:
        yield
    finally:
        cuda_forward.embedding_forward_cuda = real


def int8_positions(ids, cfg, q_rows):
    """The positions the JAX engine serves from an int8 head of ``q_rows``
    rows, worked out here from the config alone: ``mxu_head_rows <= id <
    q_rows``, and none at all when some chunk of ``chunk_elems`` flattened
    positions (the last one padded with row 0) holds more than ``mid_slots``
    of those or more than ``cold_slots`` ids at or past ``q_rows``."""
    n = ids.numel()
    flat = torch.cat([ids.reshape(-1), ids.new_zeros(-n % cfg.chunk_elems)])
    chunk = torch.arange(flat.numel(), device=flat.device) // cfg.chunk_elems
    mid = (flat >= cfg.mxu_head_rows) & (flat < q_rows)
    most = [torch.bincount(chunk[tier], minlength=1).max().item()
            for tier in (mid, flat >= q_rows)]
    over = most[0] > cfg.mid_slots or most[1] > cfg.cold_slots
    return (mid[:n] & (not over)).view(ids.shape)


def int8_bound_ratio(out, table, idx, served=None, qdata=None):
    """The int8 lookups against float32 sums of the same rows, in chunks of
    the batch. Without ``served``: ``out`` is int8_serving_lookup's, held
    to sum max|row| / 254 per bag of the exact sum. With ``served`` (the
    int8 head's positions): ``out`` is tiered_forward(q_head=...)'s, held
    to one fp16 ulp of its exact part plus one of the result around the
    float32 sum of the exact rows and the int8 rows (the exact part rounds
    to the table's type, then the sum does); its distance from the exact
    lookup is held to the int8 rows' bound plus one fp16 ulp.
    Returns (worst error/allowed, worst distance/bound)."""
    worst, dist = 0.0, 0.0
    for s0 in range(0, out.shape[0], COMPARE_ROWS):
        s1 = min(out.shape[0], s0 + COMPARE_ROWS)
        ids = idx[s0:s1]
        rows = table.index_select(0, ids.reshape(-1)).view(*ids.shape, -1).float()
        exact = rows.sum(1)
        amax = rows.abs().amax(-1) / 254
        got = out[s0:s1].float()
        if served is None:
            bound = amax.sum(1) + 1e-5
            worst = max(worst, ((got - exact).abs().amax(-1) / bound).max().item())
            continue
        sel = served[s0:s1]
        lines = qdata.index_select(0, torch.where(sel, ids, 0).reshape(-1))
        # The layout's scale: the fp32 bytes at columns W..W+3 of each line.
        deq = lines[:, :WIDTH].float() * lines[:, WIDTH:WIDTH + 4].contiguous().view(
            torch.float32)
        deq = deq.view(*ids.shape, -1)
        part = torch.where(sel[..., None], 0.0, rows).sum(1)
        ref = part + torch.where(sel[..., None], deq, 0.0).sum(1)
        allowed = ulp(part, torch.float16) + ulp(ref, torch.float16)
        worst = max(worst, ((got - ref).abs() / allowed).max().item())
        bound = (amax * sel).sum(1) + 1e-5 + ulp(exact, torch.float16).amax(-1)
        dist = max(dist, ((got - exact).abs().amax(-1) / bound).max().item())
    return worst, dist


def phase_p7_serving(table, idx, hot_idx, flat, offsets, csr_w, small, small_batch, seed):
    """The tiered, narrow and int8 serving paths (ROADMAP P7), counted, then
    checked against the kernel route each stands for and timed beside it.
    The int8 head runs on the permuted ids (every chunk overflows its slots:
    served exactly, as the JAX engine serves them) and on ``hot_idx``, the
    same law without the permutation (a table stored hot-first, as the
    tiered engine expects), where it takes the int8 rows. Returns
    (launches, max |kernel - plain|)."""
    k1, k2 = cuda_forward.embedding_forward_cuda, cuda_forward.embedding_forward_cuda_csr
    nnz = int(offsets[-1])
    cfg = tiered_mod.auto_config(NUM_ROWS, WIDTH, table.element_size(), HOTNESS)
    ccfg = tce.csr_combine_config(NUM_ROWS, nnz / BATCH)
    q_rows = quant.int8_head_rows(WIDTH, tiered_mod.DEFAULT_HOT_BYTES)
    # The hot-first batch's tier fractions size the int8 head's slots, as
    # calibration would (the defaults assume a 30% mid tier; it holds 43%).
    qcfg = tiered_mod.auto_config(
        NUM_ROWS, WIDTH, table.element_size(), HOTNESS,
        cold_fraction=(hot_idx >= q_rows).float().mean().item(),
        head_fraction=(hot_idx < cfg.mxu_head_rows).float().mean().item())
    print(f"[p7] config 2 tiered config {cfg}; config 3 combine config {ccfg}; int8 "
          f"head of {q_rows} rows, with the hot-first batch's config {qcfg}")
    t0 = time.perf_counter()
    ngen = torch.Generator(device="cuda").manual_seed(seed + 5)
    scale = SWEEP_WIDTH ** -0.5
    packed = torch.empty((SWEEP_ROWS // 4, 128), device="cuda").uniform_(
        -scale, scale, generator=ngen)  # the JAX package's packed layout, k = 4
    raw = narrow.unpack_narrow(packed, SWEEP_ROWS, SWEEP_WIDTH)
    narrow_idx = torch.from_numpy(PowerLawGenerator(
        SWEEP_ROWS - 1, HOTNESS, ALPHA, permute=True, seed=seed + 5,
        dtype=np.int64).sample(SWEEP_BATCH)).cuda()
    packed_bag = tce.EmbeddingBag(SMALL_ROWS, SMALL_WIDTH, layout="packed")
    packed_bag.import_table(small.weight.detach())
    qh = quant.quantize_head(table[:q_rows])
    torch.cuda.synchronize()
    print(f"[p7] inputs: the sweep point's packed table {tuple(packed.shape)} and ids "
          f"{tuple(narrow_idx.shape)}, a packed config 1 module, the int8 head: "
          f"{time.perf_counter() - t0:.1f} s")

    seen = []
    # The tiered fixed lookup, the packed module, the narrow lookup and the
    # int8 head twice: K1; the tiered CSR lookup: K2.
    launches = np.array((5, 1, 0, 0))
    with (plain_path_forbidden(cuda_forward, dispatch), torch.inference_mode(),
          counted(launches, "p7 serving")):
        tiered_out = tce.embedding_lookup(table, idx, backend="tiered", tiered_cfg=cfg)
        tiered_csr = tce.embedding_lookup_csr(table, flat, offsets, csr_w,
                                              backend="tiered", tiered_cfg=ccfg)
        packed_out = packed_bag(small_batch)
        with k1_tables(seen):
            narrow_out = narrow.narrow_lookup(packed, SWEEP_ROWS, SWEEP_WIDTH, narrow_idx)
        q_outs = [tce.tiered_forward(table, ids, cfg=c, q_head=qh)
                  for ids, c in ((idx, cfg), (hot_idx, qcfg))]
    if seen != [packed.data_ptr()]:
        raise SystemExit(f"[p7 narrow] K1 was handed {seen}, not the packed storage "
                         f"{packed.data_ptr()}")
    print("[p7 narrow] K1 read the packed table's own storage (no copy)")

    with torch.inference_mode():
        checks = (("tiered fixed == auto", tiered_out, tce.embedding_lookup(table, idx)),
                  ("tiered csr == auto", tiered_csr,
                   tce.embedding_lookup_csr(table, flat, offsets, csr_w)),
                  ("packed module == padded module", packed_out, small(small_batch)),
                  ("narrow lookup == K1 on the raw table", narrow_out, k1(raw, narrow_idx)))
        for name, got, want in checks:
            if not torch.equal(got, want):
                raise SystemExit(f"[p7] {name}: not bit for bit")
            print(f"[p7] {name}: bit for bit")
        err = compare_in_chunks(narrow_out, raw, narrow_idx)
        for name, ids, c, q_out in zip(("permuted", "hot-first"), (idx, hot_idx),
                                       (cfg, qcfg), q_outs):
            served = int8_positions(ids, c, q_rows)
            worst, dist = int8_bound_ratio(q_out, table, ids, served, qh.data)
            print(f"[p7 int8 head, {name} ids] {int(served.sum())} of {served.numel()} "
                  f"positions from the int8 rows; against a float32 sum of the same rows: "
                  f"error/allowed {worst:.3g}; distance from the exact lookup over the "
                  f"int8 rows' bound {dist:.3g} (each at most 1 passes)")
            if worst > 1 or dist > 1 or not torch.isfinite(q_out).all():
                raise SystemExit("[p7 int8 head] off")
        if not int8_positions(hot_idx, qcfg, q_rows).any():
            raise SystemExit("[p7 int8 head] the hot-first batch took no int8 row")
        del q_outs
        qt = quant.quantize_head(table)
        int8_out = quant.int8_serving_lookup(qt, idx)
        ratio, _ = int8_bound_ratio(int8_out, table, idx)
        print(f"[p7 int8 table] the whole table quantized, {qt.data.numel()} bytes; "
              f"lookup error over its bound sum max|row|/254: {ratio:.3g} (at most 1 passes)")
        if ratio > 1 or tuple(int8_out.shape) != (BATCH, WIDTH):
            raise SystemExit("[p7 int8 table] outside the documented bound")

        # Times, each beside the kernel route it stands for; same call, in turns.
        times = {
            "K1 fixed": bench.cuda_time_ms(lambda: k1(table, idx)),
            "tiered fixed": bench.cuda_time_ms(lambda: tce.embedding_lookup(
                table, idx, backend="tiered", tiered_cfg=cfg)),
            "K2 csr sum_w": bench.cuda_time_ms(lambda: k2(table, flat, offsets, csr_w)),
            "tiered csr sum_w": bench.cuda_time_ms(lambda: tce.embedding_lookup_csr(
                table, flat, offsets, csr_w, backend="tiered", tiered_cfg=ccfg)),
            "K1 raw 10M x 32": bench.cuda_time_ms(lambda: k1(raw, narrow_idx)),
            "narrow_lookup 10M x 32": bench.cuda_time_ms(lambda: narrow.narrow_lookup(
                packed, SWEEP_ROWS, SWEEP_WIDTH, narrow_idx)),
            "K1 fixed again": bench.cuda_time_ms(lambda: k1(table, idx)),
            "int8 head tiered_forward, permuted ids": bench.cuda_time_ms(
                lambda: tce.tiered_forward(table, idx, cfg=cfg, q_head=qh), iters=5),
            "int8 head tiered_forward, hot-first ids": bench.cuda_time_ms(
                lambda: tce.tiered_forward(table, hot_idx, cfg=qcfg, q_head=qh), iters=5),
            "K1 fixed, hot-first ids": bench.cuda_time_ms(lambda: k1(table, hot_idx)),
            "int8_serving_lookup": bench.cuda_time_ms(
                lambda: quant.int8_serving_lookup(qt, idx), iters=5),
        }
    print("[p7 times] device ms (CUDA events, L2 flushed), in turns: "
          + "; ".join(f"{k} {v:.4f}" for k, v in times.items()))
    del qt, int8_out, packed, raw, narrow_idx
    torch.cuda.empty_cache()
    return launches, err


def phase_p7_training(bag, idx, hot_idx, gen):
    """The tiered training path (ROADMAP P7) at config 4, counted: the dense
    step's gradient with a tiered_cfg (K3 over the whole COO: the config
    changes no gradient), the JAX package's split of it (the head product
    plus K3 over the non-head positions, ``head.tiered_backward_coo``) and
    its compressed form, and the sparse SGD and AdaGrad steps with a
    tiered_cfg; then each against its untiered counterpart, the split also
    on ``hot_idx`` (where the head takes about half the positions), and the split
    timed beside the untiered gradient. Returns the launches."""
    kb = cuda_backward.embedding_backward_cuda
    cfg = tiered_mod.auto_config(NUM_ROWS, WIDTH, 2, HOTNESS)
    weight = bag.weight
    touched = torch.unique(idx)
    # Integer grad_y: every fp32 sum is exact, so the split must not change
    # a bit of the gradient.
    gy = torch.randint(-3, 4, (BATCH, WIDTH), device="cuda", generator=gen).to(weight.dtype)
    gy32 = gy.float()
    with torch.no_grad():
        sparse_gy = train.embedding_grad_y(sparse_loss, bag(idx))
    sgd_table, ada_table = weight.detach().clone(), weight.detach().clone()
    ada_acc = train.rowwise_adagrad_init(NUM_ROWS)
    old = weight.detach()[touched]
    sid = torch.arange(BATCH * HOTNESS, dtype=torch.int32, device="cuda") // HOTNESS

    def masked_coo(ids):
        flat_idx = ids.reshape(-1)
        return transpose_position_ordered(
            sid, torch.where(flat_idx < cfg.mxu_head_rows, SENTINEL, flat_idx))

    def split(ids):
        return tiered_backward_coo(gy, NUM_ROWS, ids, None, *masked_coo(ids), cfg,
                                   accumulation_dtype=torch.float32)

    def untiered(ids):
        return dispatch.backward(gy, NUM_ROWS, *transpose_position_ordered(
            sid, ids.reshape(-1)), accumulation_dtype=torch.float32)

    weight.grad = None
    # The dense step with tiered_cfg and the split: K3 full; the split's
    # compressed form, SGD and AdaGrad: K3 compressed; AdaGrad: K4; K5 for
    # the dense step's backward and the two updates (the split's COOs are
    # sorted here, on the plain route).
    launches = np.array((1, 0, 2, 3))
    with (plain_path_forbidden(cuda_forward, cuda_backward, dispatch),
          counted(launches, "p7 training", k4=1, k5=3)):
        bag(idx, tiered_cfg=cfg).backward(gy)
        split_grad = split(idx)
        split_c = embedding_backward_compressed_tiered(gy32, NUM_ROWS, idx, None,
                                                       *masked_coo(idx), cfg)
        train.sgd_sparse_update(sgd_table, idx, sparse_gy, lr=SGD_LR, tiered_cfg=cfg)
        train.rowwise_adagrad_sparse_update(ada_table, ada_acc, idx, sparse_gy,
                                            lr=ADAGRAD_LR, tiered_cfg=cfg)

    def same(a, b):
        return all(torch.equal(a[r:r + (1 << 20)], b[r:r + (1 << 20)])
                   for r in range(0, NUM_ROWS, 1 << 20))
    tiered_grad = weight.grad
    weight.grad = None
    bag(idx).backward(gy)
    head_rows = int((touched < cfg.mxu_head_rows).sum())
    for name, got in (("the dense step's gradient with tiered_cfg", tiered_grad),
                      (f"the split (head product over {cfg.mxu_head_rows} rows, "
                       f"{head_rows} of them looked up, plus K3)", split_grad)):
        ok = same(got, weight.grad)
        print(f"[p7 dense] {name} {'equal to' if ok else 'DIFFERS from'} the untiered "
              f"K3 gradient, bit for bit")
        if not ok:
            raise SystemExit("[p7 dense] a tiered gradient differs")
    del tiered_grad, split_grad
    weight.grad = None
    want_c = dispatch.backward_compressed(gy32, *transpose_position_ordered(
        sid, idx.reshape(-1)))
    nu = int(want_c.num_unique)
    ok = (int(split_c.num_unique) == nu
          and torch.equal(split_c.unique_indices[:nu], want_c.unique_indices[:nu])
          and torch.equal(split_c.rows[:nu], want_c.rows[:nu]))
    print(f"[p7 compressed] the split's compressed gradient ({nu} rows, the sentinel "
          f"run left out) {'equal to' if ok else 'DIFFERS from'} the untiered K3 one, "
          f"bit for bit")
    if not ok:
        raise SystemExit("[p7 compressed] the tiered compressed gradient differs")
    del split_c, want_c
    in_head = int((hot_idx < cfg.mxu_head_rows).sum())
    ok = same(split(hot_idx), untiered(hot_idx))
    print(f"[p7 dense, hot-first ids] {in_head} of {hot_idx.numel()} positions in the "
          f"head; the split {'equal to' if ok else 'DIFFERS from'} the untiered "
          f"gradient, bit for bit")
    if not ok:
        raise SystemExit("[p7 dense] the split differs on hot-first ids")
    torch.cuda.empty_cache()
    want = weight.detach().clone()
    train.sgd_sparse_update(want, idx, sparse_gy, lr=SGD_LR)
    check_sparse_step("p7 tiered sgd", sgd_table, want, old, touched)
    del sgd_table
    want.copy_(weight.detach())
    acc = train.rowwise_adagrad_init(NUM_ROWS)
    train.rowwise_adagrad_sparse_update(want, acc, idx, sparse_gy, lr=ADAGRAD_LR)
    check_sparse_step("p7 tiered adagrad", ada_table, want, old, touched)
    if not torch.allclose(ada_acc, acc, rtol=1e-4, atol=1e-12):
        raise SystemExit("[p7 tiered adagrad] the accumulator disagrees")
    del ada_table, want, acc, ada_acc
    torch.cuda.empty_cache()

    # The split beside the untiered gradient (each with its sort), in
    # turns; the head product and K3 on the masked COO alone.
    times = {}
    for name, fn in (("untiered", untiered), ("split", split),
                     ("untiered again", untiered), ("split again", split)):
        times[name] = bench.cuda_time_ms(lambda: fn(idx), iters=10)
    head_ms = bench.cuda_time_ms(lambda: head_grad(idx, None, gy32, cfg.mxu_head_rows,
                                                   torch.float32))
    m_idx, m_sid, _ = masked_coo(idx)
    f_idx, f_sid, _ = transpose_position_ordered(sid, idx.reshape(-1))
    buf = torch.zeros((NUM_ROWS, WIDTH), dtype=gy.dtype, device="cuda")
    k3_masked = bench.cuda_time_ms(lambda: kb(gy, NUM_ROWS, m_idx, m_sid, initial_grad=buf))
    k3_full = bench.cuda_time_ms(lambda: kb(gy, NUM_ROWS, f_idx, f_sid, initial_grad=buf))
    print(f"[p7 dense gradient] device ms (CUDA events, L2 flushed), in turns: untiered "
          f"{times['untiered']:.4f} / {times['untiered again']:.4f}, split "
          f"{times['split']:.4f} / {times['split again']:.4f}; head product M^T @ grad_y "
          f"({cfg.mxu_head_rows} rows, fp32) {head_ms:.4f}; K3 on the masked COO "
          f"({int((m_idx != SENTINEL).sum())} of {m_idx.numel()} positions) "
          f"{k3_masked:.4f}, on the whole COO {k3_full:.4f}")
    del buf
    torch.cuda.empty_cache()
    return launches


def dlrm_numpy_params(cfg, seed):
    """DLRM parameters in the JAX ``init``'s layout, as numpy, from a seed:
    tables by the package's init law (``types.init_table_``, drawn on the
    CPU), weights sqrt(2/in) N(0, 1), biases 0."""
    rng = np.random.default_rng(seed)
    tgen = torch.Generator().manual_seed(seed)
    tables = [init_table_(torch.empty((v, cfg.embed_width)), tgen).numpy()
              for v in cfg.table_sizes]

    def mlp(dims):
        return [{"w": (rng.standard_normal((dims[i], dims[i + 1])) * (2.0 / dims[i]) ** 0.5)
                 .astype(np.float32), "b": np.zeros(dims[i + 1], np.float32)}
                for i in range(len(dims) - 1)]
    n_feat = cfg.num_tables + 1
    return {"tables": tables, "bottom": mlp((cfg.dense_features, *cfg.bottom_mlp)),
            "top": mlp((cfg.bottom_mlp[-1] + n_feat * (n_feat - 1) // 2, *cfg.top_mlp))}


def events_ms(fn):
    """fn() with its host ms to a synchronize and its device ms between
    CUDA events recorded around it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def phase_tables_table(gen, idx, calib_ids, flat, offsets, csr_w):
    """ROADMAP P8 at config 4: an EmbeddingTable of 10M x 256 bf16, calibrated
    on 4 batches (its reorder on the card), its lookups (device remap, host
    remap, CSR) bit for bit equal to the lookups before the reorder, a
    row-wise AdaGrad step on its storage against the plain path, and
    resize_table both ways with the AdaGrad state. Returns the launches."""
    t = tce.EmbeddingTable.create(gen, NUM_ROWS, WIDTH, dtype=torch.bfloat16)
    ref = tce.embedding_lookup(t.logical_table(), idx)
    ref_csr = tce.embedding_lookup_csr(t.logical_table(), flat, offsets, csr_w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.calibrate(calib_ids)
    torch.cuda.synchronize()
    cfg = t.tiered_cfg
    print(f"[p8 table] calibrate on {calib_ids.shape[0]} batches of "
          f"{tuple(calib_ids.shape[1:])} ids: {time.perf_counter() - t0:.2f} s host "
          f"(counts, order, the reorder on the card, the config): {cfg}")
    rows = t.remap_indices(idx)
    touched = torch.unique(rows)
    with torch.no_grad():
        gy = train.embedding_grad_y(sparse_loss, ref)
    accum = train.rowwise_adagrad_init(NUM_ROWS)
    plain_table, plain_acc, old = t.table.clone(), accum.clone(), t.table[touched]
    launches = np.zeros(4, np.int64)
    with plain_path_forbidden(cuda_forward, cuda_backward, dispatch):
        for name, expect, k4, fn in (
            ("lookup", (1, 0, 0, 0), 0, lambda: t.lookup(idx)),
            ("lookup, host remap", (1, 0, 0, 0), 0,
             lambda: t.lookup(rows, assume_remapped=True)),
            ("csr lookup", (0, 1, 0, 0), 0, lambda: t.lookup(flat, csr_w, offsets)),
            ("adagrad", (0, 0, 0, 1), 1, lambda: train.rowwise_adagrad_sparse_update(
                t.table, accum, rows, gy, lr=ADAGRAD_LR)),
        ):
            with counted(expect, f"p8 table {name}", k4=k4, k5=k4):
                out = fn()
            launches += expect
            if name.startswith(("lookup", "csr")):
                want = ref_csr if name == "csr lookup" else ref
                if not torch.equal(out, want):
                    raise SystemExit(f"[p8 table] {name} differs from the lookup before "
                                     "the reorder")
                print(f"[p8 table] {name}: equal to the lookup before the reorder, bit "
                      f"for bit")
    train.rowwise_adagrad_sparse_update(plain_table, plain_acc, rows, gy, lr=ADAGRAD_LR,
                                        backend="xla")
    err = check_sparse_step("p8 table adagrad", t.table, plain_table, old, touched)
    if not torch.allclose(accum, plain_acc, rtol=1e-4, atol=1e-12):
        raise SystemExit("[p8 table adagrad] the accumulator disagrees")
    del plain_table, plain_acc, old
    torch.cuda.empty_cache()
    remap_ms = bench.cuda_time_ms(lambda: t.lookup(idx))
    pipe_ms = bench.cuda_time_ms(lambda: t.lookup(rows, assume_remapped=True))
    print(f"[p8 table] device ms (CUDA events, L2 flushed): lookup with the device remap "
          f"{remap_ms:.4f}, with host-remapped ids {pipe_ms:.4f}")

    extra = NUM_ROWS // 20
    grown, grown_acc = tce.resize_table(t.table, NUM_ROWS + extra, gen, accum=accum)
    ok = (all(torch.equal(grown[:NUM_ROWS][r:r + (1 << 20)], t.table[r:r + (1 << 20)])
              for r in range(0, NUM_ROWS, 1 << 20))
          and torch.equal(grown_acc[:NUM_ROWS], accum) and not grown_acc[NUM_ROWS:].any()
          and float(grown[NUM_ROWS:].float().abs().max()) <= (1 + 2 ** -8) / WIDTH ** 0.5
          and bool(grown[NUM_ROWS:].any()))
    del grown, grown_acc
    small, small_acc = tce.resize_table(t.table, NUM_ROWS - extra, accum=accum)
    ok = ok and small.shape == (NUM_ROWS - extra, WIDTH) and small_acc.shape == (
        NUM_ROWS - extra,) and small.data_ptr() == t.table.data_ptr()
    print(f"[p8 resize] grown by {extra} rows (old rows and state kept, new rows in the "
          f"init range, new state zero) and shrunk by {extra} (the first rows): "
          f"{'as expected' if ok else 'WRONG'}")
    if not ok:
        raise SystemExit("[p8 resize] resize_table is wrong")
    del t, small, small_acc, accum, gy, ref, ref_csr
    torch.cuda.empty_cache()
    return launches, err


def phase_tables_fused(gen, seed):
    """ROADMAP P8's collection and fused group at DLRMConfig's defaults (8
    tables of 100K x 64 fp32, hotness 8, batch 65536): one fused_lookup
    (K1 once) against EmbeddingCollection.apply (K1 a table), bit for bit
    under SUM, and both against the plain path; one fused_adagrad_update (K3
    compressed once) against the plain path's update of the fused table, and
    against the per-table adagrad_update. Returns the launches and
    max |kernel - plain| of K1 and of K3."""
    cfg = DLRMConfig()
    names = [f"t{i}" for i in range(cfg.num_tables)]
    coll = tce.EmbeddingCollection([tce.TableConfig(n, v, cfg.embed_width,
                                                    hotness=cfg.hotness)
                                    for n, v in zip(names, cfg.table_sizes)])
    tables = coll.init(gen)
    ids = {n: torch.from_numpy(PowerLawGenerator(
        v - 1, cfg.hotness, ALPHA, permute=True, seed=seed + 20 + i,
        dtype=np.int64).sample(BATCH)).cuda() for i, (n, v) in
        enumerate(zip(names, cfg.table_sizes))}
    gys = {n: torch.randn((BATCH, cfg.embed_width), device="cuda", generator=gen)
           for n in names}
    fused, spec = tce.fuse_tables(tables, {n: cfg.hotness for n in names})
    facc = train.rowwise_adagrad_init(spec.total_rows)
    before, plain_fused, plain_facc = fused.clone(), fused.clone(), facc.clone()
    accs = coll.adagrad_init()
    T = len(names)
    launches = np.array((1 + T, 0, 0, 1 + T))
    with plain_path_forbidden(cuda_forward, cuda_backward, dispatch):
        with counted((1, 0, 0, 0), "p8 fused_lookup"):
            fout = tce.fused_lookup(fused, spec, ids)
        batches = trace.counters()["launch.k1_batch"]
        with counted((T, 0, 0, 0), "p8 collection apply"):
            per = coll.apply(tables, ids)
        if trace.counters()["launch.k1_batch"] != batches + 1:
            raise SystemExit("[p8 collection apply] not one call of the batched forward")
        with counted((0, 0, 0, 1), "p8 fused_adagrad_update", k4=1, k5=1):
            tce.fused_adagrad_update(fused, facc, spec, ids, gys, lr=ADAGRAD_LR)
        with counted((0, 0, 0, T), "p8 collection adagrad_update", k4=T, k5=T):
            coll.adagrad_update(tables, accs, ids, gys, lr=ADAGRAD_LR)
    # The plain path on the same inputs: the lookups (tables before the
    # update: the fused copy) and the fused update's rows, as
    # fused_adagrad_update builds them.
    plain_out = coll.apply(tce.unfuse_table(plain_fused, spec), ids, backend="xla")
    big_idx, big_w, big_gy = fused_mod._fused_grad_batch(
        spec, ids, gys, None, tce.CombineMode.SUM, None)
    train.rowwise_adagrad_sparse_update(plain_fused, plain_facc, big_idx, big_gy,
                                        lr=ADAGRAD_LR, weights=big_w, backend="xla")
    same = all(torch.equal(fout[n], per[n]) for n in names)
    e1 = max(max_abs_err(fout[n], plain_out[n]) for n in names)
    print(f"[p8 fused] fused_lookup of {T} tables x {BATCH} x {cfg.hotness}: one K1 "
          f"launch, {'equal to' if same else 'DIFFERENT from'} the {T} per-table lookups "
          f"bit for bit; max |K1 - plain path| {e1}")
    if not same or e1:
        raise SystemExit("[p8 fused] the fused lookup differs from the per-table ones "
                         "or from the plain path")
    # The float64 row sums of the fused COO, the update's reference.
    runs = float64_runs(big_gy, *fixed_coo(big_idx), None, big_idx.numel())
    paths = {"K3 path, fused": (fused, facc),
             "K3 path, per-table": (torch.cat([tables[n] for n in names]),
                                    torch.cat([accs[n] for n in names])),
             "plain path": (plain_fused, plain_facc)}
    e3 = check_fp32_step("p8 fused_adagrad_update", {k: v[0] for k, v in paths.items()},
                         before, runs[0], runs[1:], ADAGRAD_LR,
                         acc=(train.rowwise_adagrad_init(spec.total_rows),
                              {k: v[1] for k, v in paths.items()}))
    bits = all(torch.equal(x, y) for x, y in zip(paths["K3 path, fused"],
                                                 paths["K3 path, per-table"]))
    print(f"[p8 fused] fused_adagrad_update (one K3 launch) against the {T} per-table "
          f"updates (K3 a table): {'equal bit for bit' if bits else 'not bit for bit'} "
          f"(tables and state; both within the bound above)")
    del paths, before, plain_fused, plain_facc, plain_out, big_idx, big_gy, runs
    f_ms = bench.cuda_time_ms(lambda: tce.fused_lookup(fused, spec, ids))
    c_ms = bench.cuda_time_ms(lambda: coll.apply(tables, ids))
    # The updates, host ms to a synchronize.
    fu_ms = statistics.median(timed(lambda: tce.fused_adagrad_update(
        fused, facc, spec, ids, gys, lr=ADAGRAD_LR))[1] for _ in range(5))
    cu_ms = statistics.median(timed(lambda: coll.adagrad_update(
        tables, accs, ids, gys, lr=ADAGRAD_LR))[1] for _ in range(5))
    print(f"[p8 fused] device ms (CUDA events, L2 flushed): fused_lookup {f_ms:.4f}, the "
          f"{T} per-table lookups {c_ms:.4f}; host ms to a synchronize, median of 5: "
          f"fused_adagrad_update {fu_ms:.4f}, the {T} per-table updates {cu_ms:.4f}")
    device_breakdown("p8 fused_lookup", lambda: tce.fused_lookup(fused, spec, ids))
    device_breakdown("p8 collection apply", lambda: coll.apply(tables, ids))
    return launches, e1, e3


DLRM_STEPS = 5
DLRM_LR = 0.01  # DLRM.sgd_step's default
DLRM_TOL = dict(rtol=1e-5, atol=1e-5)


def dlrm_tables(m):
    """A DLRM's tables, one tensor each."""
    if m.fused_spec is not None:
        return list(tce.unfuse_table(m.tables.detach(), m.fused_spec).values())
    return [bag.weight.detach() for bag in m.bags]


def dlrm_grad_y(m, dense, sparse, labels):
    """The loss's gradient with respect to each pooled lookup of a per-table
    DLRM, on the plain path: what its first sgd_step sums into the tables."""
    with torch.enable_grad():
        emb = [bag(idx, backend="xla").detach().requires_grad_()
               for bag, idx in zip(m.bags, sparse)]
        logits = m.top(interaction(m.bottom(dense), emb), final_linear=True)[:, 0]
        return torch.autograd.grad(torch.mean(bce_with_logits(logits, labels)), emb)


def phase_dlrm(gen, seed):
    """ROADMAP P9: the DLRM at DLRMConfig's defaults, batch 65536, fused and
    per-table storage from one numpy parameter set, beside a third,
    per-table model on the plain path: the forward against the plain path
    on the card; 5 sgd_steps (K1 and K3 full, a launch each a step, or a
    table a step) whose losses agree with the plain path's; and the tables
    after the first step, on all three, held to the float64 step (the first
    step's pooled gradient summed in float64). Returns the launches and
    max |kernel - plain| of K1 and of K3."""
    base = DLRMConfig()
    params = dlrm_numpy_params(base, seed + 30)
    rng = np.random.default_rng(seed + 31)
    dense = torch.from_numpy(rng.standard_normal((BATCH, base.dense_features))
                             .astype(np.float32)).cuda()
    sparse = [torch.from_numpy(PowerLawGenerator(v - 1, base.hotness, ALPHA, permute=True,
                                                 seed=seed + 40 + i, dtype=np.int64)
                               .sample(BATCH)).cuda()
              for i, v in enumerate(base.table_sizes)]
    labels = torch.from_numpy(rng.integers(0, 2, BATCH).astype(np.float32)).cuda()
    T = base.num_tables
    # The plain path: a per-table model with backend="xla". The first step's
    # pooled gradient, twice (the towers' backward must repeat its bits for
    # the float64 sums to be those of every path).
    ref = DLRM(DLRMConfig())
    params_from_numpy(ref, params)
    init = [t.clone() for t in dlrm_tables(ref)]
    gy = dlrm_grad_y(ref, dense, sparse, labels)
    if not all(torch.equal(a, b) for a, b in zip(gy, dlrm_grad_y(ref, dense, sparse,
                                                                  labels))):
        raise SystemExit("[p9 dlrm] the pooled gradient does not repeat its bits")
    runs = [float64_runs(g, *fixed_coo(idx), None, idx.numel())
            for g, idx in zip(gy, sparse)]
    del gy
    after1, losses = {}, {}
    losses["plain path"] = []
    for step in range(DLRM_STEPS):
        losses["plain path"].append(
            ref.sgd_step(dense, sparse, labels, DLRM_LR, backend="xla").item())
        if step == 0:
            after1["plain path"] = [t.clone() for t in dlrm_tables(ref)]
    print(f"[p9 dlrm plain path] {DLRM_STEPS} sgd_steps with backend=\"xla\": losses "
          f"{losses['plain path']}")
    del ref
    launches = np.zeros(4, np.int64)
    e1 = 0.0
    for fused in (True, False):
        name = "fused" if fused else "per-table"
        m = DLRM(DLRMConfig(fused=fused))
        params_from_numpy(m, params)
        n = 1 if fused else T
        with plain_path_forbidden(cuda_forward, cuda_backward, dispatch):
            with counted((n, 0, 0, 0), f"p9 dlrm {name} forward"), torch.no_grad():
                logits = m(dense, sparse)
        with torch.no_grad():
            plain_logits = m(dense, sparse, backend="xla")
        e = max_abs_err(logits, plain_logits)
        e1 = max(e1, e)
        ok = torch.isfinite(logits).all() and torch.allclose(logits, plain_logits, **DLRM_TOL)
        print(f"[p9 dlrm {name}] forward {tuple(logits.shape)}: max |kernels - plain path| "
              f"{e} (rtol = atol = 1e-5)")
        if not ok:
            raise SystemExit(f"[p9 dlrm {name}] the forward disagrees with the plain path")
        label = f"K3 path, {name}"
        losses[label], host, dev = [], [], []
        with plain_path_forbidden(cuda_forward, cuda_backward, dispatch):
            with counted((n * DLRM_STEPS, 0, n * DLRM_STEPS, 0), f"p9 dlrm {name} steps",
                         k5=n * DLRM_STEPS):
                for step in range(DLRM_STEPS):
                    loss, h, d = events_ms(
                        lambda: m.sgd_step(dense, sparse, labels, DLRM_LR))
                    losses[label].append(loss.item())
                    host.append(h)
                    dev.append(d)
                    if step == 0:
                        after1[label] = [t.clone() for t in dlrm_tables(m)]
        launches += (n * (DLRM_STEPS + 1), 0, n * DLRM_STEPS, 0)
        print(f"[p9 dlrm {name}] {DLRM_STEPS} sgd_steps (K1 and K3 full, {n} launch(es) "
              f"each a step): losses {losses[label]}; host ms "
              f"{[round(x, 4) for x in host]}; "
              f"device ms between events {[round(x, 4) for x in dev]} (the first step "
              f"includes one-time set-up)")
        rel = float(np.max(np.abs(np.array(losses[label]) - losses["plain path"])
                           / np.abs(losses["plain path"])))
        print(f"[p9 dlrm {name}] losses against the plain path's: max relative "
              f"difference {rel:.3g} (rtol = atol = 1e-5)")
        if not (np.isfinite(losses[label]).all()
                and np.allclose(losses[label], losses["plain path"], **DLRM_TOL)):
            raise SystemExit(f"[p9 dlrm {name}] the losses disagree with the plain path")
        device_breakdown(f"p9 dlrm {name} step",
                         lambda: m.sgd_step(dense, sparse, labels, DLRM_LR))
        del m
        torch.cuda.empty_cache()
    e3 = 0.0
    for i, (uniq, *sums) in enumerate(runs):
        e3 = max(e3, check_fp32_step(f"p9 dlrm table {i}, step 1",
                                     {k: v[i] for k, v in after1.items()}, init[i], uniq,
                                     sums, DLRM_LR))
    same = losses["K3 path, fused"] == losses["K3 path, per-table"]
    print(f"[p9 dlrm] losses, fused against per-table storage: "
          f"{'equal' if same else 'not equal'} bit for bit")
    del after1, init, runs
    torch.cuda.empty_cache()
    return launches, e1, e3


def phase_trainer(gen):
    """examples/train_dlrm_torch.py's main with its defaults on the card,
    counted, the plain versions forbidden; then a collection at its shapes
    (the defaults, int32 ids as its pipeline makes them), one apply (K1 a
    table) and one adagrad_update (K3 compressed a table) held to the plain
    path and to the float64 step. Returns the launches and max |kernel -
    plain| of K1 and of K3."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        "train_dlrm_torch.py")
    spec = importlib.util.spec_from_file_location("train_dlrm_torch", path)
    trainer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trainer)
    d = trainer.parse_args([])
    n = d.steps * d.tables
    launches = np.array((n, 0, 0, n))
    # Each step's adagrad_update: K3 compressed and K4 a table.
    with (plain_path_forbidden(cuda_forward, cuda_backward, dispatch),
          counted(launches, "p9 trainer", k4=n, k5=n)):
        rate = trainer.main([])
    print(f"[p9 trainer] examples/train_dlrm_torch.py, defaults ({d.tables} tables x "
          f"{d.categories} x {d.width}, batch {d.batch}, hotness {d.hotness}, "
          f"{d.steps} steps): {rate:.0f} examples/s; native host library "
          f"{'loaded' if native.AVAILABLE else 'not built (numpy fallbacks)'}")

    names = [f"t{i}" for i in range(d.tables)]
    coll = tce.EmbeddingCollection([tce.TableConfig(t, d.categories, d.width,
                                                    hotness=d.hotness) for t in names])
    tables = coll.init(gen)
    accs = coll.adagrad_init()
    ids = {t: torch.from_numpy(PowerLawGenerator(
        d.categories - 1, d.hotness, d.alpha, seed=100 + i, permute=True,
        dtype=np.int32).sample(d.batch)).cuda() for i, t in enumerate(names)}
    gys = {t: torch.randn((d.batch, d.width), device="cuda", generator=gen)
           for t in names}
    before = {t: tables[t].clone() for t in names}
    plain_t = {t: tables[t].clone() for t in names}
    plain_a = {t: accs[t].clone() for t in names}
    pooled = coll.apply(tables, ids)
    want = coll.apply(plain_t, ids, backend="xla")
    coll.adagrad_update(tables, accs, ids, gys, lr=d.lr)
    e1, e3 = max(max_abs_err(pooled[t], want[t]) for t in names), 0.0
    print(f"[p9 trainer shapes] collection.apply: max |K1 - plain path| {e1} (bit for "
          f"bit expected)")
    if e1:
        raise SystemExit("[p9 trainer shapes] K1 disagrees with the plain path")
    for t in names:
        train.rowwise_adagrad_sparse_update(plain_t[t], plain_a[t], ids[t], gys[t],
                                            lr=d.lr, backend="xla")
        uniq, *sums = float64_runs(gys[t], *fixed_coo(ids[t]), None, ids[t].numel())
        e3 = max(e3, check_fp32_step(
            f"p9 trainer shapes, adagrad_update {t}",
            {"K3 path": tables[t], "plain path": plain_t[t]}, before[t], uniq, sums, d.lr,
            acc=(torch.zeros_like(accs[t]),
                 {"K3 path": accs[t], "plain path": plain_a[t]})))
    return launches, e1, e3


# MLPerf DLRM-v2's sparse arch (portbench/configs/dlrmv2-criteo-mh.json): the
# rows and multi-hot size of each of its 26 tables of width 128.
DLRMV2_ROWS = (40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
               40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
               40_000_000, 40_000_000, 40_000_000, 590_152, 12_973, 108, 36)
DLRMV2_HOTNESS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27,
                  10, 3, 1, 1)
DLRMV2_ROWS_CAP = 4_000_000  # rows drawn a table: 1 GB of fp16 at most


def phase_batched_collection(gen):
    """EmbeddingCollection.apply's batched K1 forward at MLPerf DLRM-v2's
    shapes: a serving query of 700 samples and a training batch of 65,536,
    each one call into the library (26 K1 launches, counted here and kept
    out of the ``kernels`` line), bit for bit against the 26 per-table
    ``embedding_lookup`` calls."""
    names = [f"t{i}" for i in range(len(DLRMV2_ROWS))]
    rows = [min(r, DLRMV2_ROWS_CAP) for r in DLRMV2_ROWS]
    coll = tce.EmbeddingCollection([tce.TableConfig(n, r, 128, dtype=torch.float16,
                                                    hotness=h)
                                    for n, r, h in zip(names, rows, DLRMV2_HOTNESS)])
    tables = {n: torch.randn((r, 128), device="cuda", generator=gen).to(torch.float16)
              for n, r in zip(names, rows)}
    for batch in (700, 65536):
        ids = {n: torch.randint(0, r, (batch, h), device="cuda", generator=gen)
               for n, r, h in zip(names, rows, DLRMV2_HOTNESS)}
        before = trace.counters()
        with plain_path_forbidden(cuda_forward, dispatch):
            got = coll.apply(tables, ids)
            torch.cuda.synchronize()
            after = trace.counters()
            want = {n: tce.embedding_lookup(tables[n], idx) for n, idx in ids.items()}
        calls = tuple(after[k] - before[k] for k in ("launch.k1", "launch.k1_batch",
                                                     "collection.batched_tables"))
        if calls != (26, 1, 26):
            raise SystemExit(f"[batched] (K1, batched calls, batched tables) {calls}, "
                             f"expected (26, 1, 26)")
        same = all(torch.equal(got[n], want[n]) for n in names)
        print(f"[batched] DLRM-v2 collection, batch {batch}: one call, (K1, batched calls, "
              f"batched tables) {calls}, outside the kernels line; "
              f"{'equal to' if same else 'DIFFERENT from'} the 26 per-table lookups bit "
              f"for bit")
        if not same:
            raise SystemExit("[batched] the batched forward differs from the per-table one")
    del tables, ids, got, want
    torch.cuda.empty_cache()


# -- ROADMAP P10: the host-offloaded table -------------------------------------

# benchmarks/offload_benchmark.py's defaults.
OFF_ROWS, OFF_HOT, OFF_WIDTH, OFF_BATCH, OFF_HOTNESS = 2_000_000, 262_144, 64, 8192, 8
OFF_SGD_LR = 0.05


def offload_cap(batches, hot):
    """cold_cap as benchmarks/offload_benchmark.py sizes it: the most unique
    cold rows of any batch, rounded up to 64."""
    return -(-max(np.unique(b[b >= hot]).size for b in batches) // 64) * 64


def phase_offload(seed):
    """ROADMAP P10 at benchmarks/offload_benchmark.py's defaults (2M x 64
    fp32, hot head 262,144 rows, batch 8192, hotness 8, alpha 1.15 hot-first
    ids): the offloaded lookup (one K1 launch on the head and the shipped
    rows) under SUM, MEAN and weighted SUM bit for bit against K1 on the
    resident table; one prepare on the InputPipeline thread; an SGD step and
    two AdaGrad steps (K3 compressed on the head, the tail on the host) held
    to the float64 step beside the plain path. Each lookup is also held,
    beside the plain version on the resident table, to the float64 combine.
    Returns the launches, max |K1 path - plain| and max |K3 path - plain|."""
    from cuembed_tpu_torch.utils.pipeline import InputPipeline

    rng = np.random.default_rng(seed + 30)
    t0 = time.perf_counter()
    table = rng.standard_normal((OFF_ROWS, OFF_WIDTH), dtype=np.float32)
    gen_ids = PowerLawGenerator(OFF_ROWS - 1, OFF_HOTNESS, ALPHA, seed=seed + 31)
    batches = [gen_ids.sample(OFF_BATCH).astype(np.int32) for _ in range(4)]
    cap = offload_cap(batches, OFF_HOT)
    off = tce.HostOffloadTable(table, OFF_HOT, cold_cap=cap)
    resident = torch.from_numpy(table).cuda()
    print(f"[p10 offload] {OFF_ROWS} x {OFF_WIDTH} fp32, head {OFF_HOT} rows on the card, "
          f"tail {OFF_ROWS - OFF_HOT} rows on the host; batch {OFF_BATCH} x {OFF_HOTNESS}; "
          f"cold_cap {cap}; set-up {time.perf_counter() - t0:.1f} s")
    prep = "native" if native.AVAILABLE else "numpy"
    host_ms = []
    for b in batches:
        _, ms = timed(lambda: off.prepare(b))
        host_ms.append(ms)
    batch = off.prepare(batches[0])
    idx = torch.from_numpy(batches[0]).cuda()
    w_np = rng.random(batches[0].shape, dtype=np.float32)
    wbatch = off.prepare(batches[0], w_np)
    w = torch.from_numpy(w_np).cuda()
    print(f"[p10 offload] prepare ({prep}) host ms {[round(m, 3) for m in host_ms]}; "
          f"{batch.uniq_cold.size} unique cold rows shipped of {idx.numel()} positions")

    k1 = cuda_forward.embedding_forward_cuda
    modes = (("sum", batch, None), ("mean", batch, None), ("sum_w", wbatch, w))
    with plain_path_forbidden(cuda_forward, cuda_backward, dispatch):
        outs = {}
        for name, b, _ in modes:
            m = tce.CombineMode(name.removesuffix("_w"))
            with counted((1, 0, 0, 0), f"p10 offload lookup {name}"):
                outs[name] = off.lookup(b, mode=m)
        it = iter(batches[1:2])
        with InputPipeline(lambda: off.prepare(next(it)), depth=1) as pipe:
            with counted((1, 0, 0, 0), "p10 offload lookup, prepared on the pipeline thread"):
                piped = off.lookup(pipe.get())
    launches = np.array((4, 0, 0, 0))
    e1 = 0.0
    for name, b, wt in modes:
        coeff = wt if name == "sum_w" else (
            None if name == "sum" else torch.full(idx.shape, 1.0 / OFF_HOTNESS, device="cuda"))
        want = k1(resident, idx, coeff)
        same = torch.equal(outs[name], want)
        print(f"[p10 offload] lookup {name}: {'equal' if same else 'NOT EQUAL'} to K1 on the "
              f"resident table bit for bit")
        if not same:
            raise SystemExit(f"[p10 offload] the {name} lookup differs from the resident one")
        e1 = max(e1, check_lookup_plain(
            f"p10 offload lookup {name}", {"offload": outs[name]}, resident, idx, wt,
            tce.CombineMode(name.removesuffix("_w"))))
    if not torch.equal(piped, k1(resident, torch.from_numpy(batches[1]).cuda())):
        raise SystemExit("[p10 offload] the pipeline-prepared lookup differs")
    print("[p10 offload] the batch prepared on the InputPipeline thread looks up bit for bit "
          "as K1 on the resident table")
    off_ms = bench.cuda_time_ms(lambda: off.lookup(batch))
    res_ms = bench.cuda_time_ms(lambda: k1(resident, idx))
    print(f"[p10 offload] device ms (CUDA events, L2 flushed): offloaded lookup {off_ms:.4f} "
          f"(the shipped rows' copy and one K1), K1 on the resident table {res_ms:.4f}")

    # Steps, each from the offload table's state, beside the plain path from
    # the same state, held to the float64 step.
    gy = torch.from_numpy(rng.standard_normal((OFF_BATCH, OFF_WIDTH), dtype=np.float32)).cuda()
    uniq, *sums = float64_runs(gy, *fixed_coo(idx), None, idx.numel())

    def full():
        return torch.from_numpy(off.full_table()).cuda()

    before = full()
    with (plain_path_forbidden(cuda_forward, cuda_backward, dispatch),
          counted((0, 0, 0, 1), "p10 offload sgd_update", k5=1)):
        _, sgd_ms = timed(lambda: off.sgd_update(batch, gy, lr=OFF_SGD_LR))
    plain_t = before.clone()
    train.sgd_sparse_update(plain_t, idx, gy, lr=OFF_SGD_LR, backend="xla")
    e3 = check_fp32_step("p10 offload sgd_update", {"offload": full(), "plain path": plain_t},
                         before, uniq, sums, OFF_SGD_LR)
    off.adagrad_init()
    ada_ms = []
    for step in range(2):
        before = full()
        acc0 = torch.cat([off.head_accum, torch.from_numpy(off.tail_accum).cuda()])
        b = off.prepare(batches[0])
        with (plain_path_forbidden(cuda_forward, cuda_backward, dispatch),
              counted((0, 0, 0, 1), f"p10 offload adagrad_update {step + 1}", k4=1,
                      k5=1)):
            _, ms = timed(lambda: off.adagrad_update(b, gy, lr=ADAGRAD_LR))
        ada_ms.append(ms)
        plain_t, plain_a = before.clone(), acc0.clone()
        train.rowwise_adagrad_sparse_update(plain_t, plain_a, idx, gy, lr=ADAGRAD_LR,
                                            backend="xla")
        acc1 = torch.cat([off.head_accum, torch.from_numpy(off.tail_accum).cuda()])
        e3 = max(e3, check_fp32_step(
            f"p10 offload adagrad_update {step + 1}", {"offload": full(), "plain path": plain_t},
            before, uniq, sums, ADAGRAD_LR, acc=(acc0, {"offload": acc1, "plain path": plain_a})))
    for _ in range(3):
        ada_ms.append(timed(lambda: off.adagrad_update(b, gy, lr=ADAGRAD_LR))[1])
    sgd_ms = [sgd_ms] + [timed(lambda: off.sgd_update(b, gy, lr=OFF_SGD_LR))[1]
                         for _ in range(3)]
    print(f"[p10 offload] host ms to a synchronize (the head on the card, the cold rows' "
          f"sums to the host and the tail updated there; the first with one-time set-up): "
          f"sgd_update {[round(m, 3) for m in sgd_ms]}, median {statistics.median(sgd_ms):.3f}; "
          f"adagrad_update {[round(m, 3) for m in ada_ms]}, median "
          f"{statistics.median(ada_ms):.3f}")
    del off, resident, table
    torch.cuda.empty_cache()
    return launches + np.array((0, 0, 0, 3)), e1, e3


# -- ROADMAP P11: the parallel layer, on ranks that share the card --------------

PAR_RANKS = 4
PAR_GLOO_TIMEOUT_S = 300
DLRM_ROWS, DLRM_WIDTH, DLRM_HOTNESS, DLRM_TABLES = 100_000, 64, 8, 8
PAR_SGD_LR = 0.05
# The sharded trainer's losses on 4 ranks against one, a secondary check
# (its first and last steps are replayed on the plain path): its towers
# round their operands to bf16, so a last-bit change of a weight after a
# step (the routed sums and the all-reduced dense gradients add in another
# order) can flip a rounding; over 10 steps the losses drift apart by about
# 1e-3 (CPU, gloo).
PAR_LOSS_RTOL = 1e-2
HYBRID_HOT = 4096
# Per rank: (a) K1 for the row-sharded, routed and int8 routed lookups;
# (b) K3 compressed for each of the 8 routed updates; (c) the sharded
# trainer's lookups (K1) and routed AdaGrad updates (K3 compressed), one a
# table a step; (d) the fused lookup and update (one each) and the 8
# per-table ones.
PAR_EXPECT = {"a": (3, 0, 0, 0), "b": (0, 0, 0, 8), "d": (9, 0, 0, 9)}


def flagship_block(m, n, seed):
    """Row block ``m`` of ``n`` of the sharded flagship table (10M x 256
    fp16): each block drawn by the package's init law from its own seed, so
    the whole table is the blocks' concatenation."""
    g = torch.Generator(device="cuda").manual_seed(seed * 1000 + m)
    t = torch.empty((NUM_ROWS // n, WIDTH), dtype=torch.float16, device="cuda")
    return init_table_(t, g, width=WIDTH)


def par_tables(seed):
    """The 8 DLRM tables of the routed updates (100K x 64 fp32), drawn on the
    card from one seed."""
    g = torch.Generator(device="cuda").manual_seed(seed + 40)
    return [init_table_(torch.empty((DLRM_ROWS, DLRM_WIDTH), device="cuda"), g)
            for _ in range(DLRM_TABLES)]


def dlrm_batch(seed, i):
    """Table ``i``'s ids (batch 65536, hotness 8, permuted alpha 1.15) and
    pooled-output gradient."""
    ids = PowerLawGenerator(DLRM_ROWS - 1, DLRM_HOTNESS, ALPHA, permute=True,
                            seed=seed + 50 + i, dtype=np.int64).sample(BATCH)
    g = torch.Generator(device="cuda").manual_seed(seed + 60 + i)
    return (torch.from_numpy(ids).cuda(),
            torch.randn((BATCH, DLRM_WIDTH), device="cuda", generator=g))


UPDATES = ("row sgd", "row adagrad", "hybrid sgd", "hybrid adagrad", "column sgd",
           "column adagrad", "grid sgd", "grid adagrad")


def update_layout(name):
    """(mesh shape, table spec, accumulator spec, batch spec, grad_y spec)
    of a routed update."""
    if name.startswith("column"):
        return (2, 2), (None, "model"), (None,), ("data", None), ("data", "model")
    if name.startswith("grid"):
        return (2, 2), ("model", "data"), ("model",), ("model", None), ("model", "data")
    return (1, 4), ("model", None), ("model",), ("model", None), ("model", None)


def run_update(name, mesh, table, idx, gy):
    """One routed update of ``name`` on this rank's blocks; returns the
    updated blocks (table, accumulator or None)."""
    from cuembed_tpu_torch import parallel as par

    shape, tspec, aspec, bspec, gspec = update_layout(name)
    kind, opt = name.split()
    ib, gb = par.local_block(idx, mesh, bspec), par.local_block(gy, mesh, gspec)
    lr = ADAGRAD_LR if opt == "adagrad" else PAR_SGD_LR
    if kind == "hybrid":
        head, tail = par.split_hybrid_table(table, HYBRID_HOT, shape[1])
        head, tail = head.clone(), par.local_block(tail, mesh, tspec).clone()
        if opt == "sgd":
            par.sharded_hybrid_sgd_sparse_update(head, tail, ib, gb, mesh=mesh, lr=lr)
            return (head, tail), None
        hacc = torch.zeros(HYBRID_HOT, device="cuda")
        tacc = torch.zeros(tail.shape[0], device="cuda")
        par.sharded_hybrid_rowwise_adagrad_sparse_update(head, tail, hacc, tacc, ib, gb,
                                                         mesh=mesh, lr=lr)
        return (head, tail), (hacc, tacc)
    fns = {"row": (par.sharded_sgd_sparse_update, par.sharded_rowwise_adagrad_sparse_update),
           "column": (par.column_sharded_sgd_sparse_update,
                      par.column_sharded_rowwise_adagrad_sparse_update),
           "grid": (par.grid_sharded_sgd_sparse_update,
                    par.grid_sharded_rowwise_adagrad_sparse_update)}[kind]
    tb = par.local_block(table, mesh, tspec).contiguous().clone()
    if opt == "sgd":
        fns[0](tb, ib, gb, mesh=mesh, lr=lr)
        return tb, None
    acc = par.local_block(torch.zeros(table.shape[0], device="cuda"), mesh, aspec).clone()
    fns[1](tb, acc, ib, gb, mesh=mesh, lr=lr)
    return tb, acc


def par_counted(expect, name, fn, k4=0):
    """fn() in a rank, counted from 0 with the plain versions forbidden,
    ``k4`` K4 launches expected as in :func:`counted`; returns (result,
    launches, seconds)."""
    zero_counts()
    t0 = time.perf_counter()
    with plain_path_forbidden(cuda_forward, cuda_backward, dispatch):
        out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launch_counts()
    if expect is not None and got != tuple(expect):
        raise RuntimeError(f"[{name}] launched {got} in a rank, expected {tuple(expect)}")
    try:
        k4_checked(name, k4)
    except SystemExit as e:
        raise RuntimeError(f"{e} in a rank") from None
    return out, got, seconds


def par_rank(rank, world, tmp, seed):
    """One rank of phase_parallel on cuda:0 over gloo: each sub-phase
    counted in the rank; its blocks and counts saved for the parent."""
    import datetime

    import torch.distributed as dist

    from cuembed_tpu_torch import parallel as par

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=PAR_GLOO_TIMEOUT_S))
    out = {"launches": {}, "seconds": {}}
    try:
        flat = par.make_mesh(n_model=world)
        grid = par.make_mesh(n_model=2)
        meshes = {(1, 4): flat, (2, 2): grid}

        # (a) the flagship table row-sharded over the ranks.
        block = flagship_block(rank, world, seed)
        idx = torch.from_numpy(np.load(f"{tmp}/flagship_ids.npy")).cuda()
        ib = par.local_block(idx, flat, ("model", None))

        def lookups():
            return (par.row_sharded_lookup(block, idx, mesh=flat),
                    par.alltoall_row_sharded_lookup(block, ib, mesh=flat),
                    par.alltoall_row_sharded_lookup(block, ib, mesh=flat, compress="int8"))
        res, out["launches"]["a"], out["seconds"]["a"] = par_counted(
            PAR_EXPECT["a"], "p11 flagship lookups", lookups)
        out["a"] = [r.cpu() for r in res]
        _, ms = timed(lambda: par.alltoall_row_sharded_lookup(block, ib, mesh=flat))
        out["a2a_host_ms"] = ms
        del block, res
        torch.cuda.empty_cache()

        # (b) the 8 routed updates at DLRMConfig's table shape.
        table = par_tables(seed)[0]
        idx, gy = dlrm_batch(seed, 0)
        out["b"], secs, counts = {}, 0.0, np.zeros(4, np.int64)
        for name in UPDATES:
            mesh = meshes[update_layout(name)[0]]
            res, got, s = par_counted(
                (0, 0, 0, 1), f"p11 {name}", lambda: run_update(name, mesh, table, idx, gy))
            out["b"][name] = tuple(None if r is None else tuple(x.cpu() for x in r)
                                   if isinstance(r, tuple) else r.cpu() for r in res)
            counts += got
            secs += s
        out["launches"]["b"], out["seconds"]["b"] = tuple(int(c) for c in counts), secs

        # (c) examples/train_dlrm_sharded_torch.py at its defaults.
        trainer = load_example("train_dlrm_sharded_torch")
        args = trainer.parse_args([])
        n = args.steps * args.tables
        res, out["launches"]["c"], out["seconds"]["c"] = par_counted(
            (n, 0, 0, n), "p11 sharded trainer",
            lambda: trainer.train(args, torch.device("cuda", 0),
                                  record=(0, args.steps - 1)))
        out["c"] = res

        # (d) the fused DLRM group against the per-table routed calls.
        tables = par_tables(seed)
        names = [f"t{i}" for i in range(DLRM_TABLES)]
        batches = [dlrm_batch(seed, i) for i in range(DLRM_TABLES)]
        fused, spec = tce.fuse_tables(dict(zip(names, tables)),
                                      {nm: DLRM_HOTNESS for nm in names})
        fb = par.local_block(fused, flat, ("model", None)).contiguous().clone()
        pb = [par.local_block(t, flat, ("model", None)).contiguous().clone() for t in tables]
        del fused, tables
        ids = {nm: par.local_block(b[0], flat, ("model", None)) for nm, b in
               zip(names, batches)}
        gys = {nm: par.local_block(b[1], flat, ("model", None)) for nm, b in
               zip(names, batches)}

        def fused_vs_per_table():
            fo = tce.fused_sharded_lookup(fb, spec, ids, mesh=flat)
            po = [par.alltoall_row_sharded_lookup(t, ids[nm], mesh=flat)
                  for t, nm in zip(pb, names)]
            facc = torch.zeros(fb.shape[0], device="cuda")
            tce.fused_sharded_adagrad_update(fb, facc, spec, ids, gys, mesh=flat,
                                             lr=ADAGRAD_LR)
            paccs = [torch.zeros(t.shape[0], device="cuda") for t in pb]
            for t, a, nm in zip(pb, paccs, names):
                par.sharded_rowwise_adagrad_sparse_update(t, a, ids[nm], gys[nm], mesh=flat,
                                                          lr=ADAGRAD_LR)
            return fo, po, facc, paccs
        (fo, po, facc, paccs), out["launches"]["d"], out["seconds"]["d"] = par_counted(
            PAR_EXPECT["d"], "p11 fused group", fused_vs_per_table)
        out["d_lookup_bits"] = all(torch.equal(fo[nm], p) for nm, p in zip(names, po))
        out["d_lookup"] = [fo[nm].cpu() for nm in names]
        out["d"] = (fb.cpu(), facc.cpu(), [t.cpu() for t in pb], [a.cpu() for a in paccs])
        out["k4"] = K4_COUNTED["counted"]
        torch.save(out, f"{tmp}/rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def load_example(name):
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def nccl_world_one(tmp):
    """examples/train_dlrm_sharded_torch.py at its defaults over NCCL at
    world size 1, in this process; counted."""
    import torch.distributed as dist

    trainer = load_example("train_dlrm_sharded_torch")
    args = trainer.parse_args([])
    n = args.steps * args.tables
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store", rank=0,
                            world_size=1)
    try:
        with (plain_path_forbidden(cuda_forward, cuda_backward, dispatch),
              counted((n, 0, 0, n), "p11 sharded trainer, NCCL, world size 1")):
            t0 = time.perf_counter()
            res = trainer.train(args, torch.device("cuda", 0), record=(0,))
            seconds = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    return res, np.array((n, 0, 0, n)), seconds


def check_flagship(outs, seed, idx):
    """(a): the ranks' lookups against one-card K1 on the whole table: the
    routed lookup bit for bit, the row-sharded one within the fp32 row sums'
    bound plus the fp16 roundings of its partials and their all-reduce, the
    int8 route within sum max|row| / 254 plus that bound; the routed lookup
    also against the plain version. Returns max |routed - plain|."""
    table = torch.cat([flagship_block(m, PAR_RANKS, seed) for m in range(PAR_RANKS)])
    want = cuda_forward.embedding_forward_cuda(table, idx)
    row = outs[0][0].cuda()
    routed = assemble([o[1] for o in outs], ("model", None), (1, PAR_RANKS)).cuda()
    int8 = assemble([o[2] for o in outs], ("model", None), (1, PAR_RANKS)).cuda()
    same = torch.equal(routed, want)
    amax = table.float().abs().amax(dim=1)
    r_row = r_int8 = 0.0
    for b0 in range(0, BATCH, COMPARE_ROWS):
        ids = idx[b0:b0 + COMPARE_ROWS]
        rows = table.index_select(0, ids.reshape(-1)).double().view(*ids.shape, WIDTH)
        exact, mass = rows.sum(dim=1), rows.abs().sum(dim=1)
        base = sum_bound(exact, mass, HOTNESS, 24, torch.float16)
        partial = base + PAR_RANKS * 2.0 ** -11 * mass
        q = (amax[ids].double() / 254).sum(dim=1, keepdim=True)
        r_row = max(r_row, ((row[b0:b0 + COMPARE_ROWS].double() - exact).abs()
                            / partial).max().item())
        r_int8 = max(r_int8, ((int8[b0:b0 + COMPARE_ROWS].double() - exact).abs()
                              / (base + q)).max().item())
    e_row, e_int8 = max_abs_err(row, want), max_abs_err(int8, want)
    print(f"[p11 flagship] {NUM_ROWS} x {WIDTH} fp16 over {PAR_RANKS} ranks, batch {BATCH} x "
          f"{HOTNESS}: alltoall_row_sharded_lookup {'equal' if same else 'NOT EQUAL'} to "
          f"one-card K1 bit for bit; row_sharded_lookup max |err| {e_row}, error over its bound "
          f"{r_row:.3g}; compress='int8' max |err| {e_int8}, error over its bound {r_int8:.3g} "
          f"(at most 1 passes)")
    if not same or r_row > 1 or r_int8 > 1:
        raise SystemExit("[p11 flagship] a sharded lookup is off the one-card lookup")
    e1 = compare_in_chunks(routed, table, idx)
    print(f"[p11 flagship] alltoall_row_sharded_lookup against the plain version: max |err| "
          f"{e1} (within one fp16 ulp passes)")
    del table
    torch.cuda.empty_cache()
    return e1


def check_updates(outs, seed):
    """(b): each routed update, assembled, held to the float64 step beside
    the plain path's single-table update. Returns max |routed - plain|."""
    table = par_tables(seed)[0]
    idx, gy = dlrm_batch(seed, 0)
    uniq, *sums = float64_runs(gy, *fixed_coo(idx), None, idx.numel())
    e3 = 0.0
    for name in UPDATES:
        shape, tspec, aspec, _, _ = update_layout(name)
        kind, opt = name.split()
        tb, ab = zip(*[o["b"][name] for o in outs])
        if kind == "hybrid":
            got = torch.cat([assemble([t[0] for t in tb], (), shape),
                             assemble([t[1] for t in tb], tspec, shape)])
            acc = (None if opt == "sgd" else torch.cat(
                [assemble([a[0] for a in ab], (), shape),
                 assemble([a[1] for a in ab], aspec, shape)]))
        else:
            got = assemble(list(tb), tspec, shape)
            acc = None if opt == "sgd" else assemble(list(ab), aspec, shape)
        got = got[:DLRM_ROWS].cuda()
        plain_t = table.clone()
        if opt == "sgd":
            train.sgd_sparse_update(plain_t, idx, gy, lr=PAR_SGD_LR, backend="xla")
            e3 = max(e3, check_fp32_step(f"p11 {name}", {"routed": got, "plain path": plain_t},
                                         table, uniq, sums, PAR_SGD_LR))
        else:
            plain_a = torch.zeros(DLRM_ROWS, device="cuda")
            train.rowwise_adagrad_sparse_update(plain_t, plain_a, idx, gy, lr=ADAGRAD_LR,
                                                backend="xla")
            e3 = max(e3, check_fp32_step(
                f"p11 {name}", {"routed": got, "plain path": plain_t}, table, uniq, sums,
                ADAGRAD_LR, acc=(torch.zeros(DLRM_ROWS, device="cuda"),
                                 {"routed": acc[:DLRM_ROWS].cuda(), "plain path": plain_a})))
    return e3


def check_fused(outs, seed):
    """(d): the fused group's routed lookup against the per-table routed
    lookups bit for bit; its routed AdaGrad update and the per-table ones,
    each table's rows held to the float64 step beside the plain path's
    single-table update. (Bit for bit they need not be: K3 adds a run's
    pieces at tile edges, and a table's runs start at other offsets of the
    fused stream than of its own.) Each table's routed lookup is also held,
    beside the plain version, to the float64 combine. Returns max |routed -
    plain| of the lookups (K1) and of the updates (K3)."""
    flat = (1, PAR_RANKS)
    fused = assemble([o["d"][0] for o in outs], ("model", None), flat).cuda()
    facc = assemble([o["d"][1] for o in outs], ("model",), flat).cuda()
    same = all(o["d_lookup_bits"] for o in outs)
    print(f"[p11 fused] fused_sharded_lookup of {DLRM_TABLES} tables x {DLRM_ROWS} x "
          f"{DLRM_WIDTH} (one K1 launch a rank) against the {DLRM_TABLES} per-table routed "
          f"lookups: {'equal bit for bit' if same else 'NOT EQUAL'}")
    if not same:
        raise SystemExit("[p11 fused] the fused lookup differs from the per-table ones")
    tables, e1, e3, bits = par_tables(seed), 0.0, 0.0, True
    for i, before in enumerate(tables):
        t = assemble([o["d"][2][i] for o in outs], ("model", None), flat)[:DLRM_ROWS]
        a = assemble([o["d"][3][i] for o in outs], ("model",), flat)[:DLRM_ROWS]
        rows = slice(i * DLRM_ROWS, (i + 1) * DLRM_ROWS)
        bits = bits and torch.equal(fused[rows].cpu(), t) and torch.equal(facc[rows].cpu(), a)
        idx, gy = dlrm_batch(seed, i)
        looked = assemble([o["d_lookup"][i] for o in outs], ("model", None), flat).cuda()
        e1 = max(e1, check_lookup_plain(f"p11 fused lookup, table {i}",
                                        {"routed fused": looked}, before, idx))
        uniq, *sums = float64_runs(gy, *fixed_coo(idx), None, idx.numel())
        plain_t, plain_a = before.clone(), torch.zeros(DLRM_ROWS, device="cuda")
        train.rowwise_adagrad_sparse_update(plain_t, plain_a, idx, gy, lr=ADAGRAD_LR,
                                            backend="xla")
        e3 = max(e3, check_fp32_step(
            f"p11 fused adagrad, table {i}",
            {"routed fused": fused[rows], "routed per-table": t.cuda(), "plain path": plain_t},
            before, uniq, sums, ADAGRAD_LR,
            acc=(torch.zeros(DLRM_ROWS, device="cuda"),
                 {"routed fused": facc[rows], "routed per-table": a.cuda(),
                  "plain path": plain_a})))
    print(f"[p11 fused] fused_sharded_adagrad_update (one K3 launch a rank) against the "
          f"{DLRM_TABLES} per-table routed updates: "
          f"{'equal bit for bit' if bits else 'not bit for bit'} (both within the bounds above)")
    return e1, e3


def check_trainer(label, results, shape, args):
    """(c): each step the sharded trainer recorded, replayed on one table
    per embedding table from the ranks' assembled blocks: its routed
    lookups held, beside the plain version, to the float64 combine, and
    its routed AdaGrad updates, beside the plain path's update with the
    same ids and pooled-output gradients, to the float64 step. Returns max
    |routed - plain| of the lookups (K1) and of the updates (K3)."""
    rows, e1, e3 = args.categories, 0.0, 0.0
    for step in results[0]["record"]:
        recs = [r["record"][step] for r in results]
        for nm in recs[0]["ids"]:
            def glob(key, spec):
                return assemble([r[key][nm] for r in recs], spec, shape).cuda()
            before, acc0 = glob("tables", ("model", None))[:rows], glob("accums", ("model",))[:rows]
            after = glob("tables_after", ("model", None))[:rows]
            acc1 = glob("accums_after", ("model",))[:rows]
            ids, gy = glob("ids", ("model", None)), glob("grads", ("model", None))
            name = f"p11 trainer {label}, step {step}, {nm}"
            e1 = max(e1, check_lookup_plain(f"{name} lookup",
                                            {"routed": glob("pooled", ("model", None))},
                                            before, ids))
            plain_t, plain_a = before.clone(), acc0.clone()
            train.rowwise_adagrad_sparse_update(plain_t, plain_a, ids, gy, lr=args.lr,
                                                backend="xla")
            uniq, *sums = float64_runs(gy, *fixed_coo(ids), None, ids.numel())
            e3 = max(e3, check_fp32_step(
                f"{name} adagrad", {"routed": after, "plain path": plain_t}, before, uniq,
                sums, args.lr, acc=(acc0, {"routed": acc1, "plain path": plain_a})))
    return e1, e3


def phase_parallel(seed, idx):
    """ROADMAP P11 below the planner on one card: PAR_RANKS ranks spawned on
    cuda:0 over gloo (NCCL refuses two ranks on one device), each counting
    its own launches with the plain versions forbidden. (a) config 2's
    table row-sharded, its request through row_sharded_lookup,
    alltoall_row_sharded_lookup and the latter with compress="int8"; (b) the
    8 routed updates at DLRMConfig's table shape; (c)
    examples/train_dlrm_sharded_torch.py at its defaults, and again at world
    size 1 over NCCL in this process, its first and last steps (the NCCL
    run's first) replayed on the plain path; (d) the fused DLRM group
    against the per-table routed calls (the lookups bit for bit, the
    AdaGrad updates against the float64 step) and the plain path. Returns
    the launches (summed over the ranks) and max |kernel - plain| of K1 and
    of K3."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        np.save(f"{tmp}/flagship_ids.npy", idx.cpu().numpy())
        torch.multiprocessing.spawn(par_rank, args=(PAR_RANKS, tmp, seed), nprocs=PAR_RANKS,
                                    join=True)
        outs = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(PAR_RANKS)]
        spawn_s = time.perf_counter() - t0
        one, one_launches, one_s = nccl_world_one(tmp)
    launches = np.zeros(4, np.int64)
    for o in outs:
        for part in "abcd":
            launches += np.array(o["launches"][part])
    K4_COUNTED["ranks"] += sum(o["k4"] for o in outs)
    secs = {p: round(max(o["seconds"][p] for o in outs), 2) for p in "abcd"}
    print(f"[p11 parallel] {PAR_RANKS} ranks on cuda:0 over gloo: {spawn_s:.1f} s with the "
          f"spawn; slowest rank's seconds by sub-phase {secs}; the routed flagship lookup "
          f"host ms, rank 0: {outs[0]['a2a_host_ms']:.1f}; launches (K1, K2, K3 full, K3 "
          f"compressed) summed over the ranks {tuple(int(x) for x in launches)}")
    e1 = check_flagship([o["a"] for o in outs], seed, idx)
    e1_d, e3_d = check_fused(outs, seed)
    args = load_example("train_dlrm_sharded_torch").parse_args([])
    e1_c, e3_c = check_trainer(f"{PAR_RANKS} ranks", [o["c"] for o in outs],
                               (1, PAR_RANKS), args)
    e1_one, e3_one = check_trainer("NCCL", [one], (1, 1), args)
    e1 = max(e1, e1_d, e1_c, e1_one)
    e3 = max(check_updates(outs, seed), e3_d, e3_c, e3_one)
    four = outs[0]["c"]["losses"]
    if any(o["c"]["losses"] != four for o in outs):
        raise SystemExit("[p11 trainer] the ranks disagree on the losses")
    rel = max(abs(a - b) / abs(b) for a, b in zip(four, one["losses"]))
    print(f"[p11 trainer] examples/train_dlrm_sharded_torch.py, defaults: {PAR_RANKS} ranks "
          f"(gloo) {four[0]:.6f} .. {four[-1]:.6f}, {outs[0]['c']['rate']:.0f} examples/s; "
          f"world size 1 (NCCL) {one['losses'][0]:.6f} .. {one['losses'][-1]:.6f}, "
          f"{one['rate']:.0f} examples/s, {one_s:.1f} s; max relative loss difference {rel:.3g} "
          f"(at most {PAR_LOSS_RTOL} passes; a secondary check beside the replays above)")
    if rel > PAR_LOSS_RTOL or not all(np.isfinite(four)):
        raise SystemExit("[p11 trainer] the 4-rank losses are off the one-rank losses")
    return launches + one_launches, e1, e3


# -- ROADMAP P11's planner: a planned collection at full size, the planner's
# example, and the CostModel calibration -----------------------------------------

PLAN_MESH = (2, 2)  # (data, model): 4 gloo ranks on the card
PLAN_RANKS = PLAN_MESH[0] * PLAN_MESH[1]
# benchmarks/planner_validation.py's four mixes and examples/plan_and_train.py's
# genre table: (name, rows, width, hotness, dtype, alpha).
PLAN_TABLES = (("skewed", 10_000_000, 128, 32, torch.bfloat16, 1.15),
               ("uniform", 10_000_000, 128, 32, torch.bfloat16, 0.0),
               ("wide", 512 * 1024, 512, 16, torch.float32, 1.05),
               ("huge", 16_000_000, 256, 64, torch.bfloat16, 1.05),
               ("genre", 512, 32, 2, torch.float32, 0.0))
# The card's defaults place the huge table hybrid (its calibrated head-hit
# rate is about 0.70) and, past that, column-sharded (its width splits into
# full lane tiles over the 2 model shards, and column_rows_max is 64M rows);
# with these two thresholds it takes the grid placement, so that every
# placement runs.
PLAN_OVERRIDE = dict(hybrid_min_hit_rate=0.8, column_rows_max=1 << 22)
PLAN_STEPS = 2  # AdaGrad steps; then one SGD step
PLAN_SGD_LR = 0.05
# Per rank: each AdaGrad step's lookups (K1: replicated, row-sharded, column,
# grid, and the hybrid's head and tail) and updates (K3 compressed, one a
# table and a second for the hybrid's head of 88,472 rows); the SGD step's
# updates; the sharded-CSR request on the replicated and the row-sharded
# table (K2).
PLAN_STEP_EXPECT, PLAN_SGD_EXPECT, PLAN_CSR_EXPECT = (6, 0, 0, 6), (0, 0, 0, 6), (0, 2, 0, 0)
# K4 a rank and AdaGrad step: the replicated table's update (the sharded
# updates apply with torch ops).
PLAN_STEP_K4 = 1
# The planner's example, a rank, its 5 steps: 4 ranks place genre replicated,
# item row-sharded and user hybrid (4 K1, 3 K3 compressed, 1 K4 a step); one
# rank replicates all three (3, 3 and 3).
PLAN_EXAMPLE_EXPECT = {4: (20, 0, 0, 15), 1: (15, 0, 0, 15)}
PLAN_EXAMPLE_K4 = {4: 5, 1: 15}
# The example's pooled norms on 4 ranks against one, a secondary check beside
# the replays (the hybrid's two partial sums round apart).
PLAN_NORM_RTOL = 1e-3
# The calibration: benchmarks/planner_validation.py's method for one card of
# a (data, model) = (CAL_COLS, CAL_SHARDS) mesh: plan()'s n_shards and
# col_shards.
CAL_SHARDS, CAL_COLS = 4, 2
# The sweeps the CostModel defaults come from, each placement against
# row_sharded: (field, placement, width, dtype, hotness, alpha, rows): a
# uniform width-128 bf16 table of 16 MiB .. 1 GiB; the wide mix's shape
# over 128K .. 64M rows (32 GiB a shard, two thirds of the default budget's
# rows for that shape); the huge mix's shape at 4 MiB .. 2 GiB a shard
# row-sharded (smaller tables replicate first: replicate_bytes_max is 32 MiB
# a shard at CAL_SHARDS).
CAL_SWEEPS = (
    ("replicate_bytes_max", "replicated", 128, torch.bfloat16, 32, 0.0,
     [s * 2**20 // 256 for s in (16, 32, 64, 128, 256, 512, 1024)]),
    ("column_rows_max", "column_sharded", 512, torch.float32, 16, 1.05,
     [v * 1024 for v in (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)]),
    ("grid_bytes_min", "grid_sharded", 256, torch.bfloat16, 64, 1.05,
     [f * 2**20 * CAL_SHARDS // 512 for f in (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)]),
)


def plan_configs():
    return [tce.TableConfig(n, v, w, hotness=h, dtype=dt) for n, v, w, h, dt, _ in PLAN_TABLES]


def plan_table(seed, i):
    """Planned table ``i`` (the package's init law, drawn on the card from one
    seed), the same in every process."""
    _, rows, width, _, dtype, _ = PLAN_TABLES[i]
    g = torch.Generator(device="cuda").manual_seed(seed * 100 + 70 + i)
    return init_table_(torch.empty((rows, width), dtype=dtype, device="cuda"), g)


def plan_grad(seed, step, i):
    """The pooled-output gradient of table ``i`` at ``step`` (fp32, on the card)."""
    g = torch.Generator(device="cuda").manual_seed(seed * 100 + 80 + 10 * step + i)
    return torch.randn((BATCH, PLAN_TABLES[i][2]), device="cuda", generator=g)


def plan_ids(seed):
    """Calibration ids and the steps' ids of every table (numpy, the
    package's generator): ``{f"{name}/{k}"}``, k = "calib", 0 .. PLAN_STEPS;
    and the sharded-CSR request on genre and uniform."""
    out = {}
    for i, (name, rows, _, hotness, _, alpha) in enumerate(PLAN_TABLES):
        gen = PowerLawGenerator(rows - 1, hotness, alpha, seed=seed + 90 + i, dtype=np.int64)
        out[f"{name}/calib"] = gen.sample(BATCH)
        for k in range(PLAN_STEPS + 1):
            out[f"{name}/{k}"] = gen.sample(BATCH)
    rng = np.random.default_rng(seed + 99)
    for name in ("genre", "uniform"):  # per-sample hotness U{0..H}, as bench.py --csr
        ids = out[f"{name}/0"]
        per = rng.integers(0, ids.shape[1] + 1, BATCH)
        out[f"{name}/csr_offsets"] = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
        out[f"{name}/csr"] = ids[np.arange(ids.shape[1])[None, :] < per[:, None]]
    return out


# Block specs by placement: the batch, the pooled output (and its gradient,
# unless named here), the table's parts and their accumulators.
PLAN_IDX_SPEC = {"column_sharded": ("data", None)}
PLAN_GY_SPEC = {"column_sharded": ("data", "model"), "grid_sharded": ("model", "data")}
PLAN_PART_SPECS = {"replicated": [((), ())], "column_sharded": [((None, "model"), ())],
                   "row_sharded": [(("model", None), ("model",))],
                   "grid_sharded": [(("model", "data"), ("model",))],
                   "hybrid": [((), ()), (("model", None), ("model",))]}


def plan_parts(p, name, placed, accums, model_index):
    """This rank's parts of table ``name``: (block, accumulator, global row of
    its first row) each; a hybrid table has its head and its tail block."""
    placement = p.tables[name].placement
    if placement == "hybrid":
        (head, tail), (hacc, tacc) = placed[name], accums[name]
        return [(head, hacc, 0), (tail, tacc, head.shape[0] + model_index * tail.shape[0])]
    t, a = placed[name], accums[name]
    lo = model_index * t.shape[0] if placement in ("row_sharded", "grid_sharded") else 0
    return [(t, a, lo)]


def row_fingerprints(t):
    """One int64 a row of ``t`` from its bits (a weighted sum with fixed odd
    weights, in chunks of rows): rows with other bits differ but by chance."""
    bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    if bits.dim() == 1:
        return bits.long()
    g = torch.Generator(device=t.device).manual_seed(1)
    w = torch.randint(1, 2**62, (t.shape[1],), device=t.device, generator=g) * 2 + 1
    return torch.cat([(bits[r0:r0 + (1 << 18)].long() * w).sum(dim=1)
                      for r0 in range(0, t.shape[0], 1 << 18)])


def plan_rank_steps(p, mesh, ids_np, seed, rank, tmp):
    """(a) in a rank: cut the blocks, run the counted steps and the CSR
    request, and save per table what the parent's replay needs: the pooled
    blocks and, at each step's touched rows, this rank's parts after the
    step. Rows the step did not touch must keep their bits (checked here,
    by fingerprints). Returns (launches, counted seconds, rows changed
    untouched, {"cut": seconds to cut the blocks, "saved": seconds to
    fingerprint, copy and save})."""
    from cuembed_tpu_torch import parallel as par
    from cuembed_tpu_torch.parallel.sharding import axis_index

    t0 = time.perf_counter()
    names = [t[0] for t in PLAN_TABLES]
    placed = {}
    for i, name in enumerate(names):  # one global table at a time
        placed.update(par.apply_plan(p, {name: plan_table(seed, i)}, mesh))
        torch.cuda.empty_cache()
    accums = par.planned_adagrad_init(p, placed, mesh)
    times = {"cut": time.perf_counter() - t0, "saved": 0.0}
    m = axis_index(mesh, "model")
    kinds = {n: tp.placement for n, tp in p.tables.items()}
    res = {n: {} for n in names}
    launches, seconds, strays = np.zeros(4, np.int64), 0.0, 0
    for k in range(PLAN_STEPS + 1):
        glob = {n: torch.from_numpy(ids_np[f"{n}/{k}"]).cuda() for n in names}
        idx = {n: par.local_block(glob[n], mesh, PLAN_IDX_SPEC.get(kinds[n], ("model", None)))
               for n in names}
        gys = {n: par.local_block(plan_grad(seed, k, i), mesh,
                                  PLAN_GY_SPEC.get(kinds[n], ("model", None)))
               for i, n in enumerate(names)}
        before = {n: [(row_fingerprints(t), row_fingerprints(a))
                      for t, a, _ in plan_parts(p, n, placed, accums, m)] for n in names}

        def step():
            if k == PLAN_STEPS:
                par.planned_sgd_update(p, placed, idx, gys, mesh=mesh, lr=PLAN_SGD_LR)
                return None
            pooled = par.planned_lookup(p, placed, idx, mesh=mesh)
            par.planned_adagrad_update(p, placed, accums, idx, gys, mesh=mesh, lr=ADAGRAD_LR)
            return pooled
        expect = PLAN_STEP_EXPECT if k < PLAN_STEPS else PLAN_SGD_EXPECT
        pooled, got, secs = par_counted(expect, f"planner step {k}", step,
                                        k4=PLAN_STEP_K4 if k < PLAN_STEPS else 0)
        launches += got
        seconds += secs
        t1 = time.perf_counter()
        for n in names:
            touched = torch.unique(glob[n])
            saved = []
            for (t, a, lo), (ft, fa) in zip(plan_parts(p, n, placed, accums, m), before[n]):
                sel = touched[(touched >= lo) & (touched < lo + t.shape[0])] - lo
                hit = torch.zeros(t.shape[0], dtype=torch.bool, device="cuda")
                hit[sel] = True
                strays += int(((row_fingerprints(t) != ft) & ~hit).sum())
                strays += int(((row_fingerprints(a) != fa) & ~hit).sum())
                saved.append((t[sel].cpu(), a[sel].cpu()))
            res[n][k] = {"parts": saved,
                         "pooled": None if pooled is None else pooled[n].cpu()}
        times["saved"] += time.perf_counter() - t1
    # One request in sharded-CSR blocks on the replicated and a routed table.
    csr = {}
    for n in ("genre", "uniform"):
        ib, ob, _ = par.shard_csr(ids_np[f"{n}/csr"], ids_np[f"{n}/csr_offsets"], PLAN_MESH[1])
        csr[n] = (par.local_block(torch.from_numpy(ib).cuda(), mesh, ("model", None)),
                  par.local_block(torch.from_numpy(ob).cuda(), mesh, ("model", None)))
    out, got, secs = par_counted(
        PLAN_CSR_EXPECT, "planner csr request",
        lambda: par.planned_lookup(p, placed, {n: c[0] for n, c in csr.items()},
                                   offsets={n: c[1] for n, c in csr.items()}, mesh=mesh))
    launches += got
    seconds += secs
    t1 = time.perf_counter()
    for n in names:
        if n in out:
            res[n]["csr"] = out[n].cpu()
        torch.save(res[n], f"{tmp}/rank{rank}_{n}.pt")
    times["saved"] += time.perf_counter() - t1
    return launches, seconds, strays, times


def plan_rank(rank, world, tmp, seed):
    """One rank of phase_planner's (a) and (b) on cuda:0 over gloo."""
    import datetime

    import torch.distributed as dist

    from cuembed_tpu_torch import parallel as par

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=PAR_GLOO_TIMEOUT_S))
    out = {}
    try:
        p = torch.load(f"{tmp}/plan.pt", weights_only=False)
        ids_np = dict(np.load(f"{tmp}/ids.npz"))
        out["a"] = plan_rank_steps(p, par.make_mesh(n_model=PLAN_MESH[1]), ids_np, seed,
                                   rank, tmp)
        torch.cuda.empty_cache()
        example = load_example("plan_and_train_torch")
        args = example.parse_args([])
        out["b"] = par_counted(
            PLAN_EXAMPLE_EXPECT[world], "planner example",
            lambda: example.train(args, torch.device("cuda", 0), record=(0, args.steps - 1)),
            k4=PLAN_EXAMPLE_K4[world])
        out["k4"] = K4_COUNTED["counted"]
        torch.save(out, f"{tmp}/rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def gather_parts(blocks, placement, k):
    """Table and accumulator rows at step ``k``'s touched rows, from every
    rank's parts: each part assembled under its specs, the parts in row
    order."""
    ts, accs = [], []
    for j, (tspec, aspec) in enumerate(PLAN_PART_SPECS[placement]):
        ts.append(assemble([b[k]["parts"][j][0] for b in blocks], tspec, PLAN_MESH))
        accs.append(assemble([b[k]["parts"][j][1] for b in blocks], aspec, PLAN_MESH))
    return torch.cat(ts).cuda(), torch.cat(accs).cuda()


def check_planned(p, ids_np, seed, tmp):
    """(a) in the parent, a table at a time: the global table drawn again
    and stepped along the ranks' results. Each step's pooled output
    (assembled) against the plain version and the float64 combine
    (``check_lookup_plain``); each update at its touched rows, beside the
    plain path's update of the same rows, against the float64 step
    (``check_fp32_step`` for fp32 tables, ``check_sparse_step`` and
    ``check_accumulators`` for bf16 ones); the CSR request against the
    plain version and the float64 combine. Returns max |kernel - plain| of
    K1, K2 and K3."""
    e1 = e2 = e3 = 0.0
    for i, (name, rows, width, hotness, dtype, _) in enumerate(PLAN_TABLES):
        kind = p.tables[name].placement
        blocks = [torch.load(f"{tmp}/rank{r}_{name}.pt", weights_only=False)
                  for r in range(PLAN_RANKS)]
        cur = plan_table(seed, i)
        acc = torch.zeros(rows, device="cuda")
        out_spec = ("data", None) if kind == "column_sharded" else ("model", None)
        for k in range(PLAN_STEPS + 1):
            ids = torch.from_numpy(ids_np[f"{name}/{k}"]).cuda()
            label = f"planner {name} ({kind}) step {k}"
            if k < PLAN_STEPS:
                pooled = assemble([b[k]["pooled"] for b in blocks], out_spec, PLAN_MESH).cuda()
                e1 = max(e1, check_lookup_plain(
                    f"{label} lookup", {kind: pooled}, cur, ids,
                    hot=p.tables[name].hot_rows if kind == "hybrid" else None))
            touched = torch.unique(ids)
            got_t, got_a = gather_parts(blocks, kind, k)
            local = torch.searchsorted(touched, ids)
            old, a0, gy = cur[touched], acc[touched], plan_grad(seed, k, i)
            plain_t, plain_a = old.clone(), a0.clone()
            uniq, *sums = float64_runs(gy, *fixed_coo(local), None, local.numel())
            if k == PLAN_STEPS:
                train.sgd_sparse_update(plain_t, local, gy, lr=PLAN_SGD_LR, backend="xla")
            else:
                train.rowwise_adagrad_sparse_update(plain_t, plain_a, local, gy, lr=ADAGRAD_LR,
                                                    backend="xla")
            if dtype == torch.float32:
                e3 = max(e3, check_fp32_step(
                    f"{label} update", {kind: got_t, "plain path": plain_t}, old, uniq, sums,
                    PLAN_SGD_LR if k == PLAN_STEPS else ADAGRAD_LR,
                    acc=None if k == PLAN_STEPS else (a0, {kind: got_a, "plain path": plain_a})))
            else:
                e3 = max(e3, check_sparse_step(f"{label} update", got_t, plain_t, old, uniq))
                if k < PLAN_STEPS:
                    check_accumulators(f"{label} update", {kind: got_a, "plain path": plain_a},
                                       a0, sums)
            if k == PLAN_STEPS and not torch.equal(got_a, a0):
                raise SystemExit(f"[{label}] SGD changed the accumulators")
            cur[touched], acc[touched] = got_t, got_a
            del plain_t, plain_a, got_t, got_a, old, sums
        if "csr" in blocks[0]:
            flat = torch.from_numpy(ids_np[f"{name}/csr"]).cuda()
            offsets = torch.from_numpy(ids_np[f"{name}/csr_offsets"]).cuda()
            out = assemble([b["csr"] for b in blocks], ("model", None, None),
                           PLAN_MESH).reshape(BATCH, width).cuda()
            e2 = max(e2, compare_in_chunks(out, cur, flat, offsets))
            per = offsets[1:] - offsets[:-1]
            live = torch.arange(hotness, device="cuda")[None, :] < per[:, None]
            fixed = torch.zeros((BATCH, hotness), dtype=torch.int64, device="cuda")
            fixed[live] = flat
            check_lookup_plain(f"planner {name} ({kind}) csr request", {kind: out}, cur,
                               fixed, weights=live.float())
        del cur, acc, blocks
        torch.cuda.empty_cache()
    return e1, e2, e3


def check_planned_example(label, results, shape):
    """(b): each step the planner's example recorded, replayed on one table
    per embedding table from the ranks' assembled blocks: the planned
    lookups held, beside the plain version, to the float64 combine; the
    planned AdaGrad updates (``grad_y = 2 * pooled``), beside the plain
    path's update with the same ids, to the float64 step. Returns max
    |planned - plain| of the lookups (K1) and of the updates (K3)."""
    example = load_example("plan_and_train_torch")
    p = results[0]["plan"]
    e1 = e3 = 0.0
    for step in results[0]["record"]:
        recs = [r["record"][step] for r in results]
        for nm, tp in p.tables.items():
            kind = tp.placement

            def table(key, which):
                specs = PLAN_PART_SPECS[kind]
                if kind == "hybrid":
                    return torch.cat([assemble([r[key][nm][j] for r in recs], s[which], shape)
                                      for j, s in enumerate(specs)]).cuda()
                return assemble([r[key][nm] for r in recs], specs[0][which], shape).cuda()
            rows = next(c.num_categories for c in example.table_configs() if c.name == nm)
            before, acc0 = table("tables", 0)[:rows], table("accums", 1)[:rows]
            after, acc1 = table("tables_after", 0)[:rows], table("accums_after", 1)[:rows]
            ids = assemble([r["ids"][nm] for r in recs], ("model", None), shape).cuda()
            pooled = assemble([r["pooled"][nm] for r in recs], ("model", None), shape).cuda()
            name = f"planner example {label}, step {step}, {nm} ({kind})"
            e1 = max(e1, check_lookup_plain(f"{name} lookup", {"planned": pooled}, before, ids,
                                            hot=tp.hot_rows if kind == "hybrid" else None))
            gy = 2.0 * pooled
            plain_t, plain_a = before.clone(), acc0.clone()
            train.rowwise_adagrad_sparse_update(plain_t, plain_a, ids, gy, lr=example.LR,
                                                backend="xla")
            uniq, *sums = float64_runs(gy, *fixed_coo(ids), None, ids.numel())
            e3 = max(e3, check_fp32_step(
                f"{name} adagrad", {"planned": after, "plain path": plain_t}, before, uniq,
                sums, example.LR, acc=(acc0, {"planned": acc1, "plain path": plain_a})))
    return e1, e3


def card_ids(rows, hotness, alpha, gen):
    """Power-law ids in [1, rows - 1] drawn on the card by datagen's inverse
    CDF (``translate_to_power_law``), without the per-sample
    de-duplication: timing inputs for the calibration."""
    u = torch.rand((BATCH, hotness), dtype=torch.float64, device="cuda", generator=gen)
    if alpha == 0.0:
        y = 1.0 + u * (rows - 1)
    elif alpha == 1.0:
        y = (rows - 1.0) ** u
    else:
        g = 1.0 - alpha
        y = (u * ((rows - 1.0) ** g - 1.0) + 1.0) ** (1.0 / g)
    return y.long().clamp(1, rows - 1)


def shard_step(placement, rows, width, dtype, ids, hot, hit, mesh1):
    """The lookup and row-wise AdaGrad update ``placement`` gives one card of
    a (data, model) = (CAL_COLS, CAL_SHARDS) mesh for a table of ``rows`` x
    ``width`` under the global batch ``ids``, on a one-rank group (its
    collectives are the identity). Replicated, row-sharded and hybrid
    tables are replicated over data: the card's block and its model block
    of the batch (ids folded into the block's rows), the replicated update
    over the whole batch. Column blocks take the width over model, the
    batch over data for the lookup and the whole batch for the update.
    Grid blocks take the rows over model and the width over data, and the
    card's model block of the batch. Returns the step as a function."""
    from cuembed_tpu_torch import parallel as par

    g = torch.Generator(device="cuda").manual_seed(5)
    n, c = CAL_SHARDS, CAL_COLS
    lr = 1e-6

    def new(r, w):
        return init_table_(torch.empty((r, w), dtype=dtype, device="cuda"), g)

    def grads(b, w):
        return torch.randn((b, w), device="cuda", generator=g)
    local = ids[:BATCH // n]
    if placement == "replicated":
        t, a, gy = new(rows, width), torch.zeros(rows, device="cuda"), grads(BATCH, width)

        def step():
            tce.embedding_lookup(t, local)
            train.rowwise_adagrad_sparse_update(t, a, ids, gy, lr=lr)
    elif placement == "row_sharded":
        r = -(-rows // n)
        t, a, gy, il = new(r, width), torch.zeros(r, device="cuda"), grads(BATCH // n, width), local % r

        def step():
            par.alltoall_row_sharded_lookup(t, il, mesh=mesh1)
            par.sharded_rowwise_adagrad_sparse_update(t, a, il, gy, mesh=mesh1, lr=lr)
    elif placement == "hybrid":
        r = -(-(rows - hot) // n)
        head, tail = new(hot, width), new(r, width)
        ha, ta = torch.zeros(hot, device="cuda"), torch.zeros(r, device="cuda")
        gy = grads(BATCH // n, width)
        il = torch.where(local < hot, local, hot + (local - hot) % r)
        cold = max(1.0 - hit, 1e-3)

        def step():
            par.hybrid_tiered_lookup(head, tail, il, mesh=mesh1, cold_frac=cold)
            par.sharded_hybrid_rowwise_adagrad_sparse_update(head, tail, ha, ta, il, gy,
                                                             mesh=mesh1, lr=lr, cold_frac=cold)
    elif placement == "column_sharded":
        t, a, gy = new(rows, width // n), torch.zeros(rows, device="cuda"), grads(BATCH, width // n)
        half = ids[:BATCH // c]

        def step():
            par.column_sharded_lookup(t, half, mesh=mesh1, gather_output=False)
            par.column_sharded_rowwise_adagrad_sparse_update(t, a, ids, gy, mesh=mesh1, lr=lr)
    else:  # grid_sharded
        r = -(-rows // n)
        t, a = new(r, width // c), torch.zeros(r, device="cuda")
        gy, ir = grads(BATCH // n, width // c), local % r

        def step():
            par.grid_sharded_lookup(t, ir, mesh=mesh1, gather_output=False)
            par.grid_sharded_rowwise_adagrad_sparse_update(t, a, ir, gy, mesh=mesh1, lr=lr)
    return step


def forced_plan(cfg, placement, hit):
    """plan() of ``cfg`` alone at CAL_SHARDS shards with the card's defaults,
    bent to ``placement``: its TablePlan (the comm estimate and, for hybrid,
    the head rows)."""
    from cuembed_tpu_torch.parallel import CostModel, plan

    big = 1 << 62
    cost, kw = {}, {}
    if placement == "replicated":
        cost = dict(replicate_bytes_max=big)
    elif placement == "hybrid":
        cost, kw = dict(replicate_bytes_max=0), dict(head_hit_rate={cfg.name: hit})
    elif placement == "column_sharded":
        cost, kw = dict(replicate_bytes_max=0, column_rows_max=big), dict(column_ok=True)
    elif placement == "grid_sharded":
        cost, kw = (dict(replicate_bytes_max=0, grid_bytes_min=0),
                    dict(grid_ok=True, col_shards=CAL_COLS))
    else:
        cost = dict(replicate_bytes_max=0)
    tp = plan([cfg], CAL_SHARDS, batch=BATCH, cost=CostModel(**cost), **kw).tables[cfg.name]
    return tp if tp.placement == placement else None


def modeled_step(cfg, placement, hit, ids, mesh1):
    """(compute ms on the card, its median ms, comm MB, modeled step ms) of
    ``placement``, or None where the placement cannot serve the table. The
    compute is the least of 10 timed steps (the steps wait on the host for
    the routing's capacity flag and the unique-row count, and the host's
    share of the machine moves their median between calls)."""
    from cuembed_tpu_torch.parallel.planner import NVLINK_BYTES_PER_S

    tp = forced_plan(cfg, placement, hit)
    if tp is None:
        return None
    step = shard_step(placement, cfg.num_categories, cfg.width, cfg.dtype, ids, tp.hot_rows,
                      hit, mesh1)
    st = bench.cuda_time_ms(step, warmup=2, iters=10, return_stats=True)
    del step
    torch.cuda.empty_cache()
    ms, comm = st["min"] * 1e3, tp.comm_bytes_per_step / NVLINK_BYTES_PER_S * 1e3
    return ms, st["median"] * 1e3, tp.comm_bytes_per_step / 2**20, ms + comm


def calibrate(hits):
    """(c) on a one-rank NCCL group: every feasible placement of each mix
    modeled (one card's compute on a (CAL_COLS, CAL_SHARDS) mesh, timed,
    plus the plan's comm bytes over the data sheet's NVLink rate) against
    plan()'s pick under the port's defaults; then the sweeps the defaults
    come from. Returns the number of mixes where plan() missed the modeled
    winner."""
    from cuembed_tpu_torch.parallel import CostModel, make_mesh, plan
    from cuembed_tpu_torch.parallel.planner import NVLINK_BYTES_PER_S

    mesh1 = make_mesh(n_model=1)
    gen = torch.Generator(device="cuda").manual_seed(17)
    places = ("replicated", "row_sharded", "hybrid", "column_sharded", "grid_sharded")
    misses = 0
    print(f"[planner calibration] a (data, model) = ({CAL_COLS}, {CAL_SHARDS}) mesh, batch "
          f"{BATCH}, AdaGrad; comm at {NVLINK_BYTES_PER_S / 1e9:.0f} GB/s (NVLink, H100 SXM data "
          f"sheet, one direction); the port's defaults {CostModel()}")
    for cfg, (_, _, _, _, _, alpha) in zip(plan_configs()[:4], PLAN_TABLES[:4]):
        hit = hits.get(cfg.name, 0.0)
        pick = plan([cfg], CAL_SHARDS, batch=BATCH, head_hit_rate={cfg.name: hit},
                    column_ok=True, grid_ok=True, col_shards=CAL_COLS).tables[cfg.name].placement
        ids = card_ids(cfg.num_categories, cfg.hotness, alpha, gen)
        rows = {pl: modeled_step(cfg, pl, hit, ids, mesh1) for pl in places
                if pl != "hybrid" or hit >= CostModel().hybrid_min_hit_rate}
        rows = {pl: r for pl, r in rows.items() if r is not None}
        winner = min(rows, key=lambda pl: rows[pl][3])
        misses += winner != pick
        for pl, (ms, med, mb, total) in rows.items():
            print(f"[planner calibration] {cfg.name} {cfg.num_categories} x {cfg.width} "
                  f"{str(cfg.dtype)[6:]} h{cfg.hotness} alpha {alpha} hit {hit:.3f}: {pl:<14} "
                  f"compute {ms:.4f} ms (median {med:.4f}), comm {mb:.1f} MB, modeled "
                  f"{total:.4f} ms; winner {winner}; plan() picks {pick}"
                  f"{'' if winner == pick else ' (MISS)'}")
    for field, other, width, dtype, hotness, alpha, sizes in CAL_SWEEPS:
        for rows in sizes:
            cfg = tce.TableConfig(field, rows, width, hotness=hotness, dtype=dtype)
            ids = card_ids(rows, hotness, alpha, gen)
            row = modeled_step(cfg, "row_sharded", 0.0, ids, mesh1)
            alt = modeled_step(cfg, other, 0.0, ids, mesh1)
            nbytes = rows * width * torch.empty((), dtype=dtype).element_size()
            print(f"[planner sweep {field}] {rows} x {width} {str(dtype)[6:]} h{hotness} alpha "
                  f"{alpha} ({nbytes / 2**20:.0f} MiB, {nbytes / CAL_SHARDS / 2**20:.0f} MiB "
                  f"row-sharded a shard): row_sharded compute {row[0]:.4f} ms (median "
                  f"{row[1]:.4f}), modeled {row[3]:.4f} ms; {other} compute {alt[0]:.4f} ms "
                  f"(median {alt[1]:.4f}), modeled {alt[3]:.4f} ms: "
                  f"{other if alt[3] <= row[3] else 'row_sharded'} wins")
    return misses


def phase_planner(seed):
    """ROADMAP P11's planner on one card, each run counted in its rank with
    the plain versions forbidden. (a) The planner phase's collection at full
    size (PLAN_TABLES) planned from calibration counts by
    ``plan_placement`` and run on 4 ranks spawned on cuda:0 over gloo as a
    (2, 2) mesh: 2 AdaGrad steps of ``planned_lookup`` and
    ``planned_adagrad_update``, one ``planned_sgd_update``, one sharded-CSR
    request; every lookup and update replayed in the parent. (b)
    examples/plan_and_train_torch.py at its defaults on the same ranks, and
    at world size 1 over NCCL in this process, its first and last steps
    replayed on the plain path. (c) The CostModel calibration on a one-rank
    NCCL group. Returns the launches (summed over the ranks and the NCCL
    run) and max |kernel - plain| of K1, K2 and K3."""
    import tempfile

    import torch.distributed as dist

    from cuembed_tpu_torch.parallel import CostModel

    t0 = time.perf_counter()
    print(f"[planner] total_memory of the card: "
          f"{torch.cuda.get_device_properties(0).total_memory} bytes; CostModel().hbm_bytes "
          f"{CostModel().hbm_bytes}")
    ids_np = plan_ids(seed)
    coll = tce.EmbeddingCollection(plan_configs())
    counts = coll.update_counts(coll.init_counts(),
                                {n: ids_np[f"{n}/calib"] for n, *_ in PLAN_TABLES})
    p = coll.plan_placement(PLAN_MESH[1], batch=BATCH, counts=counts,
                            cost=CostModel(**PLAN_OVERRIDE), column_ok=True, grid_ok=True,
                            col_shards=PLAN_MESH[0])
    print(f"[planner] head-hit rates {coll.head_hit_rates(counts)}; CostModel override "
          f"{PLAN_OVERRIDE}\n{p.summary()}")
    kinds = {tp.placement for tp in p.tables.values()}
    if kinds != set(PLAN_PART_SPECS):
        raise SystemExit(f"[planner] the plan places only {sorted(kinds)}")
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/ids.npz", **ids_np)
        torch.save(p, f"{tmp}/plan.pt")
        torch.multiprocessing.spawn(plan_rank, args=(PLAN_RANKS, tmp, seed), nprocs=PLAN_RANKS,
                                    join=True)
        spawn_s = time.perf_counter() - t0
        outs = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(PLAN_RANKS)]
        launches = np.zeros(4, np.int64)
        for o in outs:
            launches += o["a"][0] + np.array(o["b"][1])
        K4_COUNTED["ranks"] += sum(o["k4"] for o in outs)
        strays = sum(o["a"][2] for o in outs)
        slow = {key: round(max(o["a"][3][key] for o in outs), 2) for key in ("cut", "saved")}
        print(f"[planner] {PLAN_RANKS} ranks on cuda:0 over gloo: {spawn_s:.1f} s with the "
              f"spawn; slowest rank's seconds: cutting the blocks {slow['cut']}, the counted "
              f"steps and CSR request {max(o['a'][1] for o in outs):.2f}, fingerprints, copies "
              f"and saves {slow['saved']}, the example {max(o['b'][2] for o in outs):.2f}; "
              f"rows changed that no step touched: {strays}")
        if strays:
            raise SystemExit("[planner] an update changed rows its batch did not touch")
        e1, e2, e3 = check_planned(p, ids_np, seed, tmp)
    t1 = time.perf_counter()
    e1_b, e3_b = check_planned_example(f"{PLAN_RANKS} ranks",
                                       [o["b"][0] for o in outs], (1, PLAN_RANKS))
    example = load_example("plan_and_train_torch")
    args = example.parse_args([])
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store", rank=0,
                                world_size=1)
        try:
            with (plain_path_forbidden(cuda_forward, cuda_backward, dispatch),
                  counted(PLAN_EXAMPLE_EXPECT[1], "planner example, NCCL, world size 1",
                          k4=PLAN_EXAMPLE_K4[1], k5=PLAN_EXAMPLE_EXPECT[1][3])):
                one = example.train(args, torch.device("cuda", 0), record=(0, args.steps - 1))
            launches += np.array(PLAN_EXAMPLE_EXPECT[1])
            e1_one, e3_one = check_planned_example("NCCL", [one], (1, 1))
            t2 = time.perf_counter()
            with plain_path_forbidden(cuda_forward, cuda_backward, dispatch):
                misses = calibrate(coll.head_hit_rates(counts))
        finally:
            dist.destroy_process_group()
    four = outs[0]["b"][0]["norms"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(four, one["norms"]))
    print(f"[planner example] pooled norms, {PLAN_RANKS} ranks {four[0]:.4f} .. {four[-1]:.4f}, "
          f"world size 1 {one['norms'][0]:.4f} .. {one['norms'][-1]:.4f}: max relative "
          f"difference {rel:.3g} (at most {PLAN_NORM_RTOL} passes; a secondary check beside the "
          f"replays)")
    if rel > PLAN_NORM_RTOL:
        raise SystemExit("[planner example] the 4-rank norms are off the one-rank norms")
    print(f"[planner] (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, calibration "
          f"{time.perf_counter() - t2:.1f} s; plan() missed the modeled winner on {misses} of 4 "
          f"mixes")
    return launches, max(e1, e1_b, e1_one), e2, max(e3, e3_b, e3_one)


def request_step(lookup):
    """A chained step of one request: the ids bumped by the carry, the
    lookup, and its sum-of-squares probe carried on."""
    def step(carry, ids):
        i, dep = carry
        return (i + 1, bench.carry_probe(lookup(ids + bench.bump_from(dep))))
    return step


def phase_chip_record(seed, idx, small_batch):
    """The chip record the port resolved, a quick calibration beside the
    committed record, and the flagship and config-1 requests timed three
    ways. A timing harness, not a main path: its wrapper calls (graph
    captures among them, whose replays add none) are printed on their own
    line and kept out of the ``kernels`` line."""
    t0 = time.perf_counter()
    consts = chip.chip_constants()
    path = chip.record_path()
    print(f"[chip record] resolved {path or 'no record'}: device_kind "
          f"{consts['device_kind']!r}, {json.dumps(consts)}")
    if "h100" in chip.device_kind() and consts == chip.V5E_DEFAULTS:
        raise SystemExit("[chip record] an H100 resolved the v5e fallback")
    zero_counts()
    quick = calibrate_chip.measure(quick=True, log=lambda m: print(f"[chip record quick] {m}"))
    derived = chip.derive_chip_constants(quick)
    print(f"[chip record quick] record {json.dumps(quick)}")
    if path:
        with open(path) as f:
            print(f"[chip record committed] record {json.dumps(json.load(f))}")
    for name, c in (("quick", derived), ("committed", consts)):
        print(f"[chip record {name}] " + ", ".join(
            f"{k} {c[k]}" for k in ("hot_bytes", "vmem_table_bytes", "narrow_inline_pack_bytes",
                                    "tiering_min_hotness", "tiering_min_positions")))
    t1 = time.perf_counter()

    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    table = torch.empty((NUM_ROWS, WIDTH), dtype=torch.float16, device="cuda")
    init_table_(table, gen)
    small = tce.EmbeddingBag(SMALL_ROWS, SMALL_WIDTH, dtype=torch.float32)
    small.reset_parameters(generator=gen)
    dev = idx.device
    x0 = (torch.zeros((), dtype=torch.int32, device=dev),
          torch.zeros((), dtype=torch.float32, device=dev))
    with torch.no_grad():
        for name, request, ids, fk, hk in (
            ("config 2 flagship K1 request", lambda i: tce.embedding_lookup(table, i), idx,
             (4, 16), (2, 10)),
            ("config 1 EmbeddingBag request", small, small_batch, (32, 512), (10, 100)),
        ):
            step = request_step(request)
            dev_ms = bench.cuda_time_ms(lambda: request(ids))
            step_ms = bench.cuda_time_ms(lambda: step(x0, ids))
            fori = bench.fori_chain_time(step, x0, operands=(ids,), k_lo=fk[0], k_hi=fk[1],
                                         return_stats=True)
            host = bench.chain_time(lambda c: step(c, ids), x0, k_lo=hk[0], k_hi=hk[1],
                                    repeats=5, return_stats=True)
            print(f"[timers, {name}] cuda_time_ms (L2 flushed): the request "
                  f"{dev_ms:.4f} ms, the chained step (bump, request, probe) {step_ms:.4f} ms")
            print(f"[timers, {name}] fori_chain_time (CUDA graph chain, k {fk[0]}..{fk[1]}): "
                  f"min {fori['min'] * 1e3:.4f} ms, median {fori['median'] * 1e3:.4f} ms a step")
            print(f"[timers, {name}] chain_time (host clock, k {hk[0]}..{hk[1]}): min "
                  f"{host['min'] * 1e3:.4f} ms, median {host['median'] * 1e3:.4f} ms a step; "
                  f"the host's share a call (median): "
                  f"{(host['median'] - fori['median']) * 1e3:.4f} ms, "
                  f"{1 - fori['median'] / host['median']:.1%}")
            if fori["degenerate"] or host["degenerate"]:
                raise SystemExit(f"[timers, {name}] a degenerate chained time")
    torch.cuda.synchronize()
    got = launch_counts()
    if not got[0] or any(got[1:]):
        raise SystemExit(f"[chip record] wrapper calls (K1, K2, K3 full, K3 compressed) "
                         f"{got}; expected K1 only")
    print(f"[chip record] wrapper calls and graph captures, not launches (K1, K2, K3 full, "
          f"K3 compressed): {got}; calibration {t1 - t0:.1f} s, timers "
          f"{time.perf_counter() - t1:.1f} s")
    del table, small
    torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")

    t_start = time.perf_counter()
    k4_from = trace.counters()["launch.k4"]
    # 1. The card.
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    power_limit = smi.split(",")[-1].strip()
    print(f"[card] {kind}, {count} device(s); nvidia-smi: {smi}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. The build.
    phase_build()

    # 3. Parity grids: K1 and K2, then K3.
    phase_grid()
    phase_edges()
    phase_backward_grid()

    # Inputs of the main path, made before the counts are reset.
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    big = tce.EmbeddingBag(NUM_ROWS, WIDTH, dtype=torch.float16)
    big.reset_parameters(generator=gen)
    table = big.weight.detach()
    t0 = time.perf_counter()
    ids = PowerLawGenerator(NUM_ROWS - 1, HOTNESS, ALPHA, permute=True,
                            seed=args.seed, dtype=np.int64)
    batches_np = [ids.sample(BATCH) for _ in range(5)]
    idx = torch.from_numpy(batches_np[0]).cuda()
    rng = np.random.default_rng(args.seed + 11)
    per = rng.integers(0, HOTNESS + 1, BATCH)  # as bench.py --csr
    offsets_np = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
    nnz = int(offsets_np[-1])
    flat_np = np.zeros(BATCH * HOTNESS, np.int64)  # capacity B * H, padded
    flat_np[:nnz] = batches_np[0][np.arange(HOTNESS)[None, :] < per[:, None]]
    flat, offsets = torch.from_numpy(flat_np).cuda(), torch.from_numpy(offsets_np).cuda()
    csr_w = torch.from_numpy(rng.random(BATCH * HOTNESS, dtype=np.float32)).cuda()
    small = tce.EmbeddingBag(SMALL_ROWS, SMALL_WIDTH, dtype=torch.float32)
    small.reset_parameters(generator=gen)
    small_ids = PowerLawGenerator(SMALL_ROWS - 1, SMALL_HOTNESS, 0.0, seed=args.seed,
                                  dtype=np.int64)
    small_batches = [torch.from_numpy(small_ids.sample(SMALL_BATCH)).cuda()
                     for _ in range(5)]
    big_batches = [torch.from_numpy(b).cuda() for b in batches_np]
    # The same law without the permutation: ids of a table stored hot-first.
    hot_idx = torch.from_numpy(PowerLawGenerator(
        NUM_ROWS - 1, HOTNESS, ALPHA, seed=args.seed + 7, dtype=np.int64).sample(BATCH)).cuda()
    torch.cuda.synchronize()
    print(f"[inputs] {NUM_ROWS} x {WIDTH} fp16 table on the card; ids made on the "
          f"host in {time.perf_counter() - t0:.1f} s; CSR nnz {nnz} of capacity "
          f"{BATCH * HOTNESS}")

    # 4. The serving path, counted.
    csr_requests = [("sum_w", False), ("sum_w", True), ("mean", False), ("mean", True)]
    k1, k2 = cuda_forward.embedding_forward_cuda, cuda_forward.embedding_forward_cuda_csr
    with plain_path_forbidden(cuda_forward, dispatch):
        with counted((1, 0, 0, 0), "fixed"):
            fixed_out = tce.embedding_lookup(table, idx, backend="auto")
        csr_out = []
        for mode, lpm in csr_requests:
            with counted((0, 1, 0, 0), f"csr {mode} lpm={lpm}"):
                csr_out.append(tce.embedding_lookup_csr(
                    table, flat, offsets, csr_w if mode == "sum_w" else None,
                    mode=tce.CombineMode(mode.removesuffix("_w")),
                    low_precision_math=lpm, backend="auto"))
        n = len(small_batches) + len(big_batches)
        with counted((n, 0, 0, 0), "module requests"):
            small_out, small_ms = serve(small, small_batches, "module 100K x 32 fp32")
            big_out, big_ms = serve(big, big_batches, "module 10M x 256 fp16")
    launches = np.array((1 + n, len(csr_requests), 0, 0))

    # Correctness of the main path against the plain version.
    errs = {"K1": 0.0, "K2": 0.0}
    errs["K1"] = compare_in_chunks(fixed_out, table, idx)
    for out, (mode, lpm) in zip(csr_out, csr_requests):
        w = csr_w if mode == "sum_w" else None
        e = compare_in_chunks(out, table, flat, offsets, w,
                              mode=tce.CombineMode(mode.removesuffix("_w")),
                              low_precision_math=lpm)
        zero = torch.from_numpy(per == 0).cuda()
        if out[zero].any():
            raise SystemExit("[csr] a zero-hotness sample has a nonzero row")
        errs["K2"] = max(errs["K2"], e)
    errs["K1"] = max(errs["K1"],
                     compare_in_chunks(small_out, small.weight.detach(),
                                       small_batches[-1]),
                     compare_in_chunks(big_out, table, big_batches[-1]))
    for out, shape in ((fixed_out, (BATCH, WIDTH)), (big_out, (BATCH, WIDTH)),
                       (small_out, (SMALL_BATCH, SMALL_WIDTH))):
        if tuple(out.shape) != shape or out.dtype not in (torch.float16, torch.float32):
            raise SystemExit(f"unexpected output {tuple(out.shape)} {out.dtype}")
    print(f"[main path] max |kernel - plain|: {errs}")

    # Times, beside the plain version, the library call and the bound.
    fixed_t = timings(
        "fixed sum fp16", lambda: k1(table, idx), lambda: plain(table, idx),
        lambda: F.embedding_bag(idx, table, mode="sum"),
        bench.forward_bound(table, idx, BATCH),
        bench.forward_app_bytes(batch=BATCH, hotness=HOTNESS, width=WIDTH, elem_bytes=2))
    # torch's embedding_bag takes per-sample weights only in the table's dtype.
    live, live_w = flat[:nnz], csr_w[:nnz].to(table.dtype)
    csr_bytes = bench.forward_app_bytes(batch=BATCH, hotness=HOTNESS, width=WIDTH,
                                        elem_bytes=2, is_csr=True, nnz=nnz)
    csr_t = None
    for mode, lpm in csr_requests:
        w = csr_w if mode == "sum_w" else None
        m = tce.CombineMode(mode.removesuffix("_w"))
        extra = offsets.numel() * 8 + (nnz * 4 if w is not None else 0)
        t = timings(
            f"csr {mode}{' lpm' if lpm else ''} fp16",
            lambda: k2(table, flat, offsets, w, mode=m, low_precision_math=lpm),
            lambda: plain(table, flat, offsets, w, mode=m, low_precision_math=lpm),
            lambda: F.embedding_bag(live, table, offsets, mode=m.value,
                                    per_sample_weights=None if w is None else live_w,
                                    include_last_offset=True),
            bench.forward_bound(table, live, BATCH, extra_bytes=extra,
                                flops_per_element=2 if w is not None else 1),
            csr_bytes)
        csr_t = csr_t or t  # the weighted SUM request stands for K2

    # How much of a module request is the kernel: K1's device time on the
    # last batch, with L2 as the requests left it (not flushed).
    for name, bag, batch, request_ms in (
        ("module 100K x 32 fp32", small, small_batches[-1], small_ms),
        ("module 10M x 256 fp16", big, big_batches[-1], big_ms),
    ):
        dev = bench.cuda_time_ms(lambda: k1(bag.weight.detach(), batch),
                                 flush_l2=False)
        pr3 = f" (PR 3: {PR3_FWD_MS['config 1']} ms)" if bag is small else ""
        print(f"[{name}] K1 {dev:.4f} ms on the device (L2 warm){pr3} of the "
              f"{request_ms:.4f} ms request: the rest, {1 - dev / request_ms:.1%}, "
              f"is host time")

    # 7. The TPU engines' serving paths (ROADMAP P7) on the same kernels.
    p7_launches, p7_err = phase_p7_serving(table, idx, hot_idx, flat, offsets, csr_w,
                                           small, small_batches[0], args.seed)
    errs["K1"] = max(errs["K1"], p7_err)

    # Free the serving phase's tables for the training path.
    del big, table, fixed_out, csr_out, big_out, big_batches, small, small_out
    torch.cuda.empty_cache()

    # 5. The training path (BASELINE.json config 4,
    # benchmarks/train_benchmark.py:62): a 10M x 256 bf16 EmbeddingBag, the
    # flagship fixed and CSR batches, every count set to 0 first, the plain
    # versions forbidden.
    tbag = tce.EmbeddingBag(NUM_ROWS, WIDTH, dtype=torch.bfloat16)
    tbag.reset_parameters(generator=gen)
    # Dense steps: K1 and K3 full each; AdaGrad steps and the SGD step: K1
    # and K3 compressed each; the CSR SUM and MEAN backward: K2 and K3 full
    # each; the CONCAT backward: K3 full.
    train_launches = np.array((DENSE_STEPS + ADAGRAD_STEPS + 1, 2, DENSE_STEPS + 3,
                               ADAGRAD_STEPS + 1))
    with (plain_path_forbidden(cuda_forward, cuda_backward, dispatch),
          counted(train_launches, "training path", k4=ADAGRAD_STEPS,
                  k5=train_launches[2] + train_launches[3])):
        keep = drive_training(tbag, idx, flat, offsets, csr_w)
    dense_gy = keep["dense"][1]
    print(f"[training path] {DENSE_STEPS} dense steps (autograd + torch.optim.SGD; the "
          f"first ones include one-time set-up), host ms {[round(t, 4) for t in keep['dense_ms']]}, median "
          f"{statistics.median(keep['dense_ms']):.4f}; {ADAGRAD_STEPS} row-wise AdaGrad "
          f"steps, host ms {[round(t, 4) for t in keep['adagrad_ms']]}, median "
          f"{statistics.median(keep['adagrad_ms']):.4f}")
    errs["K3"] = check_training(tbag, idx, flat, offsets, csr_w, keep)
    del keep
    torch.cuda.empty_cache()
    errs["K3"] = max(errs["K3"], flagship_exact(idx, flat, offsets, gen))
    # 6. K3, the transpose and the steps, timed.
    k3_t = backward_timings(tbag.weight.detach(), idx, flat, offsets, csr_w, dense_gy)
    step_timings(tbag, idx)
    # 7. The TPU engines' training paths (ROADMAP P7).
    p7_train = phase_p7_training(tbag, idx, hot_idx, gen)
    del tbag
    torch.cuda.empty_cache()
    # K4, row-wise AdaGrad's apply, at the flagship's and DLRM-v2's shapes.
    errs["K4"], k4_t = phase_k4(gen)
    # K5, the COO transpose, at the same two lookups.
    k5_t = phase_k5(gen)

    # 8. Tables, collections, fused groups, the DLRM and its trainer (ROADMAP
    # P8, P9), each counted; K1, K2 and K3 only.
    p8_table, e_table = phase_tables_table(gen, idx, np.stack(batches_np[1:5]), flat,
                                           offsets, csr_w)
    p8_fused, e1_fused, e3_fused = phase_tables_fused(gen, args.seed)
    p9_dlrm, e1_dlrm, e3_dlrm = phase_dlrm(gen, args.seed)
    p9_trainer, e1_trainer, e3_trainer = phase_trainer(gen)
    phase_batched_collection(gen)
    print(f"[p8/p9] launches (K1, K2, K3 full, K3 compressed): table "
          f"{tuple(int(x) for x in p8_table)}, collection and fused "
          f"{tuple(int(x) for x in p8_fused)}, dlrm {tuple(int(x) for x in p9_dlrm)}, "
          f"trainer {tuple(int(x) for x in p9_trainer)}")
    errs["K1"] = max(errs["K1"], e1_fused, e1_dlrm, e1_trainer)
    errs["K3"] = max(errs["K3"], e_table, e3_fused, e3_dlrm, e3_trainer)

    # 9. The host-offloaded table (ROADMAP P10) and the parallel layer below
    # its planner (P11), each counted; K1 and K3 only.
    t9 = time.perf_counter()
    p10_offload, e1_offload, e3_offload = phase_offload(args.seed)
    t10 = time.perf_counter()
    p11_parallel, e1_parallel, e3_parallel = phase_parallel(args.seed, idx)
    print(f"[p10/p11] launches (K1, K2, K3 full, K3 compressed): offload "
          f"{tuple(int(x) for x in p10_offload)} in {t10 - t9:.1f} s, parallel (summed over "
          f"the ranks) {tuple(int(x) for x in p11_parallel)} in "
          f"{time.perf_counter() - t10:.1f} s")
    errs["K1"] = max(errs["K1"], e1_offload, e1_parallel)
    errs["K3"] = max(errs["K3"], e3_offload, e3_parallel)

    # 10. The placement planner (the rest of P11), counted; K1, K2 and K3 only.
    t11 = time.perf_counter()
    p11_planner, e1_planner, e2_planner, e3_planner = phase_planner(args.seed)
    print(f"[p11 planner] launches (K1, K2, K3 full, K3 compressed), summed over the ranks "
          f"and the NCCL run: {tuple(int(x) for x in p11_planner)} in "
          f"{time.perf_counter() - t11:.1f} s")
    errs["K1"] = max(errs["K1"], e1_planner)
    errs["K2"] = max(errs["K2"], e2_planner)
    errs["K3"] = max(errs["K3"], e3_planner)

    # 11. The chip record, a quick calibration and the chained timers.
    t12 = time.perf_counter()
    phase_chip_record(args.seed, idx, small_batches[0])
    print(f"[chip record] phase {time.perf_counter() - t12:.1f} s")

    # Launches of every counted run, (K1, K2, K3 full, K3 compressed).
    total = (launches + p7_launches + train_launches + p7_train + p8_table + p8_fused
             + p9_dlrm + p9_trainer + p10_offload + p11_parallel + p11_planner)
    print(f"[main path] launches of every path (K1, K2, K3 full, K3 compressed): "
          f"{tuple(int(x) for x in total)}")
    # K4, launched by every AdaGrad update on the card: the counted runs, as
    # for K1-K3; the timing loops and the checks' other updates apart.
    k4_total = K4_COUNTED["counted"] + K4_COUNTED["ranks"]
    print(f"[main path] K4 launches of every path: {k4_total} ({K4_COUNTED['ranks']} of them "
          f"the ranks')")
    print(f"[timing] K4 launches outside the counted runs (timing loops, updates beside "
          f"the checks), not counted above: "
          f"{trace.counters()['launch.k4'] - k4_from - K4_COUNTED['counted']}")
    if not k4_total:
        raise SystemExit("[main path] K4 never launched")
    print(f"[main path] K5 launches of this process's counted runs: {K5_COUNTED['counted']}")
    if K5_COUNTED["counted"] != K5_TOTAL:
        raise SystemExit(f"[main path] K5 launched {K5_COUNTED['counted']} times in the "
                         f"counted runs, expected {K5_TOTAL}")
    kernels = []
    for name, source, replaces, t, n in (
        ("K1 fixed_forward_kernel", "forward.cu", "pallas_forward.py:55", fixed_t,
         total[0]),
        ("K2 csr_forward_kernel", "forward.cu", "pallas_forward.py:274", csr_t, total[1]),
        ("K3 coo_backward_kernel", "backward.cu", "pallas_backward.py:58", k3_t,
         total[2] + total[3]),
    ):
        if not n:
            raise SystemExit(f"[main path] {name} never launched")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cuembed_tpu_torch/csrc/{source}",
            "replaces": f"cuembed_tpu/ops/{replaces}",
            "launches": int(n), "max_abs_err": errs[name[:2]],
            **t, "card": kind, "power_limit": power_limit,
        })
    kernels.append({
        "name": "K4 rowwise_adagrad_apply_kernel", "route": "cuda",
        "source": "cuembed_tpu_torch/csrc/adagrad.cu",
        "replaces": "no Pallas kernel: XLA gathers and scatters "
                    "(cuembed_tpu/train.py apply_compressed)",
        "launches": int(k4_total), "max_err_over_bound": errs["K4"],
        **k4_t, "card": kind, "power_limit": power_limit,
    })
    kernels.append({
        "name": "K5 histogram_kernel + digit_pass_kernel", "route": "cuda",
        "source": "cuembed_tpu_torch/csrc/transpose.cu",
        "replaces": "no Pallas kernel: torch.sort and the COO's gathers "
                    "(the JAX package's lax.sort)",
        "launches": int(K5_COUNTED["counted"]), "bit_for_bit": True,
        **k5_t, "card": kind, "power_limit": power_limit,
    })
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
