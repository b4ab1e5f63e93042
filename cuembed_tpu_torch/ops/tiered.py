"""The tiered lookup's configuration and its forward, the counterpart of
``cuembed_tpu/ops/tiered.py``.

On a TPU the tiered engine exists because the chip has no hardware gather:
a hot head held in VMEM, a chunked sort into mid and cold tiers, and
one-hot matmul combines. An H100 gathers any row at any width, and K1 and
K2 already serve the whole table at the rate the access pattern allows, so
the port keeps the engine's API and its results and not its mechanism:

* :class:`TieredConfig`, :func:`auto_config`, :func:`csr_combine_config`
  and :func:`tiering_profitable` compute the same configurations and the
  same decisions as the JAX package, from the same numbers: the active chip
  record (:func:`~cuembed_tpu_torch.utils.chip.chip_constants`), read where
  the JAX package reads its own, so that a configuration made in one
  package means the same in the other under any record.
* :func:`tiered_forward` keeps its signature and its errors and serves the
  whole table through K1 (fixed hotness) or K2 (CSR) for CUDA tensors, and
  through the plain PyTorch version for CPU tensors. Its only lossy option,
  the int8 head (``q_head``), mixes int8 rows into the sum exactly where
  the JAX engine would (:mod:`cuembed_tpu_torch.ops.quant`).

The JAX engine reassociates each sample's sum (hot positions first, cold
ones after); K1 and K2 sum in position order. The two agree bit for bit
where every partial sum is exact, and to rounding elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import sqrt

import torch

from cuembed_tpu_torch.ops import cuda_forward
from cuembed_tpu_torch.ops.transforms import extract_row_ids_from_csr
from cuembed_tpu_torch.types import CombineMode, accumulation_dtype
from cuembed_tpu_torch.utils.chip import V5E_DEFAULTS, chip_constants

# The JAX package's fallback budget (its built-in v5e record), as it keeps
# it: the default of the callers that size a layout themselves (tables,
# collections, the planner). The active values come from chip_constants().
# A budget sizes a configuration and changes no result: the port serves
# every configuration through K1, K2 and K3 on the whole table.
DEFAULT_HOT_BYTES = V5E_DEFAULTS["hot_bytes"]


@dataclass(frozen=True)
class TieredConfig:
    """Static configuration of the tiered lookup (hashable), field for
    field the JAX package's.

    Attributes:
      hot_rows: rows ``[0, hot_rows)`` are the hot head.
      chunk_elems: flattened index positions per chunk; a multiple of the
        fixed hotness.
      cold_slots, mid_slots: per-chunk capacities of the cold and mid tiers;
        they change results only through the int8 head (see
        :func:`tiered_forward`).
      mxu_head_rows: rows ``[0, mxu_head_rows)`` whose gradient the tiered
        backward takes as one product ``M^T @ grad_y``; 0 disables it.
      nonhead_frac: calibrated fraction of positions outside that head.
      bwd_seg_chunk, bwd_seg_slots, bwd_run_frac: the TPU backward's
        segment-reduce sizing; results do not depend on them.
      csr_chunk_samples: CSR combine capacity; 0 selects the segment sum.
      csr_live_cap: a bound on ``offsets[-1]``; it changes no result.
    """

    hot_rows: int
    chunk_elems: int = 1024
    cold_slots: int = 256
    mxu_head_rows: int = 128
    mid_slots: int = 640
    nonhead_frac: float | None = None
    bwd_seg_chunk: int = 2048
    bwd_seg_slots: int = 0
    bwd_run_frac: float = 0.0
    csr_chunk_samples: int = 0
    csr_live_cap: int = 0


def tiering_profitable(positions: int, avg_hotness: float) -> bool:
    """The JAX package's batch-shape gate for its tiered engine: at least
    the active record's ``tiering_min_hotness`` positions a sample and
    ``tiering_min_positions`` in all. Callers use it as the JAX package
    does; here it picks between two routes to the same kernels, so it
    changes no result."""
    c = chip_constants()
    return (avg_hotness >= c["tiering_min_hotness"]
            and positions >= c["tiering_min_positions"])


def _capacity(chunk_elems: int, p: float) -> int:
    """Static slot count for a binomial(chunk_elems, p) load, mean + 6σ."""
    p = min(max(p, 1e-3), 1.0)
    mean = chunk_elems * p
    slots = int(mean + 6.0 * sqrt(chunk_elems * p * (1.0 - p)) + 1)
    return min(chunk_elems, max(8, -(-slots // 8) * 8))


def auto_config(
    num_categories: int,
    width: int,
    itemsize: int,
    hotness: int = 1,
    *,
    cold_fraction: float = 0.25,
    head_fraction: float = 0.45,
    hot_bytes: int | None = None,
    vmem_table_bytes: int | None = None,
) -> TieredConfig | None:
    """The JAX package's tiered config for a table and hotness, or None
    when its whole table would fit the hot budget (same arithmetic;
    ``hot_bytes`` and ``vmem_table_bytes`` default to the active record's,
    :func:`~cuembed_tpu_torch.utils.chip.chip_constants`)."""
    if hot_bytes is None:
        hot_bytes = chip_constants()["hot_bytes"]
    if vmem_table_bytes is None:
        vmem_table_bytes = chip_constants()["vmem_table_bytes"]
    table_bytes = num_categories * width * itemsize
    if table_bytes <= vmem_table_bytes:
        return None
    row_bytes = width * itemsize
    hot_rows = min(num_categories, max(8, hot_bytes // row_bytes))
    if hot_rows >= num_categories:
        return None
    hotness = max(1, hotness)
    group = max(1, 2048 // hotness)
    chunk_elems = group * hotness
    mid_fraction = max(0.02, 1.0 - cold_fraction - head_fraction)
    csr_samples = min(chunk_elems, 2 * chunk_elems // hotness + 64)
    return TieredConfig(
        hot_rows=int(hot_rows),
        chunk_elems=chunk_elems,
        cold_slots=_capacity(chunk_elems, cold_fraction),
        mxu_head_rows=min(256, int(hot_rows)),
        mid_slots=_capacity(chunk_elems, mid_fraction),
        csr_chunk_samples=(
            csr_samples if csr_samples <= max(256, chunk_elems // 3) else 0
        ),
    )


def csr_combine_config(
    num_categories: int,
    avg_hotness: float,
    *,
    chunk_elems: int = 2048,
    live_cap: int = 0,
) -> TieredConfig | None:
    """The JAX package's combine-only CSR config (no frequency order
    needed), or None where its combine would not pay."""
    hotness = max(1, int(avg_hotness))
    csr_samples = min(chunk_elems, 2 * chunk_elems // hotness + 64)
    if csr_samples > max(256, chunk_elems // 3) and live_cap <= 0:
        return None
    return TieredConfig(
        hot_rows=int(num_categories),
        chunk_elems=chunk_elems,
        cold_slots=0,
        mxu_head_rows=0,
        mid_slots=0,
        csr_chunk_samples=(
            csr_samples if csr_samples <= max(256, chunk_elems // 3) else 0
        ),
        csr_live_cap=int(live_cap),
    )


def _combine_coeff(indices, weights, offsets, mode, acc_dt):
    """Per-position combine coefficient (weight, 1, or 1/hotness) in
    ``acc_dt``, shaped like ``indices``."""
    if weights is not None:
        coeff = weights.to(acc_dt)
    else:
        coeff = torch.ones(indices.shape, dtype=acc_dt, device=indices.device)
    if mode == CombineMode.MEAN:
        if offsets is None:
            coeff = coeff / indices.shape[1]
        else:
            hot = (offsets[1:] - offsets[:-1]).to(acc_dt)
            inv = torch.where(hot == 0, torch.zeros_like(hot), 1.0 / hot.clamp(min=1.0))
            sm = extract_row_ids_from_csr(offsets, indices)
            coeff = coeff * inv[sm.long()]
    return coeff


def check_chunking(cfg: TieredConfig, hotness: int) -> None:
    """The fixed-hotness engine's chunking contract (JAX raises it too)."""
    if cfg.chunk_elems % hotness != 0:
        raise ValueError(
            f"chunk_elems ({cfg.chunk_elems}) must be a multiple of hotness "
            f"({hotness}); use auto_config(..., hotness=...)"
        )


def tiered_forward(
    table: torch.Tensor,
    indices: torch.Tensor,
    offsets: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    *,
    mode: CombineMode = CombineMode.SUM,
    cfg: TieredConfig,
    low_precision_math: bool = False,
    pack_k: int = 1,
    q_head=None,
) -> torch.Tensor:
    """Tiered forward lookup: the contract of the JAX ``tiered_forward``
    (``embedding_forward_xla``'s, minus CONCAT).

    Fixed hotness (``indices [batch, hotness]``) runs on K1 and CSR (flat
    ``indices`` and ``offsets [batch+1]``) on K2, over the whole table, for
    CUDA tensors; CPU tensors take the plain version. ``pack_k > 1``: the
    table is line-packed (:func:`cuembed_tpu_torch.ops.narrow.pack_narrow`,
    ``[ceil(V/k), k*W]``) and ``indices`` address logical rows; the kernels
    read its ``[ceil(V/k)*k, W]`` view, with no copy.

    ``q_head``: the lossy int8 head (:class:`~cuembed_tpu_torch.ops.quant.QuantizedHead`,
    fixed-hotness 3-tier configs only). Positions with ``mxu_head_rows <=
    idx < q_head.rows`` take the int8 row, times its scale and coefficient;
    every other position takes the exact row. As in the JAX engine, a batch
    that holds a chunk of ``chunk_elems`` positions (the last one padded
    with row 0) with more than ``mid_slots`` int8 positions or more than
    ``cold_slots`` positions past the int8 rows is served exactly. The
    result refuses gradients.
    """
    if mode == CombineMode.CONCAT:
        raise ValueError("CONCAT is a pure gather; tiered path does not apply")
    if weights is not None and mode != CombineMode.SUM:
        raise ValueError("weights are only supported with CombineMode.SUM")
    if pack_k > 1 and (offsets is not None or cfg.mxu_head_rows <= 0):
        raise ValueError(
            "pack_k > 1 (line-packed narrow tiering) supports the "
            "fixed-hotness 3-tier path only"
        )
    if q_head is not None:
        if pack_k > 1 or offsets is not None or cfg.mxu_head_rows <= 0:
            raise ValueError(
                "q_head (int8 head) supports the fixed-hotness 3-tier path only"
            )
        if q_head.width != table.shape[1]:
            raise ValueError("q_head width must match the table")
    if offsets is None:
        check_chunking(cfg, indices.shape[1])
    if pack_k > 1:
        table = table.view(-1, table.shape[1] // pack_k)
    if weights is not None:
        weights = weights.to(torch.float32)
    if q_head is not None:
        from cuembed_tpu_torch.ops import quant

        return quant.serving_only_guard(_forward_q_head(
            table, indices, weights, mode, cfg, low_precision_math, q_head))
    if offsets is None:
        return cuda_forward.embedding_forward_cuda(
            table, indices, weights, mode=mode, low_precision_math=low_precision_math)
    return cuda_forward.embedding_forward_cuda_csr(
        table, indices, offsets, weights, mode=mode,
        low_precision_math=low_precision_math)


def int8_served(indices: torch.Tensor, cfg: TieredConfig, q_rows: int) -> torch.Tensor:
    """``[batch, hotness]`` bool: the positions the JAX engine serves from an
    int8 head of ``q_rows`` rows, ``mxu_head_rows <= idx < q_rows``, and
    none when a chunk overflows its slots (``tiered.py``'s ``overflow``).
    Computed on the device, with no host sync."""
    head = min(cfg.mxu_head_rows, q_rows)
    e = cfg.chunk_elems
    flat = indices.reshape(-1)
    pad = -flat.numel() % e
    if pad:  # padding is row 0, a head position: it counts in neither tier
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.view(-1, e)
    mid = ((chunks >= head) & (chunks < q_rows)).sum(dim=1)
    cold = (chunks >= q_rows).sum(dim=1)
    overflow = (mid > min(cfg.mid_slots, e)).any() | (cold > min(cfg.cold_slots, e)).any()
    return (indices >= head) & (indices < q_rows) & ~overflow


def _forward_q_head(table, indices, weights, mode, cfg, low_precision_math, q_head):
    """Exact rows through K1 (or the plain version) with the int8 positions'
    coefficients set to 0, plus the int8 positions' rows times their scales
    and coefficients (``quant.pooled_int8``), rounded to the table's type."""
    from cuembed_tpu_torch.ops.quant import pooled_int8

    acc_dt = accumulation_dtype(table.dtype, low_precision_math)
    coeff = _combine_coeff(indices, weights, None, mode, torch.float32)
    served = int8_served(indices, cfg, q_head.rows)
    zero = torch.zeros((), dtype=torch.float32, device=coeff.device)
    exact = cuda_forward.embedding_forward_cuda(
        table, indices, torch.where(served, zero, coeff).contiguous(),
        mode=CombineMode.SUM, low_precision_math=low_precision_math)
    int8 = pooled_int8(q_head.data, torch.where(served, indices, 0),
                       torch.where(served, coeff, zero), q_head.width)
    return (exact.to(acc_dt) + int8.to(acc_dt)).to(table.dtype)
