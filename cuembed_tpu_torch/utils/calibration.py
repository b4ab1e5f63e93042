"""Workload calibration for the tiered configs (shared by benchmarks), the
counterpart of ``cuembed_tpu/utils/calibration.py``.

Produces, for a power-law workload, everything a tiered config needs:
frequency ordering from *separate* calibration draws (the way a production
job uses running stats, never the measured batch), the remapped indices,
and a :class:`TieredConfig` with capacities tightened to observed
per-chunk maxima. The same arguments give the same config and remap as the
JAX function: it runs on the port's copies of ``auto_config``,
``PowerLawGenerator`` and the frequency helpers, and takes the same branch
on the native library (``cuembed_tpu_torch.native`` loads the same file).
On the card the config changes no result and no kernel; it is the JAX
package's layout, kept so that configs mean the same in both packages.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

import numpy as np

from cuembed_tpu_torch.ops.tiered import TieredConfig, auto_config
from cuembed_tpu_torch.utils.datagen import PowerLawGenerator
from cuembed_tpu_torch.utils.frequency import (
    calibrate_capacities,
    count_frequencies,
    frequency_order,
    tier_fractions,
)


def calibrate_powerlaw_workload(
    num_categories: int,
    batch: int,
    hotness: int,
    alpha: float,
    width: int,
    itemsize: int,
    *,
    permute: bool = True,
    seed: int = 7,
    calib_batches: int = 48,
    capacity_margin: float = 1.15,
    hot_bytes: Optional[int] = None,
) -> Tuple[Optional[TieredConfig], np.ndarray, Optional[np.ndarray]]:
    """Returns ``(cfg, measured_indices_remapped, remap)``.

    ``cfg`` is None when the JAX layout would serve the whole table from
    its hot budget (no tiering) — then the indices are returned unremapped
    and ``remap`` is None.
    """
    gen = PowerLawGenerator(
        num_categories - 1, hotness, alpha, seed=seed, permute=permute
    )
    idx_np = gen.sample(batch).astype(np.int32)

    kwargs = {} if hot_bytes is None else {"hot_bytes": hot_bytes}
    cfg = auto_config(num_categories, width, itemsize, hotness, **kwargs)
    if cfg is None:
        return None, idx_np, None

    from cuembed_tpu_torch import native as ce_native

    counts = None
    if ce_native.AVAILABLE:
        for i in range(calib_batches):
            calib = ce_native.powerlaw_indices(
                num_categories - 1, hotness, alpha, batch,
                seed=1000 + i, permutation=gen.permutation,
            )
            counts = count_frequencies(calib, num_categories, counts)
    else:
        for _ in range(max(4, calib_batches // 6)):
            counts = count_frequencies(
                gen.sample(batch), num_categories, counts
            )
    _, remap = frequency_order(counts)

    calib_batch = gen.sample(batch)
    head_f, cold_f = tier_fractions(
        calib_batch, remap, cfg.mxu_head_rows, cfg.hot_rows, margin=1.15
    )
    cfg = auto_config(
        num_categories, width, itemsize, hotness,
        cold_fraction=cold_f, head_fraction=head_f, **kwargs,
    )
    cfg = refine_tiered_config(
        cfg, remap[np.stack([calib_batch, gen.sample(batch)])],
        capacity_margin=capacity_margin,
    )
    return cfg, remap[idx_np], remap


def calibrate_csr_fields(
    cfg: TieredConfig,
    calib_offsets,
    value_capacity: int,
    *,
    margin: float = 1.15,
) -> TieredConfig:
    """Calibrate the CSR-specific capacities from observed offsets.

    Sets ``csr_live_cap`` (static bound on ``offsets[-1]``, the free
    live-prefix slice) and ``csr_chunk_samples`` (max samples any
    ``chunk_elems``-position window spans) from one or more offset
    arrays, each ``[batch + 1]``. Neither capacity changes a result.
    """
    offs_list = (
        [np.asarray(calib_offsets)]
        if np.asarray(calib_offsets[0]).ndim == 0
        else [np.asarray(o) for o in calib_offsets]
    )
    E = cfg.chunk_elems
    live_max = 0
    span_max = 1
    for offs in offs_list:
        live = int(offs[-1])
        live_max = max(live_max, live)
        if live <= 0:
            continue
        per = np.diff(offs)
        sm = np.repeat(np.arange(offs.shape[0] - 1, dtype=np.int64), per)
        n_chunks = -(-live // E)
        for g in range(n_chunks):
            lo, hi = g * E, min((g + 1) * E, live)
            span_max = max(span_max, int(sm[hi - 1] - sm[lo] + 1))
    live_cap = min(value_capacity, -(-int(live_max * margin) // E) * E)
    gs = -(-int(span_max * margin + 1) // 8) * 8
    # Same bound as auto_config: past ~chunk/3 the JAX engine disables its
    # one-hot combine (and keeps the slice).
    if gs > max(256, E // 3):
        gs = 0
    return replace(cfg, csr_live_cap=int(live_cap),
                   csr_chunk_samples=int(min(gs, E)))


def refine_tiered_config(
    cfg: TieredConfig,
    calib_remapped: np.ndarray,
    *,
    capacity_margin: float = 1.15,
    calib_offsets=None,
    value_capacity: int = 0,
) -> TieredConfig:
    """Refine every workload-dependent capacity from observed draws.

    ``calib_remapped``: one or more calibration batches of *remapped*
    (storage-row) indices — 1-D for a single batch, or batches stacked
    on axis 0 (``[n_batches, nnz]`` / ``[n_batches, batch, hotness]``).
    Sets the forward slot capacities (observed per-chunk maxima +
    margin), the backward non-head scatter bound, and the JAX backward's
    segment-reduce prefix.

    ``calib_offsets`` (CSR callers): one or more ``[batch + 1]`` offset
    arrays; with ``value_capacity`` (the static value-buffer length)
    this additionally calibrates ``csr_live_cap`` and
    ``csr_chunk_samples`` (:func:`calibrate_csr_fields`).
    """
    arr = np.asarray(calib_remapped)
    flat = arr.reshape(-1)
    mid_s, cold_s = calibrate_capacities(
        calib_remapped, None, cfg.mxu_head_rows, cfg.hot_rows,
        cfg.chunk_elems, margin=capacity_margin,
    )
    nonhead = float(np.mean(flat >= cfg.mxu_head_rows))
    # Observed maxima + margin replace the binomial formula values in
    # both directions, as in the JAX function (capacities only size the
    # JAX engine's static slices; calibrate_capacities clamps them).
    cfg = replace(
        cfg,
        mid_slots=mid_s,
        cold_slots=cold_s,
        nonhead_frac=min(1.0, nonhead * 1.03 + 0.005),
    )

    # The JAX backward's segment-reduce sizing: simulate the index-sorted
    # non-head stream and find the prefix of chunks whose local-unique
    # count stays under the slot target.
    u_target = 256
    # Batch-axis contract: a >=2-D input stacks batches on axis 0
    # ([n_batches, nnz] / [n_batches, batch, hotness]) — EXCEPT that a
    # single [batch, hotness] batch passed directly would misparse as
    # `batch` tiny batches (its trailing axis as nnz), silently skipping
    # this calibration. A 2-D input whose trailing axis is smaller than
    # one backward chunk cannot be a stacked-batch nnz axis, so it is
    # folded into ONE batch instead.
    if arr.ndim <= 1 or (arr.ndim == 2 and arr.shape[1] < cfg.bwd_seg_chunk):
        n_batches = 1
    else:
        n_batches = arr.shape[0]
    n_pos = flat.size // max(n_batches, 1)  # positions per batch (= nnz)
    nh_sorted = np.sort(flat[flat >= cfg.mxu_head_rows])
    chunkb = cfg.bwd_seg_chunk
    # The multi-batch stream has n_batches x the runs of one batch;
    # simulate a single batch by subsampling every n_batches-th entry
    # (preserves the per-batch unique-density curve to first order).
    nh_one = nh_sorted[::n_batches] if n_batches > 1 else nh_sorted
    n_chunks = nh_one.size // chunkb
    if n_chunks >= 1:
        r = nh_one[: n_chunks * chunkb].reshape(-1, chunkb)
        uniq_per = (r[:, 1:] != r[:, :-1]).sum(axis=1) + 1
        # Largest prefix staying under the target with ~10% headroom
        # (batch-to-batch variance; overflow only costs the fallback).
        over = uniq_per > int(u_target / 1.1)
        k_pref = int(np.argmax(over)) if over.any() else n_chunks
        if k_pref >= 1:
            cfg = replace(
                cfg,
                bwd_seg_slots=u_target,
                bwd_run_frac=k_pref * chunkb / max(n_pos, 1),
            )
    if calib_offsets is not None and value_capacity > 0:
        cfg = calibrate_csr_fields(
            cfg, calib_offsets, value_capacity, margin=capacity_margin
        )
    return cfg
