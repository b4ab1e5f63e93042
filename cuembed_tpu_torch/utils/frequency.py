"""Frequency ordering for the hot-first table layout.

A copy of ``cuembed_tpu/utils/frequency.py`` (numpy only), kept in the port
so that it imports nothing of the JAX package: the same counts give the
same orders, fractions and capacities. :func:`reorder_table` also takes a
torch tensor and gathers its rows on the tensor's device.

The JAX package's tiered lookup wants the table stored with the most
frequently accessed categories first. Category ids in the wild are
arbitrary (the reference's datagen permutes them by default,
``embedding_allocation.h:94``), so the framework maintains:

* ``perm``  — ``new_row -> original_category`` (descending frequency),
* ``remap`` — ``original_category -> new_row`` (its inverse), applied to
  incoming indices as one extra gather.

A stale ordering changes no result: the remap composes with the reorder.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def count_frequencies(
    indices: np.ndarray,
    num_categories: int,
    counts: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Accumulate category frequencies from a batch of lookup indices."""
    new = np.bincount(
        np.asarray(indices).reshape(-1), minlength=num_categories
    )[:num_categories]
    if counts is None:
        return new.astype(np.int64)
    return counts + new


def decay_counts(counts: np.ndarray, rate: float = 0.9) -> np.ndarray:
    """Exponentially decay running counts (streaming frequency stats).

    Production traffic drifts; decaying before each accumulation window
    keeps the ordering responsive to the recent distribution. Integer
    counts round down, so long-cold categories decay to exactly zero.
    """
    if not 0.0 <= rate <= 1.0:
        raise ValueError("rate must be in [0, 1]")
    return (np.asarray(counts) * rate).astype(np.int64)


def frequency_order(counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Return ``(perm, remap)`` for a frequency-descending row layout.

    ``perm[new_row] = original_category`` (stable sort, most frequent
    first); ``remap[original_category] = new_row``.
    """
    counts = np.asarray(counts)
    perm = np.argsort(-counts, kind="stable").astype(np.int32)
    remap = np.empty_like(perm)
    remap[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return perm, remap


def reorder_table(table, perm):
    """Rows of ``table`` in the new layout (``table[perm]``); a torch
    tensor is gathered on its own device (``index_select``)."""
    import torch

    if isinstance(table, torch.Tensor):
        p = torch.as_tensor(np.asarray(perm, np.int64), device=table.device)
        return table.index_select(0, p)
    return table[np.asarray(perm)]


def tier_fractions(
    indices: np.ndarray,
    remap: Optional[np.ndarray],
    head_rows: int,
    hot_rows: int,
    *,
    margin: float = 1.3,
) -> Tuple[float, float]:
    """``(head_fraction, cold_fraction)`` estimates for auto_config.

    ``head_fraction`` is reported with a *negative* margin (understating
    the head overstates the mid tier, which is the safe direction for
    capacity sizing); ``cold_fraction`` with a positive one.
    """
    flat = np.asarray(indices).reshape(-1)
    if remap is not None:
        flat = np.asarray(remap)[flat]
    head = float(np.mean(flat < head_rows))
    cold = float(np.mean(flat >= hot_rows))
    return (
        max(0.0, head / margin - 0.005),
        min(1.0, max(1e-3, cold * margin + 0.005)),
    )


def calibrate_capacities(
    indices: np.ndarray,
    remap: Optional[np.ndarray],
    head_rows: int,
    hot_rows: int,
    chunk_elems: int,
    *,
    margin: float = 1.15,
) -> Tuple[int, int]:
    """``(mid_slots, cold_slots)`` from observed per-chunk maxima.

    Tighter than the binomial mean+6σ formula because it measures the
    real per-chunk load (including any within-batch correlation) and
    applies one margin instead of stacking fraction and sigma slack.
    Feed multiple batches for a stable maximum; undersizing only
    triggers the exact fallback.
    """
    flat = np.asarray(indices).reshape(-1)
    if remap is not None:
        flat = np.asarray(remap)[flat]
    pad = (-flat.size) % chunk_elems
    flat = np.pad(flat, (0, pad))
    ch = flat.reshape(-1, chunk_elems)
    mid_max = int(((ch >= head_rows) & (ch < hot_rows)).sum(axis=1).max())
    cold_max = int((ch >= hot_rows).sum(axis=1).max())

    def round8(x):
        return min(chunk_elems, max(8, -(-x // 8) * 8))

    return (
        round8(int(mid_max * margin) + 8),
        round8(int(cold_max * margin) + 8),
    )


def cold_fraction(
    indices: np.ndarray,
    remap: Optional[np.ndarray],
    hot_rows: int,
    *,
    margin: float = 1.3,
) -> float:
    """Estimated fraction of lookups missing the hot head, with margin.

    Feed this to :func:`cuembed_tpu_torch.ops.tiered.auto_config` as
    ``cold_fraction`` — it sizes the static cold capacity. The margin
    absorbs batch-to-batch variance; an undersized capacity only triggers
    the exact fallback (slow, never wrong).
    """
    flat = np.asarray(indices).reshape(-1)
    if remap is not None:
        flat = np.asarray(remap)[flat]
    frac = float(np.mean(flat >= hot_rows))
    return min(1.0, max(1e-3, frac * margin + 0.005))


def calibrate_capacity_factor(
    counts: np.ndarray,
    n_shards: int,
    batch: int,
    hotness: int,
    *,
    target_overflow: float = 0.01,
    trials: int = 200,
    seed: int = 0,
) -> float:
    """Routed-lookup ``capacity_factor`` from measured traffic.

    The all-to-all paths (the JAX package's ``parallel``) size a static
    per-destination slot block ``cap = nnz_local / n * capacity_factor``
    and fall back to exact full-capacity routing when any owner bucket
    overflows — correct but a whole extra round trip. The default 2.0
    is a guess; this measures it: simulate ``trials`` local batches
    drawn from the empirical category distribution, bucket each by
    owner shard (contiguous ``rows_per`` blocks, the routing rule in
    ``alltoall_lookup._owner_buckets``), and return the smallest factor
    whose slot block covers the ``1 - target_overflow`` quantile of the
    observed per-(shard, owner) maxima.

    Frequency-ordered tables concentrate hot rows on shard 0, so the
    calibrated factor can be much larger than 2.0 — that is the real
    traffic pattern, and knowing it beats silently paying the fallback
    every step. Feed decayed counts (:func:`decay_counts`) for drifting
    workloads.
    """
    counts = np.asarray(counts, np.float64)
    if counts.sum() <= 0:
        raise ValueError("counts are empty — observe traffic first")
    if n_shards < 2:
        return 1.0
    p = counts / counts.sum()
    num_categories = counts.shape[0]
    rows_per = -(-num_categories // n_shards)
    nnz_l = -(-batch * hotness // n_shards)
    balanced = nnz_l / n_shards
    rng = np.random.default_rng(seed)
    owner_of = np.minimum(
        np.arange(num_categories) // rows_per, n_shards - 1
    )
    maxima = np.empty(trials, np.int64)
    for t in range(trials):
        # one trial = every shard's local batch in the same step; the
        # fallback triggers if ANY (shard, owner) bucket overflows
        draws = rng.choice(
            num_categories, size=(n_shards, nnz_l), p=p
        )
        per_owner = np.stack([
            np.bincount(owner_of[d], minlength=n_shards) for d in draws
        ])
        maxima[t] = per_owner.max()
    q = float(np.quantile(maxima, 1.0 - target_overflow))
    return max(q / balanced, 1.0)
