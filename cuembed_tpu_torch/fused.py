"""Fused multi-table lookup: many same-width tables as ONE physical table,
the counterpart of ``cuembed_tpu/fused.py`` (its single-device part).

Production recommenders run dozens of small embedding tables (DLRM: 26).
Fusion stacks same-(width, dtype) tables row-wise into one physical table
and offsets each table's ids by its base row, so the whole group is served
by ONE lookup (one K1 launch on the card) and ONE sparse update (one K3
launch), where the tables one by one take a launch each.

The per-sample combine stays per table: the ``[batch, H_t]`` index blocks
are stacked to ``[batch * T, H_max]`` (tables with a smaller hotness are
padded with zero-coefficient slots on their base row), so one fixed-hotness
lookup returns ``[batch * T, width]``, each (sample, table) pooled row.
Under SUM with one hotness no coefficients are passed, so K1 sums each bag
as the per-table lookup does, bit for bit; MEAN folds ``1/H_t`` into the
coefficients, so there each position is scaled before the sum instead of
the sum after it (a rounding difference where ``1/H_t`` is inexact).

The sharded mirrors (``fused_sharded_*``) run the group on a row-sharded
fused table over the parallel layer (:mod:`cuembed_tpu_torch.parallel`):
one all-to-all routed lookup and one routed update for the whole group, each
rank on its block of the batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cuembed_tpu_torch.ops.api import embedding_lookup
from cuembed_tpu_torch.ops.tiered import TieredConfig
from cuembed_tpu_torch.train import rowwise_adagrad_sparse_update, sgd_sparse_update
from cuembed_tpu_torch.types import CombineMode


@dataclass(frozen=True)
class FusedSpec:
    """Static layout of a fused table group."""

    names: Tuple[str, ...]
    bases: Tuple[int, ...]          # row offset of each table
    sizes: Tuple[int, ...]          # rows of each table
    hotness: Tuple[int, ...]        # fixed hotness of each table
    width: int
    total_rows: int

    @classmethod
    def from_sizes(
        cls, names: Sequence[str], sizes: Sequence[int], hotness: Sequence[int],
        width: int,
    ) -> "FusedSpec":
        """The layout of tables of ``sizes`` rows stacked in ``names``
        order, each based at the sum of the sizes before it."""
        sizes = tuple(int(s) for s in sizes)
        bases = tuple(int(b) for b in np.concatenate([[0], np.cumsum(sizes)[:-1]]))
        return cls(tuple(names), bases, sizes, tuple(int(h) for h in hotness),
                   int(width), int(sum(sizes)))

    def base_of(self, name: str) -> int:
        return self.bases[self.names.index(name)]


def fuse_tables(
    tables: Dict[str, torch.Tensor],
    hotness: Dict[str, int],
    names: Optional[Sequence[str]] = None,
) -> Tuple[torch.Tensor, FusedSpec]:
    """Stack same-(width, dtype) tables row-wise into one fused table.

    Returns ``(fused [sum(V_t), W], spec)``. Order follows ``names``
    (default: dict order); keep it stable across training steps, the bases
    are baked into the spec.
    """
    names = tuple(names or tables.keys())
    if not names:
        raise ValueError("nothing to fuse")
    width = tables[names[0]].shape[1]
    dtype = tables[names[0]].dtype
    for n in names:
        if tables[n].shape[1] != width or tables[n].dtype != dtype:
            raise ValueError(
                f"table {n!r} has (width, dtype) "
                f"({tables[n].shape[1]}, {tables[n].dtype}); fusion "
                f"requires ({width}, {dtype}) — group tables by shape"
            )
    fused = torch.cat([tables[n] for n in names], dim=0)
    spec = FusedSpec.from_sizes(names, [tables[n].shape[0] for n in names],
                                [hotness[n] for n in names], width)
    return fused, spec


def unfuse_table(fused: torch.Tensor, spec: FusedSpec) -> Dict[str, torch.Tensor]:
    """Slice the fused table back into its named parts (views)."""
    return {
        n: fused[b : b + s]
        for n, b, s in zip(spec.names, spec.bases, spec.sizes)
    }


def fuse_counts(
    spec: FusedSpec, counts: Dict[str, np.ndarray]
) -> np.ndarray:
    """Concatenate per-table frequency counts into fused-id space (feed it
    to ``utils.frequency.frequency_order`` for a fused reorder and remap)."""
    parts = []
    for n, s in zip(spec.names, spec.sizes):
        cnt = np.asarray(counts[n])[:s]
        if cnt.shape[0] < s:  # short counts (bincount without minlength)
            cnt = np.pad(cnt, (0, s - cnt.shape[0]))
        parts.append(cnt)
    return np.concatenate(parts)


def _fused_batch(
    spec: FusedSpec,
    indices: Dict[str, torch.Tensor],
    weights: Optional[Dict[str, torch.Tensor]],
    mode: CombineMode,
):
    """``[batch*T, H_max]`` fused ids and combine coefficients (None under
    SUM with one hotness and no weights), the batch and T.

    Slots past a table's hotness carry coefficient 0 and point at the
    table's base row (always a valid id). MEAN folds 1/H_t into the
    coefficients so the lookup itself runs as a weighted SUM.
    """
    if weights is not None and mode != CombineMode.SUM:
        raise ValueError("weights are only supported with CombineMode.SUM")
    T = len(spec.names)
    hmax = max(spec.hotness)
    batch = indices[spec.names[0]].shape[0]
    device = indices[spec.names[0]].device
    idx_parts, w_parts = [], []
    uniform = (
        weights is None
        and mode == CombineMode.SUM
        and all(h == hmax for h in spec.hotness)
    )
    for t, n in enumerate(spec.names):
        idx = indices[n]
        if tuple(idx.shape) != (batch, spec.hotness[t]):
            raise ValueError(
                f"{n}: expected indices [{batch}, {spec.hotness[t]}], "
                f"got {tuple(idx.shape)}"
            )
        idx = idx.to(torch.int64) + spec.bases[t]
        if idx.shape[1] < hmax:
            idx = torch.cat(
                [idx, idx.new_full((batch, hmax - idx.shape[1]), spec.bases[t])], dim=1)
        idx_parts.append(idx)
        if not uniform:
            w = (
                weights[n].to(torch.float32)
                if weights is not None and weights.get(n) is not None
                else torch.ones((batch, spec.hotness[t]), dtype=torch.float32,
                                device=device)
            )
            if mode == CombineMode.MEAN:
                w = w / max(spec.hotness[t], 1)
            if w.shape[1] < hmax:
                w = torch.cat([w, w.new_zeros((batch, hmax - w.shape[1]))], dim=1)
            w_parts.append(w)
    # [batch, T, hmax] -> [batch*T, hmax]: sample-major so out[:, t] slices
    big_idx = torch.stack(idx_parts, dim=1).reshape(batch * T, hmax)
    big_w = (
        None
        if uniform
        else torch.stack(w_parts, dim=1).reshape(batch * T, hmax)
    )
    return big_idx, big_w, batch, T


def _remapped(big_idx, remap):
    if remap is None:
        return big_idx
    remap = torch.as_tensor(remap, device=big_idx.device)
    return remap.index_select(0, big_idx.reshape(-1)).view(big_idx.shape)


def fused_lookup(
    fused: torch.Tensor,
    spec: FusedSpec,
    indices: Dict[str, torch.Tensor],
    weights: Optional[Dict[str, torch.Tensor]] = None,
    *,
    mode: CombineMode = CombineMode.SUM,
    remap: Optional[torch.Tensor] = None,
    backend: str = "auto",
    tiered_cfg: Optional[TieredConfig] = None,
    low_precision_math: bool = False,
) -> Dict[str, torch.Tensor]:
    """Pooled lookup of every table in the group: ONE lookup, differentiable
    with respect to ``fused``.

    ``remap``: fused-id remap (``frequency_order(fuse_counts(...))``) when
    ``fused`` is stored frequency-ordered; applied on the device to the
    offset ids. ``mode`` applies per table (SUM or MEAN; CONCAT has no
    pooled shape).
    """
    if mode == CombineMode.CONCAT:
        raise ValueError("fusion pools per (sample, table); CONCAT keeps "
                         "per-row outputs — look those tables up unfused")
    big_idx, big_w, batch, T = _fused_batch(spec, indices, weights, mode)
    big_idx = _remapped(big_idx, remap)
    out = embedding_lookup(
        fused, big_idx, big_w, mode=CombineMode.SUM if big_w is not None
        else mode, backend=backend, tiered_cfg=tiered_cfg,
        low_precision_math=low_precision_math,
    )
    out = out.view(batch, T, spec.width)
    return {n: out[:, t] for t, n in enumerate(spec.names)}


def _fused_grad_batch(spec, indices, grads_y, weights, mode, remap):
    big_idx, big_w, batch, T = _fused_batch(spec, indices, weights, mode)
    big_idx = _remapped(big_idx, remap)
    big_gy = torch.stack(
        [grads_y[n] for n in spec.names], dim=1
    ).reshape(batch * T, spec.width)
    return big_idx, big_w, big_gy


def fused_sgd_update(
    fused: torch.Tensor,
    spec: FusedSpec,
    indices: Dict[str, torch.Tensor],
    grads_y: Dict[str, torch.Tensor],
    *,
    lr: float,
    weights: Optional[Dict[str, torch.Tensor]] = None,
    mode: CombineMode = CombineMode.SUM,
    remap: Optional[torch.Tensor] = None,
    tiered_cfg: Optional[TieredConfig] = None,
) -> torch.Tensor:
    """Sparse SGD for the whole group: ONE sorted update, in place."""
    big_idx, big_w, big_gy = _fused_grad_batch(
        spec, indices, grads_y, weights, mode, remap
    )
    return sgd_sparse_update(
        fused, big_idx, big_gy, lr=lr, weights=big_w,
        mode=CombineMode.SUM if big_w is not None else mode,
        tiered_cfg=tiered_cfg,
    )


def fused_adagrad_update(
    fused: torch.Tensor,
    accum: torch.Tensor,
    spec: FusedSpec,
    indices: Dict[str, torch.Tensor],
    grads_y: Dict[str, torch.Tensor],
    *,
    lr: float,
    eps: float = 1e-8,
    weights: Optional[Dict[str, torch.Tensor]] = None,
    mode: CombineMode = CombineMode.SUM,
    remap: Optional[torch.Tensor] = None,
    tiered_cfg: Optional[TieredConfig] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise AdaGrad for the whole group: ONE state update, in place."""
    big_idx, big_w, big_gy = _fused_grad_batch(
        spec, indices, grads_y, weights, mode, remap
    )
    return rowwise_adagrad_sparse_update(
        fused, accum, big_idx, big_gy, lr=lr, eps=eps, weights=big_w,
        mode=CombineMode.SUM if big_w is not None else mode,
        tiered_cfg=tiered_cfg,
    )


# ---------------------------------------------------------------------------
# Multi-device mirrors: the fused group on a row-sharded fused table
# ---------------------------------------------------------------------------


def fused_sharded_lookup(
    fused: torch.Tensor,
    spec: FusedSpec,
    indices: Dict[str, torch.Tensor],
    weights: Optional[Dict[str, torch.Tensor]] = None,
    *,
    mesh,
    mode: CombineMode = CombineMode.SUM,
    remap: Optional[torch.Tensor] = None,
    capacity_factor: float = 2.0,
    axis: str = "model",
    compress: str = "none",
) -> Dict[str, torch.Tensor]:
    """Routed pooled lookup of the whole group: ONE all-to-all lookup.

    The multi-device mirror of :func:`fused_lookup`. ``fused`` is this
    rank's row block of the fused table (spec ``(axis, None)``; pad its rows
    with :func:`~cuembed_tpu_torch.parallel.pad_table_for_shards`);
    ``indices``/``weights`` hold this rank's ``[batch / n, H_t]`` block of
    each table's batch (spec ``(axis, None)``), whose stacked ``[batch / n
    * T, H_max]`` group batch is the rank's block of the global one, so one
    :func:`~cuembed_tpu_torch.parallel.alltoall_row_sharded_lookup` serves
    the group. Returns each table's ``[batch / n, W]`` block.
    """
    if mode == CombineMode.CONCAT:
        raise ValueError("fusion pools per (sample, table); CONCAT keeps "
                         "per-row outputs — look those tables up unfused")
    from cuembed_tpu_torch.parallel.alltoall_lookup import alltoall_row_sharded_lookup

    big_idx, big_w, batch, T = _fused_batch(spec, indices, weights, mode)
    big_idx = _remapped(big_idx, remap)
    out = alltoall_row_sharded_lookup(
        fused, big_idx, big_w, None, mesh=mesh,
        mode=CombineMode.SUM if big_w is not None else mode,
        capacity_factor=capacity_factor, axis=axis, compress=compress,
    )
    out = out.view(batch, T, spec.width)
    return {n: out[:, t] for t, n in enumerate(spec.names)}


def fused_sharded_sgd_update(
    fused: torch.Tensor,
    spec: FusedSpec,
    indices: Dict[str, torch.Tensor],
    grads_y: Dict[str, torch.Tensor],
    *,
    mesh,
    lr: float,
    weights: Optional[Dict[str, torch.Tensor]] = None,
    mode: CombineMode = CombineMode.SUM,
    remap: Optional[torch.Tensor] = None,
    capacity_factor: float = 2.0,
    axis: str = "model",
) -> torch.Tensor:
    """Sparse SGD for the whole group: ONE routed update, in place on this
    rank's block of the fused table."""
    from cuembed_tpu_torch.parallel.train import sharded_sgd_sparse_update

    big_idx, big_w, big_gy = _fused_grad_batch(spec, indices, grads_y, weights, mode,
                                               remap)
    return sharded_sgd_sparse_update(
        fused, big_idx, big_gy, mesh=mesh, lr=lr, weights=big_w,
        mode=CombineMode.SUM if big_w is not None else mode,
        capacity_factor=capacity_factor, axis=axis,
    )


def fused_sharded_adagrad_update(
    fused: torch.Tensor,
    accum: torch.Tensor,
    spec: FusedSpec,
    indices: Dict[str, torch.Tensor],
    grads_y: Dict[str, torch.Tensor],
    *,
    mesh,
    lr: float,
    eps: float = 1e-8,
    weights: Optional[Dict[str, torch.Tensor]] = None,
    mode: CombineMode = CombineMode.SUM,
    remap: Optional[torch.Tensor] = None,
    capacity_factor: float = 2.0,
    axis: str = "model",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise AdaGrad for the whole group: ONE routed state update, in
    place. ``accum`` is this rank's block of the accumulator, row-aligned
    with the (padded) fused table (spec ``(axis,)``)."""
    from cuembed_tpu_torch.parallel.train import sharded_rowwise_adagrad_sparse_update

    big_idx, big_w, big_gy = _fused_grad_batch(spec, indices, grads_y, weights, mode,
                                               remap)
    return sharded_rowwise_adagrad_sparse_update(
        fused, accum, big_idx, big_gy, mesh=mesh, lr=lr, eps=eps, weights=big_w,
        mode=CombineMode.SUM if big_w is not None else mode,
        capacity_factor=capacity_factor, axis=axis,
    )
