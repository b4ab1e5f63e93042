"""All-to-all routed lookup against a row-sharded table, the counterpart of
``cuembed_tpu/parallel/alltoall_lookup.py``.

1. **Bucket**: each rank owns a contiguous row range (``rows_per`` =
   ``num_categories / n``) and a slice of the batch. Its lookup indices are
   bucketed by owner into a dest-major ``[n, cap]`` request block (one
   stable sort by owner and a gather, no scatter).
2. **Route**: one ``all_to_all_single`` exchanges the request blocks.
3. **Serve**: each rank gathers the requested rows from its table block
   (``index_select``).
4. **Return**: a second ``all_to_all_single`` ships the ``[n * cap,
   width]`` responses back to the requesters.
5. **Combine**: every position knows its (owner, slot) coordinate, so the
   response buffer is a table and the combine ``sum_p coeff[p] *
   resp[slot_of_pos[p]]`` is a lookup on it: K1 for fixed hotness, K2 for a
   sharded-CSR block, in position order.

Communication per rank: ``cap * n`` ids out and the same back, and ``cap *
n * width`` payload elements: proportional to the lookups routed, where
:func:`~cuembed_tpu_torch.parallel.row_sharded_lookup` repeats the whole
batch's lookup on every rank.

Capacity: ``cap`` is a static per-destination slot count. A batch that
overflows any rank's bucket is routed again at full capacity (exact); the
overflow flag is made global and read on the host once, by every rank,
before any rank routes.

Differentiable: the combine's backward is K3 (the lookup's own), the
all-to-alls transpose to themselves and the owner's gather to a scatter-add,
so a table block gets the block of the single-device gradient that it owns.
``compress="int8"`` is forward only.

Every tensor argument is the calling rank's block under the JAX function's
``in_specs`` and the result is its block under ``out_specs``; each docstring
names them. With a ``(data, model)`` mesh the blocks along ``data`` are
replicas that route independently.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from cuembed_tpu_torch.ops.api import embedding_lookup, embedding_lookup_csr
from cuembed_tpu_torch.ops.quant import dequantize_rows, quantize_rows, serving_only_guard
from cuembed_tpu_torch.ops.transforms import extract_row_ids_from_csr
from cuembed_tpu_torch.parallel.collectives import all_gather, all_to_all, any_across, replicated
from cuembed_tpu_torch.parallel.sharding import (
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_size,
    pad_table_for_shards,
)
from cuembed_tpu_torch.types import CombineMode


def _coeff_and_samples(idx_l, offs_l, w_l, mode, nnz_l, hotness):
    """Per-position ids and combine coefficients, fixed or sharded-CSR.

    Returns ``(flat, coeff, offs1, b_l)``: ``coeff`` is None for an
    unweighted fixed SUM (every coefficient one); ``offs1`` is the flat
    ``[b_l + 1]`` offsets for sharded CSR, else None. CSR dead slots point
    at row 0 with coefficient 0 (they never route and never contribute).
    """
    if offs_l is not None:
        offs1 = offs_l.reshape(-1)
        b_l = offs1.shape[0] - 1
        flat_raw = idx_l.reshape(-1)
        live = torch.arange(nnz_l, device=flat_raw.device) < offs1[-1]
        flat = torch.where(live, flat_raw, torch.zeros_like(flat_raw))
        coeff = live.to(torch.float32)
        if w_l is not None:
            coeff = coeff * w_l.reshape(-1).to(torch.float32)
        if mode == CombineMode.MEAN:
            counts = (offs1[1:] - offs1[:-1]).to(torch.float32)
            inv = torch.where(counts == 0, torch.zeros_like(counts),
                              1.0 / counts.clamp(min=1.0))
            coeff = coeff * inv[extract_row_ids_from_csr(offs1, flat).long()]
        return flat, coeff, offs1, b_l
    b_l = idx_l.shape[0]
    flat = idx_l.reshape(-1)
    coeff = None if w_l is None else w_l.reshape(-1).to(torch.float32)
    if mode == CombineMode.MEAN:
        if coeff is None:
            coeff = torch.ones(nnz_l, dtype=torch.float32, device=flat.device)
        coeff = coeff / hotness
    return flat, coeff, None, b_l


def _owner_buckets(owner, nnz_l, n, cap):
    """Dest-major slot assignment for the request all-to-all.

    ``owner`` may carry ``n`` for positions that must not route (hybrid
    head hits); they sort last and never land in a slot or a count.
    Returns ``(pos_s, counts, starts, rank, overflow)``: positions sorted
    by owner, per-owner counts and run starts, each position's rank within
    its owner run, and the static-capacity overflow flag (a device bool).
    """
    owner_s, pos_s = torch.sort(owner, stable=True)
    counts = torch.bincount(owner, minlength=n + 1)[:n]
    starts = torch.cumsum(counts, 0) - counts
    overflow = (counts > cap).any()
    rank_s = torch.arange(nnz_l, device=owner.device) - starts[owner_s.clamp(0, n - 1)]
    rank = torch.empty_like(rank_s)
    rank[pos_s] = rank_s
    return pos_s, counts, starts, rank, overflow


def _route_serve(table_l, send_vals, pos_s, counts, starts, nnz_l, n, c, rows_per,
                 shard, group, compress):
    """One request/response round trip: ship each destination's slot block
    of row ids, gather the rows from the owner's block, and return the
    responses dest-major (``[n*c, width]``; position ``p``'s row sits at
    ``owner[p]*c + rank[p]``)."""
    device = send_vals.device
    ar = torch.arange(c, device=device)
    slot_src = starts[:, None] + ar[None, :]
    slot_live = ar[None, :] < counts[:, None]
    slot_pos = pos_s[slot_src.clamp(0, nnz_l - 1)]
    send_idx = torch.where(slot_live, send_vals[slot_pos].long(),
                           torch.full_like(slot_pos, -1))
    recv_idx = all_to_all(send_idx.reshape(-1), group)  # what each peer asked of me
    local_rows = (recv_idx - shard * rows_per).clamp(0, rows_per - 1)
    served = table_l.index_select(0, local_rows)
    served = torch.where((recv_idx >= 0)[:, None], served, torch.zeros_like(served))
    width = table_l.shape[1]
    if compress == "int8":
        q = quantize_rows(serving_only_guard(served), pad=4)
        return dequantize_rows(all_to_all(q, group), width)
    return all_to_all(served, group)


def _check_compress(compress):
    if compress not in ("none", "int8"):
        raise ValueError("compress must be 'none' or 'int8'")


def _local_nnz(indices, offsets):
    """``(nnz_l, hotness)`` of this rank's block (hotness None for CSR)."""
    if offsets is not None:
        if indices.dim() != 2 or indices.shape[0] != 1:
            raise ValueError(
                "sharded CSR wants indices [n_shards, cap]; see shard_csr")
        return indices.shape[1], None
    batch_l, hotness = indices.shape
    return batch_l * hotness, hotness


def _combine(resp, slot_of_pos, coeff, offs1, b_l, hotness, mode):
    """The receiver's combine over the response buffer: K1 (fixed hotness)
    or K2 (sharded CSR) with ``resp`` as the table, in position order."""
    if mode == CombineMode.CONCAT:
        return embedding_lookup(resp, slot_of_pos.view(-1, 1), mode=CombineMode.CONCAT)
    if offs1 is not None:
        out = embedding_lookup_csr(resp, slot_of_pos, offs1, coeff)
        return out[None]  # [1, local_batch, W] (sharded-CSR block)
    ids = slot_of_pos.view(b_l, hotness)
    return embedding_lookup(resp, ids, None if coeff is None else coeff.view(b_l, hotness))


def _routed(table_l, flat, owner, nnz_l, n, cap, rows_per, shard, group, compress,
            combine):
    """Bucket, check capacity on every rank, route at ``cap`` (or at full
    capacity after an overflow anywhere) and combine."""
    pos_s, counts, starts, rank, overflow = _owner_buckets(owner, nnz_l, n, cap)
    c = nnz_l if cap >= nnz_l or any_across(overflow, group) else cap
    resp = _route_serve(table_l, flat, pos_s, counts, starts, nnz_l, n, c, rows_per,
                        shard, group, compress)
    slot_of_pos = owner.clamp(0, n - 1) * c + rank.clamp(0, c - 1)
    return combine(resp, slot_of_pos)


def hybrid_tiered_lookup(
    head_table: torch.Tensor,
    tail_table: torch.Tensor,
    indices: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    *,
    mesh: DeviceMesh,
    mode: CombineMode = CombineMode.SUM,
    capacity_factor: float = 2.0,
    cold_frac: float = 1.0,
    axis: str = MODEL_AXIS,
    compress: str = "none",
) -> torch.Tensor:
    """Replicated-hot-head plus all-to-all-routed-cold-tail lookup.

    With a frequency-ordered table, rows ``[0, hot)`` (the head that serves
    the bulk of power-law traffic) are replicated on every rank, so most
    lookups are served locally with no communication; only the cold tail is
    row-sharded and routed all-to-all. Against full routing, the payload
    and the owner's gathers shrink by the head-traffic fraction. Each part
    is one lookup on the card: the head's is K1 (K2 for CSR) on the head
    with the tail positions at coefficient 0, the tail's is the routed
    combine. Each part's fp32 sum rounds to the table's dtype before the
    two are added in fp32 (for an fp32 table, the JAX function's sums).

    ``compress="int8"`` quantizes the routed response rows to per-row
    symmetric int8 with an inline fp32 scale (the payload shrinks by
    ``4W / (W + 4)`` for an fp32 table); elementwise error at most
    ``max|row| / 254`` on routed rows, the head stays exact. Forward only.

    Args:
      head_table: ``[hot, W]``, replicated on every rank (spec ``(None,
        None)``).
      tail_table: this rank's ``[V_tail / n, W]`` block of rows ``hot..``
        (spec ``(axis, None)``; pad ``V_tail`` with
        :func:`pad_table_for_shards`).
      indices: ``[batch / n, hotness]`` remapped global row ids (spec
        ``(axis, None)``); with ``offsets``, a sharded-CSR ``[1, cap]``
        block (see :func:`shard_csr`).
      weights: optional, like indices (SUM only).
      offsets: optional sharded-CSR ``[1, local_batch + 1]`` block; entries
        of the block at or past ``offsets[-1]`` are padding.
      capacity_factor: per-destination slots as a multiple of the balanced
        cold share ``cold_frac * nnz_local / n``.
      cold_frac: calibrated fraction of lookups past the head (sizes the
        capacity only; an overflow routes again at full capacity).

    Returns:
      ``[batch / n, W]`` pooled (spec ``(axis, None)``), ``[1, local_batch,
      W]`` for sharded CSR. Differentiable in both parts (the head's
      gradient summed over the axis).
    """
    if mode == CombineMode.CONCAT:
        raise ValueError("hybrid routing pools rows; CONCAT unsupported")
    if weights is not None and mode != CombineMode.SUM:
        raise ValueError("weights are only supported with CombineMode.SUM")
    _check_compress(compress)
    n = axis_size(mesh, axis)
    group = axis_group(mesh, axis)
    hot, width = head_table.shape
    rows_per = tail_table.shape[0]
    nnz_l, hotness = _local_nnz(indices, offsets)
    cap = int(nnz_l / n * min(max(cold_frac, 1e-3), 1.0) * capacity_factor)
    cap = min(max(-(-cap // 8) * 8, 8), nnz_l)

    flat, coeff, offs1, b_l = _coeff_and_samples(indices, offsets, weights, mode,
                                                 nnz_l, hotness)
    if coeff is None:
        coeff = torch.ones(nnz_l, dtype=torch.float32, device=flat.device)
    is_hot = flat < hot
    zero = torch.zeros_like(coeff)

    def pooled(table, ids, c):
        if offs1 is not None:
            return embedding_lookup_csr(table, ids, offs1, c)
        return embedding_lookup(table, ids.view(b_l, hotness), c.view(b_l, hotness))

    # The head: a local pooled lookup, no communication. It is replicated
    # while the result is sharded over the axis: its gradient sums there.
    head = replicated(head_table, group)
    out = pooled(head, torch.where(is_hot, flat, torch.zeros_like(flat)),
                 torch.where(is_hot, coeff, zero)).to(torch.float32)

    # The cold tail: head positions get an out-of-range owner, so they never
    # take a routing slot.
    tail_idx = flat - hot
    owner = torch.where(is_hot, torch.full_like(flat, n),
                        (tail_idx // rows_per).clamp(0, n - 1)).long()
    cold_coeff = torch.where(is_hot, zero, coeff)
    cold = _routed(tail_table, tail_idx, owner, nnz_l, n, cap, rows_per,
                   axis_index(mesh, axis), group, compress,
                   lambda resp, slot: pooled(resp, slot, cold_coeff))
    total = (out + cold.to(torch.float32)).to(head_table.dtype)
    # sharded-CSR block convention: [1, local_batch, W] per rank
    return total[None] if offs1 is not None else total


def split_hybrid_table(table, hot: int, n_shards: int):
    """Split a frequency-ordered table into (head, padded tail) parts.

    Host-side layout for :func:`hybrid_tiered_lookup`: every rank keeps the
    head, and its ``(axis, None)`` block of the tail (:func:`local_block`).
    """
    head = table[:hot]
    tail = pad_table_for_shards(table[hot:], n_shards)
    return head, tail


def alltoall_row_sharded_lookup(
    table: torch.Tensor,
    indices: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    *,
    mesh: DeviceMesh,
    mode: CombineMode = CombineMode.SUM,
    capacity_factor: float = 2.0,
    axis: str = MODEL_AXIS,
    compress: str = "none",
) -> torch.Tensor:
    """Pooled lookup with all-to-all index routing.

    ``compress="int8"`` quantizes the response rows (see
    :func:`hybrid_tiered_lookup`: the same scheme, error bound and
    forward-only use).

    Args:
      table: this rank's ``[num_categories / n, width]`` row block (spec
        ``(axis, None)``).
      indices: ``[batch / n, hotness]`` global category ids (spec ``(axis,
        None)``: the batch and the table share the axis); with ``offsets``,
        a sharded-CSR ``[1, cap]`` block (see :func:`shard_csr`).
      weights: optional, like ``indices`` (SUM only).
      offsets: optional sharded-CSR ``[1, local_batch + 1]`` block; entries
        at or past ``offsets[-1]`` are padding.
      mode: SUM / MEAN / CONCAT (CONCAT is fixed-hotness and unweighted; the
        result is the per-position rows ``[batch / n * hotness, width]``).
      capacity_factor: per-destination slots as a multiple of the balanced
        share ``nnz_local / n``.

    Returns:
      ``[batch / n, width]`` pooled (spec ``(axis, None)``); ``[1,
      local_batch, width]`` for sharded CSR.
    """
    if mode == CombineMode.CONCAT and (offsets is not None or weights is not None):
        raise ValueError("CONCAT is fixed-hotness and unweighted")
    _check_compress(compress)
    n = axis_size(mesh, axis)
    rows_per = table.shape[0]
    nnz_l, hotness = _local_nnz(indices, offsets)
    cap = int(nnz_l / n * capacity_factor) + 1
    cap = min(-(-cap // 8) * 8, nnz_l)

    flat, coeff, offs1, b_l = _coeff_and_samples(indices, offsets, weights, mode,
                                                 nnz_l, hotness)
    owner = (flat // rows_per).clamp(0, n - 1).long()
    out = _routed(table, flat, owner, nnz_l, n, cap, rows_per, axis_index(mesh, axis),
                  axis_group(mesh, axis), compress,
                  lambda resp, slot: _combine(resp, slot, coeff, offs1, b_l, hotness,
                                              mode))
    return out.to(table.dtype)


def grid_sharded_lookup(
    table: torch.Tensor,
    indices: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    *,
    mesh: DeviceMesh,
    mode: CombineMode = CombineMode.SUM,
    capacity_factor: float = 2.0,
    row_axis: str = MODEL_AXIS,
    col_axis: str = "data",
    gather_output: bool = True,
    compress: str = "none",
) -> torch.Tensor:
    """Pooled lookup against a grid-sharded table (spec ``(row_axis,
    col_axis)``): every rank holds a ``[V / n_r, W / n_c]`` block. Ids route
    all-to-all over the row axis as in :func:`alltoall_row_sharded_lookup`,
    independently within each column group, each of which serves its own
    width slice.

    Args:
      table: this rank's ``[V / n_r, W / n_c]`` block.
      indices: ``[batch / n_r, hotness]`` (spec ``(row_axis, None)``,
        replicated over the column axis); with ``offsets``, a sharded-CSR
        ``[1, cap]`` block over the row axis.
      weights: like indices (SUM only).
      offsets: optional sharded-CSR ``[1, local_batch + 1]`` block.
      gather_output: all-gather the feature slices back to ``(row_axis,
        None)``; False keeps the ``(row_axis, col_axis)`` block.
      compress: ``"int8"`` quantizes the routed responses (forward only).

    Returns:
      ``[batch / n_r, W]`` pooled (or the ``W / n_c`` slice);
      ``[1, local_batch, ...]`` for sharded CSR.
    """
    if mode == CombineMode.CONCAT:
        raise ValueError("grid routing pools rows; CONCAT unsupported")
    if weights is not None and mode != CombineMode.SUM:
        raise ValueError("weights are only supported with CombineMode.SUM")
    _check_compress(compress)
    n_r = axis_size(mesh, row_axis)
    rows_per = table.shape[0]
    nnz_l, hotness = _local_nnz(indices, offsets)
    cap = int(nnz_l / n_r * capacity_factor) + 1
    cap = min(-(-cap // 8) * 8, nnz_l)

    flat, coeff, offs1, b_l = _coeff_and_samples(indices, offsets, weights, mode,
                                                 nnz_l, hotness)
    col_group = axis_group(mesh, col_axis)
    if weights is not None:
        # Each column group's result holds its width slice's terms only.
        coeff = replicated(coeff, col_group)
    owner = (flat // rows_per).clamp(0, n_r - 1).long()
    out = _routed(table, flat, owner, nnz_l, n_r, cap, rows_per,
                  axis_index(mesh, row_axis), axis_group(mesh, row_axis), compress,
                  lambda resp, slot: _combine(resp, slot, coeff, offs1, b_l, hotness,
                                              mode))
    out = out.to(table.dtype)
    if gather_output:
        out = all_gather(out, col_group, dim=out.dim() - 1)
    return out
