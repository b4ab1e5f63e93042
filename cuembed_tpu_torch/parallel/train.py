"""Sparse optimizer updates for sharded embedding tables, the counterpart of
``cuembed_tpu/parallel/train.py``.

The forward is served by
:func:`~cuembed_tpu_torch.parallel.alltoall_row_sharded_lookup` (or the
hybrid head/tail layout); the update travels the same wire the other way:
(row id, gradient row) pairs go over ``all_to_all_single`` to the rank that
OWNS the row, which sums them per unique row on K3 (compressed mode, a
deterministic sorted sum with no atomics) and applies one update a row.
Neither a dense ``[V, W]`` gradient nor a dense per-rank ``[V/n, W]``
gradient is ever made: the routed payload is ``O(nnz * W / n)`` a rank,
like the forward's responses.

Layouts match the router: the table row-sharded (spec ``(axis, None)``),
the batch data-sharded over the same axis, optimizer state sharded with the
table (row-wise AdaGrad: ``(axis,)``). Every tensor argument is the calling
rank's block under the JAX function's ``in_specs``; the blocks are updated
in place and returned, as the single-table updates of
:mod:`cuembed_tpu_torch.train` are.

Capacity: a static per-destination slot count, ``capacity_factor`` times
the balanced share; a batch that overflows any rank's bucket is routed at
full capacity (exact). The overflow flag is made global and read on the
host once, by every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from cuembed_tpu_torch.ops import dispatch
from cuembed_tpu_torch.ops.head import head_grad
from cuembed_tpu_torch.ops.lookup_torch import SENTINEL
from cuembed_tpu_torch.parallel.alltoall_lookup import _local_nnz
from cuembed_tpu_torch.parallel.collectives import all_gather, all_to_all, any_across
from cuembed_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_size,
)
from cuembed_tpu_torch.train import _flatten_coo, sgd_sparse_update
from cuembed_tpu_torch.types import CombineMode

def _bucket(flat, valid, n, rows_per):
    """Owner bucketing, computed once per update (shared by the capacity
    check and the routing).

    Returns ``(pos_s, counts, starts)``: positions sorted by owner rank,
    per-owner counts, and each owner's run start. Invalid positions
    (hybrid head hits, CSR padding) get owner ``n``: they sort last and
    never land in a slot or a count.
    """
    owner = (flat // rows_per).clamp(0, n - 1).long()
    if valid is not None:
        owner = torch.where(valid, owner, torch.full_like(owner, n))
    pos_s = torch.sort(owner, stable=True).indices
    counts = torch.bincount(owner, minlength=n + 1)[:n]
    starts = torch.cumsum(counts, 0) - counts
    return pos_s, counts, starts


def _route_grad_rows(flat, sample_ids, gy_l, coeff, n, rows_per, cap, shard, group,
                     bucket):
    """Exchange per-position gradient rows with the owner ranks.

    ``flat [nnz_l]`` is in ROUTED row space (global for the plain layout,
    tail space for hybrid); ``sample_ids [nnz_l]`` maps each position to
    its ``gy_l`` row; ``bucket`` is :func:`_bucket`'s result.
    Returns ``(local_rows [n*cap], grad_rows [n*cap, W])``: the update
    stream addressed to this rank's table block (local row space), dead
    slots marked with ``SENTINEL`` rows and zero gradient.
    """
    nnz_l = flat.shape[0]
    pos_s, counts, starts = bucket
    ar = torch.arange(cap, device=flat.device)
    slot_src = starts[:, None] + ar[None, :]
    slot_live = (ar[None, :] < counts[:, None]).reshape(-1)
    slot_pos = pos_s[slot_src.clamp(0, nnz_l - 1)].reshape(-1)
    send_idx = torch.where(slot_live, flat[slot_pos].long(),
                           torch.full_like(slot_pos, -1))

    # Per-slot gradient row: coeff_p * grad_y[sample_p] (the position's
    # exact dense-gradient contribution).
    g = gy_l.index_select(0, sample_ids[slot_pos].long()).to(torch.float32)
    if coeff is not None:
        g = g * coeff[slot_pos][:, None]
    g = torch.where(slot_live[:, None], g, torch.zeros_like(g))

    recv_idx = all_to_all(send_idx, group)
    recv_g = all_to_all(g, group)
    local_rows = torch.where(recv_idx >= 0, recv_idx - shard * rows_per,
                             torch.full_like(recv_idx, SENTINEL))
    return local_rows, recv_g


def _prep_coo(idx_l, offs_l, w_l, mode, gy_l):
    """Per-position ``(flat_idx, sample_ids, coeff, gy, valid)``.

    The single-table COO flattening (:func:`cuembed_tpu_torch.train.
    _flatten_coo`): fixed hotness or a sharded-CSR block, weights / MEAN /
    CSR liveness folded into ``coeff`` (an unweighted MEAN's uniform
    coefficient folds into ``gy``). ``valid`` masks zero-coefficient
    positions (CSR padding, zero weights) out of the routing slots.
    """
    gy = gy_l.to(torch.float32)
    if offs_l is None:
        if w_l is None and mode == CombineMode.MEAN:
            gy = gy * (1.0 / idx_l.shape[1])
        flat, sids, coeff = _flatten_coo(idx_l, None, w_l, mode, torch.float32)
    else:
        flat, sids, coeff = _flatten_coo(
            idx_l.reshape(-1), offs_l.reshape(-1),
            None if w_l is None else w_l.reshape(-1), mode, torch.float32)
    valid = None if coeff is None else (coeff != 0)
    return flat, sids, coeff, gy, valid


def _compressed_local(local_rows, grad_rows, num_rows):
    """Per-unique-row sums of the routed update stream on K3 (compressed):
    ``(rows, uniq)`` for the distinct in-range rows, ascending."""
    rows_s, order = torch.sort(local_rows, stable=True)
    cg = dispatch.backward_compressed(grad_rows.contiguous(), rows_s, order, None)
    nu = min(int(cg.num_unique), cg.rows.shape[0])
    rows, uniq = cg.rows[:nu], cg.unique_indices[:nu]
    keep = (uniq >= 0) & (uniq < num_rows)  # the sentinel run updates nothing
    return rows[keep], uniq[keep].long()


def _overflowed(counts, cap, group):
    """Collective-safe overflow predicate on :func:`_bucket`'s counts."""
    return any_across((counts > cap).any(), group)


def _check_update(mode, weights):
    if mode == CombineMode.CONCAT:
        raise ValueError("routed updates pool rows; CONCAT unsupported")
    if weights is not None and mode != CombineMode.SUM:
        raise ValueError("weights are only supported with CombineMode.SUM")


def _update_shapes(table, indices, offsets, n, capacity_factor):
    """Validation and capacity sizing for the routed updates: ``(rows_per,
    width, nnz_l, cap)``."""
    nnz_l = _local_nnz(indices, offsets)[0]
    cap = int(nnz_l / n * capacity_factor) + 1
    cap = min(-(-cap // 8) * 8, nnz_l)
    return table.shape[0], table.shape[1], nnz_l, cap


def _grid_cap(nnz_l, n_r, capacity_factor):
    """Per-destination slot count for the grid-sharded updates: one formula
    for SGD and AdaGrad, so the overflow threshold cannot drift between
    them."""
    cap = int(nnz_l / n_r * capacity_factor) + 1
    return max(min(-(-cap // 8) * 8, nnz_l), 8)


def _capacity(bucket, cap, nnz_l, group):
    """The slots to route with: ``cap``, or ``nnz_l`` (which no batch can
    overflow) when any rank of the group overflows ``cap``."""
    if cap >= nnz_l or _overflowed(bucket[1], cap, group):
        return nnz_l
    return cap


def _routed_sums(flat, sids, gy, coeff, valid, n, rows_per, cap, nnz_l, shard, group):
    """Route this rank's gradient rows to their owners and sum what this
    rank receives per row: ``(rows, uniq)`` in local row space."""
    bucket = _bucket(flat, valid, n, rows_per)
    c = _capacity(bucket, cap, nnz_l, group)
    local_rows, grad_rows = _route_grad_rows(flat, sids, gy, coeff, n, rows_per, c,
                                             shard, group, bucket)
    return _compressed_local(local_rows, grad_rows, rows_per)


def _sgd_apply(table_l, rows, uniq, lr):
    return table_l.index_add_(0, uniq, (-lr * rows).to(table_l.dtype))


def _compressed_adagrad_apply(table_l, accum_l, rows, uniq, lr, eps, g2=None):
    """Row-wise AdaGrad on compressed (unique-row, summed-gradient) rows,
    in place. ``g2`` overrides the per-row ``mean(G^2)`` statistic (the
    column and grid updates pass one summed over the column axis, so it
    spans the full row while each rank holds a width slice)."""
    if g2 is None:
        g2 = (rows * rows).mean(dim=1)
    new_acc = accum_l.index_select(0, uniq) + g2
    accum_l.index_copy_(0, uniq, new_acc)
    # The IEEE quotient of two tensors, as the single-device apply takes it
    # (``-lr / t`` would be ``t.reciprocal() * -lr``, two roundings).
    scale = torch.full_like(new_acc, -lr) / torch.sqrt(new_acc + eps)
    table_l.index_add_(0, uniq, (rows * scale[:, None]).to(table_l.dtype))
    return table_l, accum_l


@torch.no_grad()
def sharded_sgd_sparse_update(
    table: torch.Tensor,
    indices: torch.Tensor,
    grad_y: torch.Tensor,
    *,
    mesh: DeviceMesh,
    lr: float,
    offsets: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    mode: CombineMode = CombineMode.SUM,
    capacity_factor: float = 2.0,
    axis: str = MODEL_AXIS,
) -> torch.Tensor:
    """One sparse SGD step on a row-sharded table, in place.

    ``table - lr * dense_grad`` (up to fp reassociation) with the gradient
    routed to its owner: the update mirror of
    :func:`alltoall_row_sharded_lookup`.

    Args:
      table: this rank's ``[V / n, W]`` row block (spec ``(axis, None)``).
      indices: ``[batch / n, hotness]`` global ids (spec ``(axis, None)``);
        with ``offsets``, a sharded-CSR ``[1, cap]`` block.
      grad_y: the ``[batch / n, W]`` block of the pooled-output gradient.
      offsets: optional sharded-CSR ``[1, local_batch + 1]`` block.
      weights / mode: the forward's combine (SUM/MEAN; weighted SUM).
      capacity_factor: per-destination slots as a multiple of the balanced
        share; an overflow routes at full capacity (exact).

    Returns:
      ``table``, updated.
    """
    _check_update(mode, weights)
    n = axis_size(mesh, axis)
    rows_per, _, nnz_l, cap = _update_shapes(table, indices, offsets, n, capacity_factor)
    flat, sids, coeff, gy, valid = _prep_coo(indices, offsets, weights, mode, grad_y)
    rows, uniq = _routed_sums(flat, sids, gy, coeff, valid, n, rows_per, cap, nnz_l,
                              axis_index(mesh, axis), axis_group(mesh, axis))
    return _sgd_apply(table, rows, uniq, lr)


@torch.no_grad()
def sharded_rowwise_adagrad_sparse_update(
    table: torch.Tensor,
    accum: torch.Tensor,
    indices: torch.Tensor,
    grad_y: torch.Tensor,
    *,
    mesh: DeviceMesh,
    lr: float,
    eps: float = 1e-8,
    offsets: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    mode: CombineMode = CombineMode.SUM,
    capacity_factor: float = 2.0,
    axis: str = MODEL_AXIS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise AdaGrad on a row-sharded table and its co-sharded
    accumulator, in place.

    Per touched row r (with total gradient row G_r across ALL ranks'
    batches): ``accum[r] += mean(G_r^2)``;
    ``table[r] -= lr * G_r / sqrt(accum[r] + eps)``: the single-table
    :func:`cuembed_tpu_torch.train.rowwise_adagrad_sparse_update`, because
    the routing delivers every rank's terms to the owner BEFORE the per-row
    sum, so G_r is the global row gradient.

    ``accum``: this rank's ``[V / n]`` fp32 block (spec ``(axis,)``); the
    other arguments as :func:`sharded_sgd_sparse_update`. Returns
    ``(table, accum)``, updated.
    """
    _check_update(mode, weights)
    n = axis_size(mesh, axis)
    if accum.shape[0] != table.shape[0]:
        raise ValueError("accum must be row-aligned with the table")
    rows_per, _, nnz_l, cap = _update_shapes(table, indices, offsets, n, capacity_factor)
    flat, sids, coeff, gy, valid = _prep_coo(indices, offsets, weights, mode, grad_y)
    rows, uniq = _routed_sums(flat, sids, gy, coeff, valid, n, rows_per, cap, nnz_l,
                              axis_index(mesh, axis), axis_group(mesh, axis))
    return _compressed_adagrad_apply(table, accum, rows, uniq, lr, eps)


def _hybrid_shapes(head_table, tail_table, indices, offsets, weights, mode, n,
                   cold_frac, capacity_factor):
    """Validation and cap sizing shared by the hybrid updates:
    ``(hot, width, rows_per, nnz_l, cap)``."""
    _check_update(mode, weights)
    hot, width = head_table.shape
    rows_per = tail_table.shape[0]
    nnz_l = _local_nnz(indices, offsets)[0]
    cap = int(nnz_l / n * min(max(cold_frac, 1e-3), 1.0) * capacity_factor)
    cap = min(max(-(-cap // 8) * 8, 8), nnz_l)
    return hot, width, rows_per, nnz_l, cap


# Head-gradient algorithm switch: up to this many head rows the gradient is
# one product ``M^T @ grad_y`` (ops/head.py::head_grad, whose ``M`` is
# [batch, head]); past it the head positions' per-row sums (K3) written into
# [head, W] are cheaper than the [batch, head] matrix.
HEAD_GRAD_MXU_MAX_ROWS = 16384


def _hybrid_head_grad(idx_l, offs_l, flat, sids, coeff, gy, hot):
    """This rank's head-rows gradient for the hybrid updates, fixed or CSR
    (summed over the axis by the caller). Small heads: one product
    ``M^T @ grad_y`` (the position-major variant over the gathered
    per-sample gradient rows for sharded CSR); dead slots carry coefficient
    0 and positions off the head add nothing. Large heads: the head
    positions sorted by row and summed per row on K3 (compressed; positions
    off the head sort last as the sentinel run), written into ``[hot, W]``.
    Both are deterministic: a scatter-add by atomics would sum a row in
    another order on every rank, and the head's replicas along the data
    axis, which all-reduce over the model axis only, would drift apart."""
    if hot <= HEAD_GRAD_MXU_MAX_ROWS:
        if offs_l is None:
            coeff2d = None if coeff is None else coeff.reshape(idx_l.shape)
            return head_grad(idx_l, coeff2d, gy, hot, torch.float32)
        gy_rows = gy.index_select(0, sids.long())
        cpos = coeff if coeff is not None else torch.ones(
            flat.shape[0], dtype=torch.float32, device=flat.device)
        return head_grad(flat[:, None], cpos[:, None], gy_rows, hot, torch.float32)
    masked = torch.where(flat < hot, flat, torch.full_like(flat, SENTINEL))
    t_idx, t_sid, t_coeff = dispatch.transpose(masked, hot, sample_ids=sids, coeff=coeff)
    cg = dispatch.backward_compressed(gy.contiguous(), t_idx, t_sid, t_coeff)
    nu = min(int(cg.num_unique), cg.rows.shape[0])
    rows, uniq = cg.rows[:nu], cg.unique_indices[:nu]
    keep = (uniq >= 0) & (uniq < hot)
    out = torch.zeros((hot, gy.shape[1]), dtype=torch.float32, device=gy.device)
    return out.index_copy_(0, uniq[keep].long(), rows[keep])


def _hybrid_tail_sums(flat, sids, gy, coeff, pvalid, hot, n, rows_per, cap, nnz_l,
                      shard, group):
    is_cold = flat >= hot
    valid = is_cold if pvalid is None else (is_cold & pvalid)
    return _routed_sums(flat - hot, sids, gy, coeff, valid, n, rows_per, cap, nnz_l,
                        shard, group)


@torch.no_grad()
def sharded_hybrid_sgd_sparse_update(
    head_table: torch.Tensor,
    tail_table: torch.Tensor,
    indices: torch.Tensor,
    grad_y: torch.Tensor,
    *,
    mesh: DeviceMesh,
    lr: float,
    offsets: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    mode: CombineMode = CombineMode.SUM,
    capacity_factor: float = 2.0,
    cold_frac: float = 1.0,
    axis: str = MODEL_AXIS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse SGD on the hybrid layout: replicated head, routed tail.

    The update mirror of :func:`hybrid_tiered_lookup`. Head hits (row <
    ``hot``) never touch the wire: each rank computes its batch's head
    gradient (:func:`~cuembed_tpu_torch.ops.head.head_grad`, or K3's
    per-row sums for a large head), an all-reduce over the axis makes it the
    global head gradient, and the replicated head updates densely (zero
    rows update by zero: the row-sparse semantics). Only cold-tail (row,
    gradient row) pairs are routed to their owner.

    ``head_table`` ``[hot, W]`` is replicated; ``tail_table`` is this
    rank's ``[V_tail / n, W]`` block; the batch arguments as
    :func:`sharded_sgd_sparse_update`. Returns ``(head, tail)``, updated in
    place.
    """
    n = axis_size(mesh, axis)
    hot, _, rows_per, nnz_l, cap = _hybrid_shapes(
        head_table, tail_table, indices, offsets, weights, mode, n, cold_frac,
        capacity_factor)
    group = axis_group(mesh, axis)
    flat, sids, coeff, gy, pvalid = _prep_coo(indices, offsets, weights, mode, grad_y)
    hg = _hybrid_head_grad(indices, offsets, flat, sids, coeff, gy, hot)
    dist.all_reduce(hg, group=group)
    head_table.sub_((lr * hg).to(head_table.dtype))
    rows, uniq = _hybrid_tail_sums(flat, sids, gy, coeff, pvalid, hot, n, rows_per,
                                   cap, nnz_l, axis_index(mesh, axis), group)
    return head_table, _sgd_apply(tail_table, rows, uniq, lr)


@torch.no_grad()
def sharded_hybrid_rowwise_adagrad_sparse_update(
    head_table: torch.Tensor,
    tail_table: torch.Tensor,
    head_accum: torch.Tensor,
    tail_accum: torch.Tensor,
    indices: torch.Tensor,
    grad_y: torch.Tensor,
    *,
    mesh: DeviceMesh,
    lr: float,
    eps: float = 1e-8,
    offsets: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    mode: CombineMode = CombineMode.SUM,
    capacity_factor: float = 2.0,
    cold_frac: float = 1.0,
    axis: str = MODEL_AXIS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise AdaGrad on the hybrid layout: replicated head, routed tail.

    Head: the all-reduced head gradient is the global per-row gradient
    ``G_r``; the dense step ``accum += mean(G_r^2); head -= lr * G_r /
    sqrt(accum + eps)`` equals the row-sparse one, because untouched rows
    add 0 to the accumulator and 0 to the table. Every replica computes the
    same step from the same sum, so the replicas stay equal.

    Tail: cold (row, gradient row) pairs route to the owner, which sums
    them per unique row BEFORE squaring, as in
    :func:`sharded_rowwise_adagrad_sparse_update`.

    ``head_accum``: ``[hot]`` fp32, replicated; ``tail_accum``: this rank's
    ``[V_tail / n]`` block. Returns ``(head, tail, head_accum,
    tail_accum)``, updated in place.
    """
    n = axis_size(mesh, axis)
    hot, _, rows_per, nnz_l, cap = _hybrid_shapes(
        head_table, tail_table, indices, offsets, weights, mode, n, cold_frac,
        capacity_factor)
    if head_accum.shape[0] != hot or tail_accum.shape[0] != tail_table.shape[0]:
        raise ValueError("accumulators must be row-aligned with the parts")
    group = axis_group(mesh, axis)
    flat, sids, coeff, gy, pvalid = _prep_coo(indices, offsets, weights, mode, grad_y)
    hg = _hybrid_head_grad(indices, offsets, flat, sids, coeff, gy, hot)
    dist.all_reduce(hg, group=group)
    head_accum.add_((hg * hg).mean(dim=1))
    head_table.sub_((lr * hg / torch.sqrt(head_accum + eps)[:, None]).to(head_table.dtype))
    rows, uniq = _hybrid_tail_sums(flat, sids, gy, coeff, pvalid, hot, n, rows_per,
                                   cap, nnz_l, axis_index(mesh, axis), group)
    _compressed_adagrad_apply(tail_table, tail_accum, rows, uniq, lr, eps)
    return head_table, tail_table, head_accum, tail_accum


def _check_column_csr(indices, offsets):
    if indices.dim() != 1 or offsets.dim() != 1:
        raise ValueError(
            "column-sharded CSR wants replicated flat CSR "
            "(indices [nnz], offsets [batch+1]) — the "
            "column_sharded_lookup convention"
        )


def _gather_batch(indices, grad_y, weights, group):
    """The global fixed-hotness batch from the data axis's blocks."""
    return (all_gather(indices, group), all_gather(grad_y, group),
            None if weights is None else all_gather(weights, group))


@torch.no_grad()
def column_sharded_sgd_sparse_update(
    table: torch.Tensor,
    indices: torch.Tensor,
    grad_y: torch.Tensor,
    *,
    mesh: DeviceMesh,
    lr: float,
    offsets: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    mode: CombineMode = CombineMode.SUM,
    data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS,
) -> torch.Tensor:
    """Sparse SGD on a column-sharded table, in place.

    The update mirror of :func:`column_sharded_lookup`: the batch COO is
    all-gathered over the data axis, then every rank applies the same
    single-table sparse update (K3 compressed) to its width slice, so the
    table's replicas along ``data`` stay equal.

    ``table``: this rank's ``[V, W / n_model]`` block (spec ``(None,
    model)``); ``indices``/``weights``: ``[batch / n_data, hotness]``
    blocks (spec ``(data, None)``); ``grad_y``: the ``[batch / n_data, W /
    n_model]`` block (spec ``(data, model)``). CSR follows the column
    lookup: flat ``indices [nnz]``, ``offsets [batch + 1]`` and ``weights``
    replicated, ``grad_y`` the ``[batch, W / n_model]`` block. Returns
    ``table``, updated.
    """
    if mode == CombineMode.CONCAT:
        raise ValueError("pooled updates only; CONCAT unsupported")
    if weights is not None and mode != CombineMode.SUM:
        raise ValueError("weights are only supported with CombineMode.SUM")
    if offsets is not None:
        _check_column_csr(indices, offsets)
        return sgd_sparse_update(table, indices, grad_y, lr=lr, offsets=offsets,
                                 weights=weights, mode=mode)
    idx_g, gy_g, w_g = _gather_batch(indices, grad_y, weights,
                                     axis_group(mesh, data_axis))
    return sgd_sparse_update(table, idx_g, gy_g, lr=lr, weights=w_g, mode=mode)


@torch.no_grad()
def column_sharded_rowwise_adagrad_sparse_update(
    table: torch.Tensor,
    accum: torch.Tensor,
    indices: torch.Tensor,
    grad_y: torch.Tensor,
    *,
    mesh: DeviceMesh,
    lr: float,
    eps: float = 1e-8,
    offsets: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    mode: CombineMode = CombineMode.SUM,
    data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise AdaGrad on a column-sharded table, in place.

    The per-row statistic ``mean(G_r^2)`` spans the FULL row, but each rank
    holds a width slice: every rank sums its slice per row (K3 compressed)
    from the all-gathered global COO, and the squared sums are all-reduced
    over the model axis before the accumulator update. The sort is
    deterministic, so the unique rows line up on every rank.

    ``accum``: ``[V]`` fp32, replicated; the other arguments as
    :func:`column_sharded_sgd_sparse_update`. Returns ``(table, accum)``,
    updated.
    """
    if mode == CombineMode.CONCAT:
        raise ValueError("pooled updates only; CONCAT unsupported")
    if weights is not None and mode != CombineMode.SUM:
        raise ValueError("weights are only supported with CombineMode.SUM")
    full_width = table.shape[1] * axis_size(mesh, model_axis)
    if offsets is not None:
        _check_column_csr(indices, offsets)
        flat, sids, coeff, gy, _ = _prep_coo(indices, offsets, weights, mode, grad_y)
    else:
        idx_g, gy_g, w_g = _gather_batch(indices, grad_y, weights,
                                         axis_group(mesh, data_axis))
        flat, sids, coeff, gy, _ = _prep_coo(idx_g, None, w_g, mode, gy_g)
    rows_s, order = torch.sort(flat, stable=True)
    cg = dispatch.backward_compressed(gy.contiguous(), rows_s, sids[order],
                                      None if coeff is None else coeff[order])
    nu = min(int(cg.num_unique), cg.rows.shape[0])
    rows, uniq = cg.rows[:nu], cg.unique_indices[:nu].long()
    # The row statistic over the FULL row: the slices' squared sums, summed
    # over the model axis.
    sq = (rows * rows).sum(dim=1)
    dist.all_reduce(sq, group=axis_group(mesh, model_axis))
    keep = (uniq >= 0) & (uniq < accum.shape[0])
    return _compressed_adagrad_apply(table, accum, rows[keep], uniq[keep], lr, eps,
                                     g2=sq[keep] / full_width)


def _grid_update_shapes(table, indices, offsets, n_r, capacity_factor):
    """Validation and capacity sizing for the grid-routed updates."""
    nnz_l = _local_nnz(indices, offsets)[0]
    return table.shape[0], table.shape[1], nnz_l, _grid_cap(nnz_l, n_r, capacity_factor)


@torch.no_grad()
def grid_sharded_sgd_sparse_update(
    table: torch.Tensor,
    indices: torch.Tensor,
    grad_y: torch.Tensor,
    *,
    mesh: DeviceMesh,
    lr: float,
    offsets: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    mode: CombineMode = CombineMode.SUM,
    capacity_factor: float = 2.0,
    row_axis: str = MODEL_AXIS,
    col_axis: str = "data",
) -> torch.Tensor:
    """Sparse SGD on a grid-sharded table, in place.

    The update mirror of :func:`grid_sharded_lookup`: each column group
    routes its own ``[*, W / n_c]`` gradient slices over the ROW axis to the
    owning row rank; nothing crosses the column axis.

    ``table``: this rank's ``[V / n_r, W / n_c]`` block (spec ``(row_axis,
    col_axis)``); ``indices``/``weights``: ``[batch / n_r, hotness]`` blocks
    (spec ``(row_axis, None)``), or sharded-CSR ``[1, cap]`` blocks with
    ``offsets``; ``grad_y``: the ``[batch / n_r, W / n_c]`` block. Returns
    ``table``, updated.
    """
    _check_update(mode, weights)
    n_r = axis_size(mesh, row_axis)
    rows_per, _, nnz_l, cap = _grid_update_shapes(table, indices, offsets, n_r,
                                                  capacity_factor)
    flat, sids, coeff, gy, valid = _prep_coo(indices, offsets, weights, mode, grad_y)
    rows, uniq = _routed_sums(flat, sids, gy, coeff, valid, n_r, rows_per, cap, nnz_l,
                              axis_index(mesh, row_axis), axis_group(mesh, row_axis))
    return _sgd_apply(table, rows, uniq, lr)


@torch.no_grad()
def grid_sharded_rowwise_adagrad_sparse_update(
    table: torch.Tensor,
    accum: torch.Tensor,
    indices: torch.Tensor,
    grad_y: torch.Tensor,
    *,
    mesh: DeviceMesh,
    lr: float,
    eps: float = 1e-8,
    offsets: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    mode: CombineMode = CombineMode.SUM,
    capacity_factor: float = 2.0,
    row_axis: str = MODEL_AXIS,
    col_axis: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise AdaGrad on a grid-sharded table, in place.

    Per-row statistics span the FULL row, but each rank holds a width
    slice: after routing, the owner sums its slice per unique row, and one
    all-reduce over the COLUMN axis completes ``mean(G_r^2)``. The indices
    are replicated over the column axis, so every column group routes the
    same position stream and the unique rows line up.

    ``accum``: this rank's ``[V / n_r]`` block (spec ``(row_axis,)``); the
    other arguments as :func:`grid_sharded_sgd_sparse_update`. Returns
    ``(table, accum)``, updated.
    """
    _check_update(mode, weights)
    n_r = axis_size(mesh, row_axis)
    if accum.shape[0] != table.shape[0]:
        raise ValueError("accum must be row-aligned with the table")
    full_width = table.shape[1] * axis_size(mesh, col_axis)
    rows_per, _, nnz_l, cap = _grid_update_shapes(table, indices, offsets, n_r,
                                                  capacity_factor)
    flat, sids, coeff, gy, valid = _prep_coo(indices, offsets, weights, mode, grad_y)
    rows, uniq = _routed_sums(flat, sids, gy, coeff, valid, n_r, rows_per, cap, nnz_l,
                              axis_index(mesh, row_axis), axis_group(mesh, row_axis))
    sq = (rows * rows).sum(dim=1)
    dist.all_reduce(sq, group=axis_group(mesh, col_axis))
    return _compressed_adagrad_apply(table, accum, rows, uniq, lr, eps,
                                     g2=sq / full_width)
