"""Plain PyTorch lookup and backward, the counterpart of
``cuembed_tpu/ops/lookup_xla.py``.

It is the path for CPU tensors and the yardstick the CUDA kernels are held
to. The forward keeps the JAX rounding choices: rows are cast to the accumulation
dtype, weighted rows are multiplied and then added one position at a time in
that dtype (so a storage-dtype sum rounds at each add), fixed MEAN multiplies
by the rounded reciprocal ``acc(1/hotness)``, and CSR MEAN sums first and
then scales by ``acc(1/acc(h_s))``. Summing one position at a time, in
position order, is also the order the kernels use, so on the same inputs the
two agree bit for bit.

The backward mirrors ``embedding_backward_xla``: it gathers ``grad_y`` rows,
multiplies them by their coefficient in ``grad_y``'s dtype and adds them one
position at a time, in sorted order, in that dtype. K3 instead sums each run
in fp32 and adds the sum to the row once (the Pallas kernel's rounding), so
the two agree bit for bit only where every partial sum is exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cuembed_tpu_torch.types import CombineMode, accumulation_dtype


def rounded_reciprocal(n: int, acc_dtype: torch.dtype) -> float:
    """``acc_dtype(1/n)`` as a Python float, rounded as the JAX package rounds
    ``np.dtype(acc_dt).type(1.0 / n)``, and as JAX rounds a Python float
    that multiplies an array of that dtype: straight from float64 for fp32
    and fp16, through fp32 for bf16 (ml_dtypes' conversion)."""
    if acc_dtype == torch.float64:
        return 1.0 / n
    if acc_dtype == torch.float32:
        return float(np.float32(1.0 / n))
    if acc_dtype == torch.float16:
        return float(np.float16(1.0 / n))
    return torch.tensor(1.0 / n, dtype=torch.float32).to(acc_dtype).item()


def embedding_forward_torch(
    table: torch.Tensor,
    indices: torch.Tensor,
    offsets: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    *,
    mode: CombineMode = CombineMode.SUM,
    low_precision_math: bool = False,
) -> torch.Tensor:
    """Forward lookup with plain tensor ops, on the device of the inputs.

    Args:
      table: ``[num_categories, width]``.
      indices: ``[batch, hotness]`` (fixed) or flat ``[capacity]`` (CSR).
      offsets: ``[batch + 1]`` CSR offsets; None selects fixed-hotness.
        With CSR, positions >= ``offsets[-1]`` are padding and ignored.
      weights: same shape as indices (SUM only).
      mode: SUM / MEAN / CONCAT (CONCAT is fixed-hotness only).
      low_precision_math: accumulate half tables in half precision.

    Returns:
      ``[batch, width]``, or ``[batch * hotness, width]`` for CONCAT.
    """
    if weights is not None and mode != CombineMode.SUM:
        raise ValueError("weights only supported with SUM")
    acc_dt = accumulation_dtype(table.dtype, low_precision_math)
    width = table.shape[1]

    if offsets is None:
        if indices.dim() != 2:
            raise ValueError("fixed-hotness indices must be [batch, hotness]")
        batch, hotness = indices.shape
        if mode == CombineMode.CONCAT:
            return table.index_select(0, indices.reshape(-1))
        acc = torch.zeros((batch, width), dtype=acc_dt, device=table.device)
        for j in range(hotness):
            rows = table.index_select(0, indices[:, j]).to(acc_dt)
            if weights is not None:
                rows = rows * weights[:, j].to(acc_dt)[:, None]
            acc = acc + rows
        if mode == CombineMode.MEAN:
            acc = acc * rounded_reciprocal(hotness, acc_dt)
        return acc.to(table.dtype)

    # CSR path.
    if mode == CombineMode.CONCAT:
        raise ValueError("CSR does not support CONCAT")
    if indices.dim() != 1:
        raise ValueError("CSR indices must be flat [capacity]")
    batch = offsets.shape[0] - 1
    cap = indices.shape[0]
    starts = offsets[:-1].to(torch.int64).clamp(min=0)
    ends = offsets[1:].to(torch.int64).clamp(max=min(int(offsets[-1]), cap))
    counts = (ends - starts).clamp(min=0)
    acc = torch.zeros((batch, width), dtype=acc_dt, device=table.device)
    # Rank j of every sample that has one, in rank order: the per-sample
    # position order of the golden model and the kernel.
    for j in range(int(counts.max()) if batch else 0):
        samples = torch.nonzero(counts > j).squeeze(1)
        pos = starts[samples] + j
        rows = table.index_select(0, indices[pos]).to(acc_dt)
        if weights is not None:
            rows = rows * weights[pos].to(acc_dt)[:, None]
        acc[samples] = acc[samples] + rows
    if mode == CombineMode.MEAN:
        hot = (offsets[1:] - offsets[:-1]).to(acc_dt)
        scale = torch.where(
            hot == 0,
            torch.zeros_like(hot),
            torch.ones_like(hot) / hot.clamp(min=1),
        )
        acc = acc * scale[:, None]
    return acc.to(table.dtype)


# Index of padding positions in a COO: past every real row, so it sorts last
# and is dropped by the full backward.
SENTINEL = 2**31 - 1


class CompressedGrad(NamedTuple):
    """Compressed (deduplicated) embedding gradient.

    ``rows[i]`` is the gradient for table row ``unique_indices[i]``, for
    ``i < num_unique``, and a reader takes only those. Past ``num_unique``
    the plain version leaves zero rows and indices 0; K3 leaves what its
    buffers held (see ``embedding_backward_cuda_compressed``).
    """

    rows: torch.Tensor  # [capacity, width]
    unique_indices: torch.Tensor  # [capacity]
    num_unique: torch.Tensor  # 0-dim int64


def _live_prefix(t_idx, nnz, live_cap):
    """The length of the prefix that holds every live entry: the capacity,
    or ``live_cap`` rounded up to 8 when the live entries fit in it (the
    JAX ``lax.cond`` fallback, taken on the host)."""
    cap = t_idx.shape[0]
    if live_cap is None or not 0 < live_cap < cap:
        return cap
    k = -(-live_cap // 8) * 8
    live_n = int(nnz) if nnz is not None else int((t_idx != SENTINEL).sum())
    return k if live_n <= k else cap


def _add_in_order(out, targets, rows):
    """``out[targets[p]] += rows[p]`` for every ``p`` in order, each add
    rounded to ``out``'s dtype, as XLA's scatter-add applies duplicate
    sorted indices. ``index_add_`` does that for fp32 and float64 on the
    CPU, but for a half type it sums a target's rows in fp32 and rounds
    once; there the adds go in steps, step ``j`` adding the ``j``-th
    position of every run of equal targets."""
    if out.dtype not in (torch.float16, torch.bfloat16) or targets.numel() == 0:
        return out.index_add_(0, targets, rows)
    pos = torch.arange(targets.numel(), device=targets.device)
    starts = torch.ones_like(targets, dtype=torch.bool)
    starts[1:] = targets[1:] != targets[:-1]
    step = pos - torch.cummax(torch.where(starts, pos, 0), 0).values
    order = torch.sort(step, stable=True).indices
    for sel in torch.split(order, torch.bincount(step).tolist()):
        out.index_add_(0, targets[sel], rows[sel])
    return out


def embedding_backward_torch(
    grad_y: torch.Tensor,
    num_categories: int,
    transpose_indices: torch.Tensor,
    transpose_sample_ids: torch.Tensor,
    transpose_weights: torch.Tensor | None = None,
    *,
    nnz=None,
    initial_grad: torch.Tensor | None = None,
    live_cap: int | None = None,
) -> torch.Tensor:
    """Full ``[num_categories, width]`` gradient from an index-sorted COO.

    Args:
      grad_y: ``[rows, width]`` upstream gradient.
      num_categories: rows of the gradient.
      transpose_indices / sample_ids / weights: the index-sorted COO
        ``[capacity]``. Entries whose index is out of range are dropped.
      nnz: live prefix length (positions >= nnz are dropped); None is the
        whole capacity.
      initial_grad: optional ``[num_categories, width]`` buffer of
        ``grad_y``'s dtype to add into, in place (the reference's
        ``skip_grad_init``); it is returned.
      live_cap: a bound on the live entries; it only limits the work.

    Returns:
      ``[num_categories, width]`` in ``grad_y``'s dtype.
    """
    k = _live_prefix(transpose_indices, nnz, live_cap)
    t_idx, t_sid = transpose_indices[:k], transpose_sample_ids[:k]
    live = torch.arange(k, device=t_idx.device) < (k if nnz is None else int(nnz))
    coeff = live.to(grad_y.dtype)
    if transpose_weights is not None:
        coeff = coeff * transpose_weights[:k].to(grad_y.dtype)
    g = grad_y.index_select(0, t_sid.long()) * coeff[:, None]
    if initial_grad is None:
        grad = torch.zeros((num_categories, grad_y.shape[1]), dtype=grad_y.dtype,
                           device=grad_y.device)
    else:
        grad = initial_grad
    # index_add_ adds every entry: drop the dead and out-of-range ones first
    # (JAX's mode="drop").
    keep = live & (t_idx >= 0) & (t_idx < num_categories)
    return _add_in_order(grad, t_idx[keep].long(), g[keep])


def _compressed_scatter(grad_y, t_idx, t_sid, t_w, live_count, *, out_cap, out=None):
    """Run ``r`` of the live prefix sums into ``rows[r]`` and names its
    index in ``uniq[r]`` (0 past the runs, or ``out``'s own values);
    returns ``(rows, uniq, n_runs)``."""
    k = t_idx.shape[0]
    device = t_idx.device
    live = torch.arange(k, device=device) < (k if live_count is None else int(live_count))
    idxs = torch.where(live, t_idx, torch.full_like(t_idx, SENTINEL))
    boundary = torch.cat([live[:1], (idxs[1:] != idxs[:-1]) & live[1:]])
    ranks = torch.cumsum(boundary.long(), 0) - 1
    n_runs = (ranks[-1] + 1).clamp(min=0) if k else torch.zeros((), dtype=torch.int64,
                                                               device=device)
    g = grad_y.index_select(0, t_sid.long())
    if t_w is not None:
        g = g * t_w.to(grad_y.dtype)[:, None]
    if out is None:
        rows = torch.zeros((out_cap, grad_y.shape[1]), dtype=grad_y.dtype, device=device)
        uniq = torch.zeros((out_cap,), dtype=t_idx.dtype, device=device)
    else:
        rows, uniq = out
    keep = live & (ranks < out_cap)
    _add_in_order(rows, ranks[keep], g[keep])
    starts = boundary & (ranks < out_cap)
    uniq[ranks[starts]] = t_idx[starts]
    return rows, uniq, n_runs


def embedding_backward_compressed_torch(
    grad_y: torch.Tensor,
    transpose_indices: torch.Tensor,
    transpose_sample_ids: torch.Tensor,
    transpose_weights: torch.Tensor | None = None,
    *,
    nnz=None,
    live_cap: int | None = None,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> CompressedGrad:
    """Compressed gradient: one row per run of equal indices in the live
    prefix of the index-sorted COO. Every run counts, an out-of-range one
    (the sentinel) included. The outputs keep the full capacity;
    ``live_cap`` only limits the work. ``out``: ``(rows, unique_indices)``
    buffers of that capacity (rows zeroed, ``grad_y``'s dtype; indices of
    the COO's dtype) to write into, in place; entries past the runs keep
    their values."""
    cap = transpose_indices.shape[0]
    k = _live_prefix(transpose_indices, nnz, live_cap)
    rows, uniq, n_runs = _compressed_scatter(
        grad_y, transpose_indices[:k], transpose_sample_ids[:k],
        None if transpose_weights is None else transpose_weights[:k],
        nnz, out_cap=cap, out=out,
    )
    return CompressedGrad(rows=rows, unique_indices=uniq, num_unique=n_runs)


def embedding_backward_compressed_tiered(
    grad_y: torch.Tensor,
    num_categories: int,
    indices2d: torch.Tensor,
    coeff2d: torch.Tensor | None,
    t_idx: torch.Tensor,
    t_sid: torch.Tensor,
    t_coeff: torch.Tensor | None,
    cfg,
    *,
    unique_cap: int | None = None,
    backend: str = "auto",
) -> CompressedGrad:
    """Compressed gradient with the head rows taken as one product, the
    counterpart of ``lookup_xla.embedding_backward_compressed_tiered``.

    Inputs as :func:`~cuembed_tpu_torch.ops.head.tiered_backward_coo`: the
    COO is index-sorted, its head positions (``idx < cfg.mxu_head_rows``)
    turned into the int32-max sentinel before the sort. Output as
    :class:`CompressedGrad`, in ``grad_y``'s dtype: first the head rows that
    any position hits (zero coefficients included), ascending, each
    ``(M^T @ grad_y)[row]``; then one row per run of the non-sentinel
    prefix (``dispatch.backward_compressed``: K3 on the card), ascending.
    ``unique_indices`` past ``num_unique`` are the sentinel, and rows there
    are zero. The capacity is ``nnz + head_rows``, or ``unique_cap +
    head_rows`` where that is smaller: then runs past it are dropped and
    ``num_unique > rows.shape[0]`` flags it.

    The head's row count and the non-sentinel count are read on the host
    once: they place the non-head runs and keep the sentinel run out.
    """
    from cuembed_tpu_torch.ops import dispatch
    from cuembed_tpu_torch.ops.head import fp32_matmul, head_matrix

    head_rows = min(cfg.mxu_head_rows, num_categories)
    nnz_cap = t_idx.shape[0]
    full = nnz_cap + head_rows
    cap = full if unique_cap is None else min(unique_cap + head_rows, full)
    device = grad_y.device
    m, appeared = head_matrix(indices2d, coeff2d, head_rows, grad_y.dtype,
                              return_appeared=True)
    g_head = fp32_matmul(m.t(), grad_y)
    n_head, rest = torch.stack([appeared.sum(), (t_idx != SENTINEL).sum()]).tolist()
    rows = torch.zeros((full, grad_y.shape[1]), dtype=grad_y.dtype, device=device)
    uniq = torch.full((full,), SENTINEL, dtype=t_idx.dtype, device=device)
    rows[:n_head] = g_head[appeared]
    uniq[:n_head] = torch.nonzero(appeared).squeeze(1).to(t_idx.dtype)
    span = slice(n_head, n_head + nnz_cap)
    cg = dispatch.backward_compressed(grad_y, t_idx, t_sid, t_coeff, nnz=rest,
                                      backend=backend, out=(rows[span], uniq[span]))
    return CompressedGrad(rows=rows[:cap], unique_indices=uniq[:cap],
                          num_unique=cg.num_unique + n_head)
