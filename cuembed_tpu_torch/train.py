"""Sparse embedding-table training updates, the counterpart of
``cuembed_tpu/train.py``.

Autograd through :func:`~cuembed_tpu_torch.embedding_lookup` is exact but
materializes a dense ``[num_categories, width]`` gradient: at the flagship
size a 10 GB fp32 buffer, zeroed and read back every step. These functions
apply the embedding gradient sparsely instead:

* :func:`embedding_grad_y` splits the model's backward at the pooled
  embedding: dense parameters keep autograd, the table takes its update
  from the sparse routines below.
* :func:`sgd_sparse_update`, :func:`rowwise_adagrad_sparse_update` and
  :func:`adam_sparse_update` sort the lookup's COO by index on K5
  (``dispatch.transpose``), sum each index's run on K3 in compressed mode
  (``dispatch.backward_compressed``), and update one row per distinct index.
* Row-wise AdaGrad applies its step on K4
  (``dispatch.rowwise_adagrad_apply``) to K3's output as it lies on the
  card: K4 reads the row count there, so the untiered update reads nothing
  back to the host (the tiered ``overflow="drop"`` path still reads two
  counts once, in ``embedding_backward_compressed_tiered``), and it reads
  no row past the count, so K3's buffers are not zeroed. No ``index_add_``
  or ``index_copy_`` runs on the card; one writer a row, so the result is
  deterministic.
* SGD and Adam read the row count and the in-range runs back to the host
  (two waits a table, ``trace.wait``), then update with ``index_add_`` /
  ``index_copy_`` on the unique indices.

A ``tiered_cfg`` matters to SGD and AdaGrad only under ``overflow="drop"``,
where it bounds the updates as the JAX functions do: the rows under
``mxu_head_rows`` then take one fp32 product ``M^T @ grad_y`` and the
others come from K3 over the COO with the head positions masked
(``lookup_torch.embedding_backward_compressed_tiered``), cut at the
config's capacities. Under the default ``overflow="fallback"`` the JAX
split gives the same update as the untiered sums, which are faster on the
card, so the config is not used.

Updates happen in place on the tensors passed in, which are returned, as
the JAX functions return the new arrays.
"""

from __future__ import annotations

import torch

from cuembed_tpu_torch.ops import dispatch
from cuembed_tpu_torch.ops.head import nonhead_capacity
from cuembed_tpu_torch.ops.lookup_torch import (
    SENTINEL,
    CompressedGrad,
    embedding_backward_compressed_tiered,
)
from cuembed_tpu_torch.ops.transforms import extract_row_ids_from_csr, fixed_sample_ids
from cuembed_tpu_torch.types import CombineMode, default_device
from cuembed_tpu_torch.utils import trace


def embedding_grad_y(loss_fn, pooled, *args, **kwargs) -> torch.Tensor:
    """Gradient of ``loss_fn(pooled, *args, **kwargs)`` w.r.t. the pooled
    embeddings (computed without a graph to the table), for a sparse update."""
    pooled = pooled.detach().requires_grad_()
    with torch.enable_grad():
        loss = loss_fn(pooled, *args, **kwargs)
    (grad,) = torch.autograd.grad(loss, pooled)
    return grad


def _coo(indices, offsets, weights, mode, acc_dt):
    """The lookup as a COO, in the form :func:`dispatch.transpose
    <cuembed_tpu_torch.ops.dispatch.transpose>` takes it: ``(flat_idx,
    hotness, sample_ids, coeff)``. A fixed-hotness lookup gives its hotness
    (a position's sample is the position // it; 1 for CONCAT, whose grad_y
    has one row per position) and no sample ids, a CSR lookup its sample ids
    and no hotness. ``coeff`` is None when every position has coefficient one
    (callers fold MEAN's uniform scale into grad_y). CSR padding gets index 0
    and coefficient 0."""
    if offsets is None:
        flat_idx = indices.reshape(-1)
        if mode == CombineMode.CONCAT:
            if weights is not None:
                raise ValueError("weights unsupported with CONCAT")
            return flat_idx, 1, None, None
        hotness = indices.shape[1]
        if weights is None:
            return flat_idx, hotness, None, None
        coeff = weights.reshape(-1).to(acc_dt)
        if mode == CombineMode.MEAN:
            coeff = coeff / hotness
        return flat_idx, hotness, None, coeff
    n = indices.shape[0]
    live = torch.arange(n, device=indices.device) < offsets[-1]
    flat_idx = torch.where(live, indices, torch.zeros_like(indices))
    sample_ids = extract_row_ids_from_csr(offsets, indices).to(torch.int32)
    coeff = live.to(acc_dt)
    if weights is not None:
        coeff = coeff * weights.to(acc_dt)
    if mode == CombineMode.MEAN:
        hot = (offsets[1:] - offsets[:-1]).to(acc_dt)
        inv = torch.where(hot == 0, torch.zeros_like(hot), 1.0 / hot.clamp(min=1.0))
        coeff = coeff * inv[sample_ids.long()]
    return flat_idx, None, sample_ids, coeff


def _flatten_coo(indices, offsets, weights, mode, acc_dt):
    """The lookup as a COO with its sample ids: ``(flat_idx, sample_ids,
    coeff)`` (int32 sample ids; otherwise as :func:`_coo`)."""
    flat_idx, hotness, sample_ids, coeff = _coo(indices, offsets, weights, mode, acc_dt)
    if sample_ids is None:
        sample_ids = fixed_sample_ids(flat_idx.shape[0], hotness, device=flat_idx.device)
    return flat_idx, sample_ids, coeff


def _head_rows(table, tiered_cfg, offsets, mode) -> int:
    """Rows the tiered update takes as the head product (0: untiered), as
    the JAX functions choose them: fixed hotness, pooled, with a config."""
    if tiered_cfg is None or offsets is not None or mode == CombineMode.CONCAT:
        return 0
    return min(tiered_cfg.mxu_head_rows, table.shape[0])


def _compressed_sums(table, indices, grad_y, offsets, weights, mode, backend, *,
                     drop_zero_coeff, tiered_cfg=None, drop_past_capacity=False,
                     unique_cap=None) -> CompressedGrad:
    """Per-row gradient sums of the batch, as K3's compressed gradient:
    ``rows[r]`` sums the run of ``unique_indices[r]``, ascending, for ``r <
    num_unique`` (a count on the device, which may exceed the capacity
    after a ``unique_cap`` cut); out-of-range runs (the sentinel) included;
    entries past the count are unspecified. With ``drop_zero_coeff``,
    positions whose coefficient is 0 (CSR padding, zero weights) touch no
    row (a head row they hit keeps a zero gradient). ``drop_past_capacity``
    keeps only the first ``nonhead_capacity`` sorted non-head positions and
    ``unique_cap`` only the first ``unique_cap`` non-head rows (the JAX functions'
    ``overflow="drop"``): with a ``tiered_cfg`` (see :func:`_head_rows`)
    either takes the head rows from the head product. Without a cut the
    config changes no sum, and the sums are untiered."""
    gy = grad_y.to(torch.float32)
    if weights is None and offsets is None and mode == CombineMode.MEAN:
        gy = gy * (1.0 / indices.shape[1])  # the uniform coefficient folds into gy
    flat_idx, hotness, sample_ids, coeff = _coo(indices, offsets, weights, mode, torch.float32)
    if drop_zero_coeff and coeff is not None:
        flat_idx = torch.where(coeff != 0, flat_idx, torch.full_like(flat_idx, SENTINEL))
    head = _head_rows(table, tiered_cfg, offsets, mode)
    if head > 0 and (drop_past_capacity or unique_cap is not None):
        masked = torch.where(flat_idx < head, SENTINEL, flat_idx)
        t_idx, t_sid, t_coeff = dispatch.transpose(
            masked, table.shape[0], hotness=hotness, sample_ids=sample_ids, coeff=coeff,
            backend=backend)
        if drop_past_capacity:
            k = nonhead_capacity(tiered_cfg, t_idx.shape[0])
            t_idx, t_sid = t_idx[:k], t_sid[:k]
            t_coeff = None if t_coeff is None else t_coeff[:k]
        return embedding_backward_compressed_tiered(
            gy.contiguous(), table.shape[0], indices,
            None if coeff is None else coeff.reshape(indices.shape),
            t_idx, t_sid, t_coeff, tiered_cfg, unique_cap=unique_cap, backend=backend)
    t_idx, t_sid, t_coeff = dispatch.transpose(
        flat_idx, table.shape[0], hotness=hotness, sample_ids=sample_ids, coeff=coeff,
        backend=backend)
    return dispatch.backward_compressed(gy.contiguous(), t_idx, t_sid, t_coeff,
                                        backend=backend)


def _row_sums(table, indices, grad_y, offsets, weights, mode, backend, **cut):
    """Per-row gradient sums of the batch: ``(rows, uniq)`` for the distinct
    in-range indices, ascending (arguments as :func:`_compressed_sums`)."""
    cg = _compressed_sums(table, indices, grad_y, offsets, weights, mode, backend, **cut)
    # Two host waits: the unique count, then the in-range runs' positions.
    nu = min(trace.wait("num_unique", int, cg.num_unique), cg.rows.shape[0])
    rows, uniq = cg.rows[:nu], cg.unique_indices[:nu]
    # The sentinel run (and any out-of-range index) updates nothing.
    in_range = (uniq >= 0) & (uniq < table.shape[0])
    keep = trace.wait("keep_mask", torch.nonzero, in_range)[:, 0]
    return rows.index_select(0, keep), uniq.index_select(0, keep).long()


@torch.no_grad()
def sgd_sparse_update(
    table: torch.Tensor,
    indices: torch.Tensor,
    grad_y: torch.Tensor,
    *,
    lr: float,
    offsets: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    mode: CombineMode = CombineMode.SUM,
    tiered_cfg=None,
    overflow: str = "fallback",
    backend: str = "auto",
) -> torch.Tensor:
    """One SGD step on the table, applied sparsely and in place:
    ``table - lr * dense_grad`` (up to fp reassociation) without the dense
    gradient. ``overflow`` (with a ``tiered_cfg`` only): ``"fallback"`` is
    exact, and the config then changes nothing; ``"drop"`` applies only the
    first ``nonhead_capacity`` sorted non-head positions, with the head
    rows' gradient from the head product, as the JAX function drops an
    overflowing batch's coldest updates."""
    rows, uniq = _row_sums(table, indices, grad_y, offsets, weights, mode, backend,
                           drop_zero_coeff=False, tiered_cfg=tiered_cfg,
                           drop_past_capacity=overflow == "drop")
    return table.index_add_(0, uniq, (-lr * rows).to(table.dtype))


def rowwise_adagrad_init(num_categories: int, *, device=None) -> torch.Tensor:
    """Per-row accumulator state (fp32), one scalar per table row, on
    ``device`` or, when none is given, on the card (raises without one)."""
    return torch.zeros((num_categories,), dtype=torch.float32,
                       device=default_device(device))


@torch.no_grad()
def rowwise_adagrad_sparse_update(
    table: torch.Tensor,
    accum: torch.Tensor,
    indices: torch.Tensor,
    grad_y: torch.Tensor,
    *,
    lr: float,
    eps: float = 1e-8,
    offsets: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    mode: CombineMode = CombineMode.SUM,
    tiered_cfg=None,
    unique_cap: int | None = None,
    overflow: str = "fallback",
    backend: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise AdaGrad (the standard DLRM embedding optimizer), in place.

    Per touched row r with gradient row G_r:
      ``accum[r] += mean(G_r^2)``;
      ``table[r] -= lr * G_r / sqrt(accum[r] + eps)``.
    Untouched rows, and rows whose only lookups have coefficient 0, keep
    their state and values. ``unique_cap`` bounds a ``tiered_cfg``'s
    non-head rows: under ``overflow="fallback"`` (default) a batch with
    more is served exactly, and the config then changes nothing; under
    ``"drop"`` its rows past the bound are dropped, with the head rows'
    gradient from the head product, as in the JAX function.
    """
    with trace.span("train.row_sums"):
        cg = _compressed_sums(table, indices, grad_y, offsets, weights, mode, backend,
                              drop_zero_coeff=True, tiered_cfg=tiered_cfg,
                              unique_cap=unique_cap if overflow == "drop" else None)
    with trace.span("train.adagrad"):
        # K4 on the card: the count stays there; a count past the capacity
        # (a unique_cap cut) is clamped to it, as in the JAX function.
        dispatch.rowwise_adagrad_apply(table, accum, cg, lr=lr, eps=eps, backend=backend)
    return table, accum


def adam_init(num_categories: int, width: int, *, device=None):
    """Per-element Adam moments ``(m, v)``, fp32, zero-initialized, on
    ``device`` or, when none is given, on the card (raises without one)."""
    device = default_device(device)
    return (torch.zeros((num_categories, width), dtype=torch.float32, device=device),
            torch.zeros((num_categories, width), dtype=torch.float32, device=device))


@torch.no_grad()
def adam_sparse_update(
    table: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    step,
    indices: torch.Tensor,
    grad_y: torch.Tensor,
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    offsets: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    mode: CombineMode = CombineMode.SUM,
    backend: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sparse lazy Adam, in place: the moments decay and update only on
    touched rows.

    Per touched row r with batch gradient row ``G_r``::

        m[r] = b1*m[r] + (1-b1)*G_r
        v[r] = b2*v[r] + (1-b2)*G_r^2
        table[r] -= lr * (m[r]/(1-b1^t)) / (sqrt(v[r]/(1-b2^t)) + eps)

    ``step`` is the 1-based global step; a step below 1 counts as 1.
    """
    rows, uniq = _row_sums(table, indices, grad_y, offsets, weights, mode, backend,
                           drop_zero_coeff=True)
    m_rows = b1 * m.index_select(0, uniq) + (1.0 - b1) * rows
    v_rows = b2 * v.index_select(0, uniq) + (1.0 - b2) * rows * rows
    # Bias correction in fp32, as the JAX function computes it.
    f32 = dict(dtype=torch.float32, device=rows.device)
    t = torch.as_tensor(step, **f32).clamp(min=1.0)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, **f32), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, **f32), t)
    upd = lr * (m_rows / bc1) / (torch.sqrt(v_rows / bc2) + eps)
    m.index_copy_(0, uniq, m_rows)
    v.index_copy_(0, uniq, v_rows)
    table.index_add_(0, uniq, (-upd).to(table.dtype))
    return table, m, v
