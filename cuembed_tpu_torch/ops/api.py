"""The user-facing differentiable embedding-lookup API, the counterpart of
``cuembed_tpu/ops/api.py``.

Same signatures as the JAX package. The lookup is a
``torch.autograd.Function`` (the JAX ``custom_vjp``): its forward saves only
``(table, indices, offsets, weights)``, and its backward flattens the lookup
to a COO, sorts it by index on K5 (``dispatch.transpose``) and sums each
index's run on K3 (``dispatch.backward``), deterministically and without
atomics.
A ``tiered_cfg`` changes no gradient, so the backward takes K3 over the
whole COO with or without one: the JAX backward's split into a head product
and a sum of the rest (kept as
:func:`~cuembed_tpu_torch.ops.head.tiered_backward_coo`) gives the same
gradient more slowly on the card. A CSR config's ``csr_live_cap`` bounds the
plain version's live entries. Gradients flow to the table and to the
per-lookup weights; indices and offsets have none.

This module alone decides whether a lookup needs autograd.
"""

from __future__ import annotations

import torch

from cuembed_tpu_torch.ops import dispatch
from cuembed_tpu_torch.ops.lookup_torch import SENTINEL, rounded_reciprocal
from cuembed_tpu_torch.ops.transforms import extract_row_ids_from_csr, fixed_sample_ids
from cuembed_tpu_torch.types import CombineMode, accumulation_dtype, check_index_dtype
from cuembed_tpu_torch.utils import trace


def embedding_lookup(
    table: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    mode: CombineMode = CombineMode.SUM,
    low_precision_math: bool = False,
    backend: str = "auto",
    tiered_cfg=None,
    remap: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fixed-hotness embedding lookup.

    Args:
      table: ``[num_categories, width]`` embedding table.
      indices: ``[batch, hotness]`` int32/int64 lookup indices.
      weights: optional ``[batch, hotness]`` weights (SUM only).
      mode: SUM / MEAN / CONCAT.
      low_precision_math: accumulate half tables in half precision
        (the reference's ``fp16_math=true``).
      backend: "auto" or "pallas" (the kernel on CUDA), "xla" (the plain
        PyTorch version), "tiered" or "narrow" (the TPU engines' routes, on
        the same kernels); see :mod:`cuembed_tpu_torch.ops.dispatch`.
      tiered_cfg: a :class:`~cuembed_tpu_torch.ops.tiered.TieredConfig`;
        with ``backend="tiered"`` it selects the tiered forward. It
        changes no result, forward or backward.
      remap: optional ``[num_categories]`` category->row translation,
        applied to ``indices`` before the lookup.

    Returns:
      ``[batch, width]`` (SUM/MEAN) or ``[batch * hotness, width]`` (CONCAT).
    """
    span = (trace.begin("api.lookup")
            if trace.torch_profiler._is_profiler_enabled else None)
    try:
        indices = _prepare_indices(indices, remap)
        _validate(table, indices, None, weights, mode)
        return _lookup(table, indices, None, weights, mode, low_precision_math,
                       backend, tiered_cfg)
    finally:
        if span is not None:
            trace.end(span)


def embedding_lookup_many(tables, indices, weights, modes, *, backend: str = "auto") -> list:
    """Fixed-hotness lookups, the list form: result ``i`` is
    ``embedding_lookup(tables[i], indices[i], weights[i], mode=modes[i],
    backend=backend)``, bit for bit.

    The lookups that autograd does not need (grad mode off, or neither the
    table nor the weights requiring a gradient) go to
    ``dispatch.forward_many`` in one call, and those it serves open no
    ``api.lookup`` span; where the call's lookups on the card share (batch,
    width, dtype), their results are views of one buffer. Every other
    lookup, and every one the layers below refuse (on the CPU, CONCAT, under
    a backend without kernels, or inputs whose checks raise), goes through
    :func:`embedding_lookup` itself, which serves it or raises its error.
    """
    grad = torch.is_grad_enabled()
    if not (grad and any(t.requires_grad or (w is not None and w.requires_grad)
                         for t, w in zip(tables, weights))):
        outs = dispatch.forward_many(tables, indices, weights, modes, backend=backend)
    else:
        free = [k for k, (t, w) in enumerate(zip(tables, weights))
                if not (t.requires_grad or (w is not None and w.requires_grad))]
        outs = [None] * len(tables)
        for k, out in zip(free, dispatch.forward_many(
                *([seq[k] for k in free] for seq in (tables, indices, weights, modes)),
                backend=backend)):
            outs[k] = out
    if all(out is not None for out in outs):
        return outs
    return [embedding_lookup(t, i, w, mode=m, backend=backend) if out is None else out
            for out, t, i, w, m in zip(outs, tables, indices, weights, modes)]


def embedding_lookup_csr(
    table: torch.Tensor,
    indices: torch.Tensor,
    offsets: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    mode: CombineMode = CombineMode.SUM,
    low_precision_math: bool = False,
    backend: str = "auto",
    tiered_cfg=None,
    remap: torch.Tensor | None = None,
) -> torch.Tensor:
    """CSR (variable-hotness) embedding lookup.

    ``indices`` is the flat value array (entries at or beyond ``offsets[-1]``
    are padding and ignored), ``offsets`` is ``[batch + 1]``. CONCAT is not
    supported with CSR. ``remap`` as in :func:`embedding_lookup`.
    """
    span = (trace.begin("api.lookup")
            if trace.torch_profiler._is_profiler_enabled else None)
    try:
        indices = _prepare_indices(indices, remap)
        _validate(table, indices, offsets, weights, mode)
        check_index_dtype(offsets.dtype)
        return _lookup(table, indices, offsets, weights, mode, low_precision_math,
                       backend, tiered_cfg)
    finally:
        if span is not None:
            trace.end(span)


def _prepare_indices(indices, remap):
    check_index_dtype(indices.dtype)
    if remap is None:
        return indices
    return remap.index_select(0, indices.reshape(-1)).reshape(indices.shape)


def _validate(table, indices, offsets, weights, mode):
    if weights is not None and mode != CombineMode.SUM:
        raise ValueError("weights are only supported with CombineMode.SUM")
    if offsets is not None:
        if mode == CombineMode.CONCAT:
            raise ValueError("CSR does not support CONCAT")
        if indices.dim() != 1:
            raise ValueError("CSR indices must be flat [capacity]")
    else:
        if indices.dim() != 2:
            raise ValueError("fixed-hotness indices must be [batch, hotness]")
    if table.dim() != 2:
        raise ValueError("table must be [num_categories, width]")


def _lookup(table, indices, offsets, weights, mode, low_precision_math,
            backend, tiered_cfg):
    return _Lookup.apply(table, indices, offsets, weights,
                         (mode, low_precision_math, backend, tiered_cfg))


class _Lookup(torch.autograd.Function):
    """The lookup with its COO backward (``api.py::_lookup_fwd/_lookup_bwd``)."""

    @staticmethod
    def forward(ctx, table, indices, offsets, weights, cfg):
        mode, low_precision_math, backend, tiered_cfg = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(table, indices, offsets, weights)
        return dispatch.forward(
            table.contiguous(),
            indices.contiguous(),
            None if offsets is None else offsets.contiguous(),
            None if weights is None else weights.to(torch.float32).contiguous(),
            mode=mode,
            low_precision_math=low_precision_math,
            backend=backend,
            tiered_cfg=tiered_cfg,
        )

    @staticmethod
    def backward(ctx, grad_y):
        table, indices, offsets, weights = ctx.saved_tensors
        grad_table, grad_weights = _lookup_bwd(
            ctx.cfg, table, indices, offsets, weights, grad_y.contiguous(),
            need_table=ctx.needs_input_grad[0], need_weights=ctx.needs_input_grad[3])
        return grad_table, None, None, grad_weights, None


# Positions per slice of the weights gradient, which gathers a [n, width]
# block of table rows and of grad_y rows.
_WEIGHTS_GRAD_SLICE = 1 << 20


def _lookup_bwd(cfg, table, indices, offsets, weights, grad_y, *, need_table=True,
                need_weights=True):
    """Table and weights gradients: flatten to a COO, sort it by index, sum
    the runs (``dispatch.backward``), and dot each looked-up row with its
    ``grad_y`` row for the weights."""
    mode, low_precision_math, backend, tiered = cfg
    num_categories, width = table.shape
    if num_categories >= 2**31:
        raise NotImplementedError(
            "backward for tables with >= 2**31 rows is unsupported: the sparse "
            "COO path keeps the int32-max sentinel; use forward-only lookups"
        )
    acc_dt = accumulation_dtype(table.dtype, low_precision_math)
    device = table.device

    # --- Flatten to COO: (flat_idx, sample ids, coeff) ---------------------
    # A fixed lookup's sample ids are its positions // hotness (the
    # transpose makes them); a CSR lookup's come from its offsets.
    sample_ids = None
    if offsets is None:
        batch, hotness = indices.shape
        nnz_cap = batch * hotness
        flat_idx = indices.reshape(-1)
        if mode == CombineMode.CONCAT:
            hotness = 1  # one grad_y row per position
            grad_rows_in = grad_y.reshape(nnz_cap, width)
        else:
            grad_rows_in = grad_y
        nnz = None
        live = None
    else:
        nnz_cap = indices.shape[0]
        pos = torch.arange(nnz_cap, device=device)
        live = pos < offsets[-1]
        # Padded entries get an out-of-range sentinel so they sort last.
        flat_idx = torch.where(live, indices, torch.full_like(indices, SENTINEL))
        hotness = None
        sample_ids = extract_row_ids_from_csr(offsets, indices).to(torch.int32)
        grad_rows_in = grad_y
        nnz = offsets[-1]

    # Per-position coefficient. An unweighted fixed lookup has one constant,
    # folded into grad_y (in grad_y's dtype, before the cast, with 1/hotness
    # rounded to that dtype first, as JAX rounds the Python float), so the
    # COO carries no coefficient.
    if weights is None and offsets is None:
        coeff = None
        if mode == CombineMode.MEAN:
            grad_rows_in = grad_rows_in * rounded_reciprocal(indices.shape[1],
                                                             grad_rows_in.dtype)
    else:
        coeff = torch.ones(nnz_cap, dtype=acc_dt, device=device)
        if weights is not None:
            coeff = coeff * weights.reshape(-1).to(acc_dt)
        if mode == CombineMode.MEAN:
            hot = (offsets[1:] - offsets[:-1]).to(acc_dt)
            inv_hot = torch.where(hot == 0, torch.zeros_like(hot),
                                  1.0 / hot.clamp(min=1.0))
            coeff = coeff * inv_hot[sample_ids.long()]
        if live is not None:
            coeff = coeff * live.to(acc_dt)

    grad_table = None
    if need_table:
        t_idx, t_sid, t_coeff = dispatch.transpose(
            flat_idx, num_categories, hotness=hotness, sample_ids=sample_ids, coeff=coeff,
            backend=backend)
        # CSR: a calibrated live capacity bounds the work (no result change).
        live_cap = (tiered.csr_live_cap
                    if tiered is not None and offsets is not None
                    and tiered.csr_live_cap > 0 else None)
        grad_table = dispatch.backward(
            grad_rows_in.contiguous(),
            num_categories,
            t_idx,
            t_sid,
            None if t_coeff is None else t_coeff.to(torch.float32),
            nnz=nnz,
            backend=backend,
            accumulation_dtype=acc_dt,
            live_cap=live_cap,
        )

    # --- Gradient w.r.t. weights (an extension beyond the reference) -------
    grad_weights = None
    if weights is not None and need_weights:
        if sample_ids is None:
            sample_ids = fixed_sample_ids(nnz_cap, hotness, device=device)
        safe_idx = flat_idx.clamp(0, num_categories - 1)
        dw = torch.empty(nnz_cap, dtype=acc_dt, device=device)
        for p0 in range(0, nnz_cap, _WEIGHTS_GRAD_SLICE):
            p1 = min(p0 + _WEIGHTS_GRAD_SLICE, nnz_cap)
            rows = table.index_select(0, safe_idx[p0:p1]).to(acc_dt)
            g = grad_rows_in.index_select(0, sample_ids[p0:p1]).to(acc_dt)
            dw[p0:p1] = (rows * g).sum(dim=-1)
        if live is not None:
            dw = dw * live.to(acc_dt)
        grad_weights = dw.reshape(weights.shape).to(weights.dtype)
    return grad_table, grad_weights
