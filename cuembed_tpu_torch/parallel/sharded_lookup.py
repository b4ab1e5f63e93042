"""Sharded embedding lookup over a device mesh, the counterpart of
``cuembed_tpu/parallel/sharded_lookup.py``.

* **Row sharding** (default): each model rank owns a contiguous row range
  of the table. Lookup indices are replicated across the model axis (they
  are sharded over the data axis); each rank gathers only the rows it owns
  (a masked local lookup, K1 or K2 on the card, with coefficient 0 for
  foreign rows), and the pooled partials are summed with one all-reduce
  over ``model``. Each table row is read once, where it lives; the only
  communication is ``[local_batch, width]`` a rank.

* **Column sharding**: each rank holds a ``width / n`` column slice of
  every row; lookups are fully local (K1 or K2) and the output stays
  feature-sharded, or is all-gathered back to full width.

Both are differentiable: the local lookup's backward is the port's COO
backward (K3), and the collectives carry ``shard_map``'s gradients
(:mod:`~cuembed_tpu_torch.parallel.collectives`), so a table shard gets the
block of the single-device gradient that it owns.

Every tensor argument is the calling rank's block under the JAX function's
``in_specs`` (:func:`~cuembed_tpu_torch.parallel.sharding.local_block`), and
the result is the rank's block under its ``out_specs``; each docstring
names them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from cuembed_tpu_torch.ops.api import embedding_lookup, embedding_lookup_csr
from cuembed_tpu_torch.ops.transforms import extract_row_ids_from_csr
from cuembed_tpu_torch.parallel.collectives import all_gather, psum, replicated
from cuembed_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_index,
)
from cuembed_tpu_torch.types import CombineMode


def row_sharded_lookup(
    table: torch.Tensor,
    indices: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    *,
    mesh: DeviceMesh,
    mode: CombineMode = CombineMode.SUM,
    backend: str = "auto",
    tiered_cfg=None,
    data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS,
) -> torch.Tensor:
    """Lookup against a row-sharded table.

    Args:
      table: this rank's ``[num_categories / n_model, width]`` row block
        (spec ``(model, None)``; pad the global rows to a multiple of the
        model axis with :func:`pad_table_for_shards`).
      indices: ``[batch / n_data, hotness]`` (spec ``(data, None)``); or a
        flat CSR ``[capacity]`` with ``offsets [batch + 1]``, replicated;
        or a sharded-CSR block ``[1, cap]`` with offsets ``[1, local_batch
        + 1]`` (spec ``(data, None)``; see :func:`shard_csr`).
      weights/offsets/mode: as in :func:`embedding_lookup`, each like the
        indices.
      tiered_cfg: an optional config for the local shard lookup (in
        local-slice row units); it changes no result on the card.

    Returns:
      The pooled ``[batch / n_data, width]`` block (``[batch / n_data *
      hotness, width]`` for CONCAT), spec ``(data, None)``; ``[1,
      local_batch, width]`` for sharded CSR, spec ``(data, None, None)``;
      ``[batch, width]`` replicated for flat CSR.
    """
    if mode == CombineMode.CONCAT:
        if weights is not None:
            raise ValueError("weights are only supported with CombineMode.SUM")
        if offsets is not None:
            raise ValueError("CSR does not support CONCAT")
    rows_per = table.shape[0]
    model_group = axis_group(mesh, model_axis)

    # The sharded-CSR layout (2D [1, cap] blocks from shard_csr) shards over
    # data like fixed-hotness batches; a flat (1D) CSR batch is replicated
    # across data, and so is its result.
    sharded_csr = offsets is not None and offsets.dim() == 2
    if sharded_csr:
        indices = indices.reshape(-1)
        offsets = offsets.reshape(-1)
        if weights is not None:
            weights = weights.reshape(-1)
    if offsets is None or sharded_csr:
        # The result is sharded over data while the shard is replicated
        # there: its gradient sums over data.
        table = replicated(table, axis_group(mesh, data_axis))

    lo = axis_index(mesh, model_axis) * rows_per
    owned = (indices >= lo) & (indices < lo + rows_per)
    local_idx = torch.where(owned, indices - lo, torch.zeros_like(indices))

    if mode == CombineMode.CONCAT:
        rows = embedding_lookup(table, local_idx, mode=CombineMode.CONCAT,
                                backend=backend)
        partial_out = rows * owned.reshape(-1, 1).to(rows.dtype)
    else:
        coeff = owned.to(torch.float32)
        if weights is not None:
            # The weights are replicated over model and each rank's partial
            # holds only its rows' terms: their gradient sums over model.
            coeff = coeff * replicated(weights, model_group).to(torch.float32)
        if mode == CombineMode.MEAN:
            if offsets is None:
                coeff = coeff / indices.shape[-1]
            else:
                counts = (offsets[1:] - offsets[:-1]).to(torch.float32)
                inv = torch.where(counts == 0, torch.zeros_like(counts),
                                  1.0 / counts.clamp(min=1.0))
                sample = extract_row_ids_from_csr(offsets, indices)
                coeff = coeff * inv[sample.long()]
        if offsets is not None:
            partial_out = embedding_lookup_csr(
                table, local_idx, offsets, coeff, mode=CombineMode.SUM,
                backend=backend, tiered_cfg=tiered_cfg)
        else:
            partial_out = embedding_lookup(
                table, local_idx, coeff, mode=CombineMode.SUM,
                backend=backend, tiered_cfg=tiered_cfg)
    out = psum(partial_out, model_group)
    return out[None] if sharded_csr else out


def column_sharded_lookup(
    table: torch.Tensor,
    indices: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    *,
    mesh: DeviceMesh,
    mode: CombineMode = CombineMode.SUM,
    backend: str = "auto",
    gather_output: bool = True,
    data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS,
) -> torch.Tensor:
    """Lookup against a column-sharded table.

    ``table`` is this rank's ``[num_categories, width / n_model]`` column
    block (spec ``(None, model)``); ``indices``/``weights`` are the
    ``[batch / n_data, hotness]`` block (spec ``(data, None)``), or a flat
    CSR batch with ``offsets``, replicated. Every rank performs the full
    lookup on its width slice; the result is this rank's ``(data, model)``
    block ``[batch / n_data, width / n_model]``, or with ``gather_output``
    the all-gathered ``(data, None)`` block ``[batch / n_data, width]``
    (the batch is whole for CSR).
    """
    model_group = axis_group(mesh, model_axis)
    if offsets is None:
        table = replicated(table, axis_group(mesh, data_axis))
    if weights is not None:
        weights = replicated(weights, model_group)
    if offsets is not None:
        out = embedding_lookup_csr(table, indices, offsets, weights, mode=mode,
                                   backend=backend)
    else:
        out = embedding_lookup(table, indices, weights, mode=mode, backend=backend)
    if gather_output:
        out = all_gather(out, model_group, dim=1)
    return out
