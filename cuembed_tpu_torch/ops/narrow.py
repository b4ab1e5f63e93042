"""Line-packed storage for narrow tables, the counterpart of
``cuembed_tpu/ops/narrow.py``.

The TPU pads every array to 128 lanes, so the JAX package stores a narrow
``[V, W]`` table (``128 % W == 0``) as ``k = 128 // W`` logical rows per
line, ``[ceil(V/k), k*W]``. That layout is a pad and a reshape: its
row-major bytes are exactly those of a ``[ceil(V/k)*k, W]`` table. An H100
has no lanes to fill, so the port keeps the layout (data carries across
unchanged) and looks up through that ``[ceil(V/k)*k, W]`` view of the same
storage, with no copy: K1 or K2 for CUDA tensors, the plain version for
CPU ones, ``index_select`` for CONCAT.
"""

from __future__ import annotations

import torch

from cuembed_tpu_torch.types import CombineMode

# The TPU line the layout packs rows into; it defines the layout.
LANES = 128


def packing_factor(width: int) -> int:
    """Logical rows per 128-lane line (1: packing is a no-op)."""
    if width >= LANES or LANES % width != 0:
        return 1
    return LANES // width


def pack_narrow(table: torch.Tensor) -> torch.Tensor:
    """``[V, W]`` -> ``[ceil(V/k), k*W]`` with k rows per line (zero rows
    pad the last line)."""
    v, w = table.shape
    k = packing_factor(w)
    if k == 1:
        return table
    pad = (-v) % k
    if pad:
        table = torch.cat([table, table.new_zeros((pad, w))])
    return table.reshape(-1, k * w)


def unpack_narrow(packed: torch.Tensor, num_categories: int, width: int) -> torch.Tensor:
    """Inverse of :func:`pack_narrow` (a view of ``packed``)."""
    if packing_factor(width) == 1:
        return packed
    return packed.reshape(-1, width)[:num_categories]


def logical_view(packed: torch.Tensor, width: int) -> torch.Tensor:
    """The packed table as ``[ceil(V/k)*k, width]`` logical rows: a view of
    the same storage."""
    if packing_factor(width) == 1:
        return packed
    return packed.view(-1, width)


def _tiers(tiered_cfg, indices, offsets, mode):
    """The config the JAX package would tier this call with, or None:
    fixed hotness, pooled, with an MXU head (else its plain packed gather)."""
    if (tiered_cfg is None or offsets is not None or mode == CombineMode.CONCAT
            or tiered_cfg.mxu_head_rows <= 0):
        return None
    from cuembed_tpu_torch.ops.tiered import check_chunking

    check_chunking(tiered_cfg, indices.shape[1])
    return tiered_cfg


def narrow_lookup(
    packed: torch.Tensor,
    num_categories: int,
    width: int,
    indices: torch.Tensor,
    weights: torch.Tensor | None = None,
    offsets: torch.Tensor | None = None,
    *,
    mode: CombineMode = CombineMode.SUM,
    low_precision_math: bool = False,
    tiered_cfg=None,
) -> torch.Tensor:
    """Pooled (or CONCAT) lookup against a line-packed narrow table, with
    the contract of :func:`~cuembed_tpu_torch.ops.api.embedding_lookup` /
    ``_csr``, differentiable with respect to ``packed`` and ``weights``.

    ``tiered_cfg`` (logical-row units) applies where the JAX package tiers:
    fixed hotness, SUM or MEAN, ``mxu_head_rows > 0``; there it keeps the
    JAX engine's errors. It changes no result: the forward runs on K1 or K2
    over the view, the backward on K3 over the whole COO.
    """
    from cuembed_tpu_torch.ops import api

    if weights is not None and mode != CombineMode.SUM:
        raise ValueError("weights are only supported with CombineMode.SUM")
    cfg = _tiers(tiered_cfg, indices, offsets, mode)
    view = logical_view(packed, width)
    api._validate(view, indices, offsets, weights, mode)
    return api._lookup(view, indices, offsets, weights, mode, low_precision_math,
                       "pallas", cfg)
