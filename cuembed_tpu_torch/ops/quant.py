"""Per-row int8 tables with inline scales, the counterpart of
``cuembed_tpu/ops/quant.py``.

Layout, byte for byte the JAX package's, so that its int8 data carries
across: ``[rows, width + pad]`` int8, columns ``[0, width)`` the quantized
values, the next 4 bytes the row's fp32 scale (its bytes, little-endian),
then zeros. An int8 head (:func:`quantize_head`) has ``pad = 128``.

Numerics: ``scale = max|row| * fp32(1/127)`` (the JAX function compiled
by XLA, which folds the division by the constant 127 into that product)
and ``q = clip(round(row / scale), -127, 127)`` give an elementwise error
of at most ``scale / 2``, about ``max|row| / 254``; a pooled sum over ``h``
int8 rows errs by at most the sum of their bounds (times the
coefficients). This mode is opt-in, lossy and
serving only: quantizing a tensor that requires a gradient raises, and so
does a backward through the int8 head's lookup (:func:`serving_only_guard`).

The lookups here are plain PyTorch, on the device of their inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cuembed_tpu_torch.types import CombineMode, combine_coefficients, default_device

LANES = 128

_SERVING_ONLY = (
    "int8-quantized lookups are a forward/serving-only mode: the "
    "quantization round is not differentiable and a gradient would "
    "silently zero the quantized rows' table gradient. Train against "
    "the exact path (no q_head), and quantize a detached table."
)

# Rows quantized at a time: bounds the fp32 copy of a large table.
_QUANT_ROWS = 1 << 20
# fp32 elements of the dequantized rows a pooled lookup holds at a time.
_POOL_ELEMS = 1 << 26
_INV_127 = float(np.float32(1.0 / 127.0))


class QuantizedHead(NamedTuple):
    """Int8 rows with inline per-row scales (see the module doc)."""

    data: torch.Tensor  # [rows, width + 128] int8

    @property
    def rows(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1] - LANES

    @classmethod
    def from_numpy(cls, arr, *, device: torch.device | str | None = None) -> "QuantizedHead":
        """Wrap an int8 ``[rows, width + 128]`` array of the JAX package's
        layout (its ``QuantizedHead.data``), on ``device`` (default: the
        card)."""
        arr = np.asarray(arr)
        if arr.dtype != np.int8 or arr.ndim != 2 or arr.shape[1] <= LANES:
            raise ValueError(f"expected [rows, width + {LANES}] int8, got "
                             f"{arr.shape} {arr.dtype}")
        return cls(torch.from_numpy(np.array(arr, order="C")).to(default_device(device)))


def int8_head_rows(width: int, hot_bytes: int) -> int:
    """How many head rows fit ``hot_bytes`` in the int8 layout."""
    return max(8, hot_bytes // (width + LANES)) // 8 * 8


class _ServingOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(_SERVING_ONLY)


def serving_only_guard(x: torch.Tensor) -> torch.Tensor:
    """Identity whose backward raises: a gradient through an int8 lookup
    would drop the quantized rows' part without a word."""
    return _ServingOnly.apply(x)


def _refuse_grad(x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(_SERVING_ONLY)


def quantize_rows(rows: torch.Tensor, pad: int = 4) -> torch.Tensor:
    """Per-row symmetric int8 with the fp32 scale inline:
    ``[m, W]`` -> ``[m, W + pad]`` int8, ``pad >= 4``."""
    if pad < 4:
        raise ValueError("pad must hold the 4-byte f32 scale")
    _refuse_grad(rows)
    m, width = rows.shape
    out = torch.zeros((m, width + pad), dtype=torch.int8, device=rows.device)
    for r0 in range(0, m, _QUANT_ROWS):
        f = rows[r0:r0 + _QUANT_ROWS].to(torch.float32)
        amax = f.abs().amax(dim=1, keepdim=True)
        scale = torch.where(amax == 0, torch.ones_like(amax), amax * _INV_127)
        out[r0:r0 + _QUANT_ROWS, :width] = torch.clamp(
            torch.round(f / scale), -127, 127).to(torch.int8)
        out[r0:r0 + _QUANT_ROWS, width:width + 4] = scale.view(torch.int8)
    return out


def extract_scales(lines: torch.Tensor) -> torch.Tensor:
    """The inline fp32 scale of int8 line(s) ``[..., W + 128]``."""
    w = lines.shape[-1] - LANES
    return lines[..., w:w + 4].contiguous().view(torch.float32).squeeze(-1)


def dequantize_rows(qrows: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: ``[m, W + pad]`` int8 -> ``[m, W]`` fp32."""
    scale = qrows[:, width:width + 4].contiguous().view(torch.float32)
    return qrows[:, :width].to(torch.float32) * scale


def quantize_head(head_slice: torch.Tensor) -> QuantizedHead:
    """Per-row int8 of ``head_slice [rows, W]``, ``W`` a multiple of 128."""
    if head_slice.shape[1] % LANES != 0:
        raise ValueError("int8 head needs width % 128 == 0")
    return QuantizedHead(quantize_rows(head_slice, pad=LANES))


def dequant_rows(qh: QuantizedHead) -> torch.Tensor:
    """The dequantized fp32 rows (for tests and golden models)."""
    return dequantize_rows(qh.data, qh.width)


def pooled_int8(data: torch.Tensor, indices: torch.Tensor, coeff: torch.Tensor,
                width: int) -> torch.Tensor:
    """``out[b] = sum_h coeff[b, h] * scale * q`` over the int8 rows
    ``data[indices[b, h]]``: ``[batch, width]`` fp32, one fp32 batched
    product (no TF32) a slice of samples."""
    from cuembed_tpu_torch.ops.head import fp32_matmul

    b, h = indices.shape
    out = torch.empty((b, width), dtype=torch.float32, device=indices.device)
    step = max(1, _POOL_ELEMS // max(1, h * width))
    for s0 in range(0, b, step):
        ids = indices[s0:s0 + step]
        lines = data.index_select(0, ids.reshape(-1)).view(*ids.shape, -1)
        c = coeff[s0:s0 + step].to(torch.float32) * extract_scales(lines)
        out[s0:s0 + step] = fp32_matmul(c[:, None, :],
                                        lines[..., :width].to(torch.float32)).squeeze(1)
    return out


def int8_serving_lookup(
    qtable: QuantizedHead,
    indices: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    mode: CombineMode = CombineMode.SUM,
) -> torch.Tensor:
    """Pooled fp32 lookup against a wholly int8 table (``quantize_head`` of
    the whole table): ``[batch, hotness]`` indices, SUM / MEAN / weighted
    SUM. Each position's row is its int8 values times its scale times its
    coefficient (:func:`pooled_int8`). Within the module doc's bound of
    the exact lookup."""
    b, h = indices.shape
    coeff = combine_coefficients(weights, mode, b, h, device=indices.device).view(b, h)
    return pooled_int8(qtable.data, indices, coeff, qtable.width)
