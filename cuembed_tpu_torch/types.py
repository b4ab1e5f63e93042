"""Core types of the PyTorch/CUDA port.

The counterpart of ``cuembed_tpu/types.py``: the ``CombineMode`` enum, the
storage dtypes, the accumulation-precision policy, the index formats and the
combine coefficients. Unlike the TPU package, int64 indices are not narrowed
to int32: the GPU kernels take both index types natively.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class CombineMode(enum.Enum):
    """How gathered embedding rows are combined per sample.

    * ``SUM``    — (optionally weighted) sum of the sample's rows.
    * ``MEAN``   — unweighted mean; a zero-hotness sample produces zeros.
    * ``CONCAT`` — rows are emitted unreduced, one output row per lookup.
      Fixed-hotness only; weighted concat is not supported.
    """

    SUM = "sum"
    MEAN = "mean"
    CONCAT = "concat"


# Dtypes supported for embedding-table storage.
STORAGE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# Dtypes supported for lookup indices and CSR offsets.
INDEX_DTYPES = (torch.int32, torch.int64)


def accumulation_dtype(
    storage_dtype: torch.dtype, low_precision_math: bool = False
) -> torch.dtype:
    """Pick the reduction dtype for a given storage dtype.

    Half-precision rows reduce in fp32 unless the caller opts into
    native-precision math (the reference's ``fp16_math=true``). A float64
    table (the plain version only, for gradient checks) reduces in float64.
    """
    if storage_dtype == torch.float64:
        return torch.float64
    if storage_dtype == torch.float32 or not low_precision_math:
        return torch.float32
    return storage_dtype


def default_device(device: torch.device | str | None) -> torch.device:
    """``device``, or the CUDA device when none is given. Without a card an
    explicit device is required: nothing falls back to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to build on the CPU"
        )
    return torch.device("cuda")


def init_table_(
    table: torch.Tensor,
    generator: torch.Generator | None = None,
    width: int | None = None,
) -> torch.Tensor:
    """Fill ``table`` in place with U(-1/sqrt(W), 1/sqrt(W)) draws from
    ``generator`` and return it: the JAX package's table init law (not its
    draws). ``W`` is ``width``, default the table's last dimension."""
    scale = 1.0 / (width or table.shape[-1]) ** 0.5
    return table.uniform_(-scale, scale, generator=generator)


def check_index_dtype(dtype: torch.dtype) -> torch.dtype:
    """Return ``dtype`` if indices of that dtype are supported, else raise."""
    if dtype not in INDEX_DTYPES:
        raise ValueError(f"unsupported index dtype: {dtype}")
    return dtype


def canonical_index_dtype(indices, num_categories: int | None = None) -> torch.dtype:
    """The dtype lookups run in for ``indices`` (a tensor, an array, or a
    torch or numpy dtype or its name): int32 stays int32 and int64 stays
    int64, since the kernels take both. The JAX package narrows int64 to
    int32 for tables under 2**31 rows, its TPU being 32-bit-native;
    ``num_categories`` is taken for that signature and changes nothing
    here."""
    del num_categories
    if isinstance(indices, (torch.dtype, torch.Tensor)):
        dt = getattr(indices, "dtype", indices)
    else:
        try:
            dt = np.dtype(indices)  # dtype-like: np.int32, "int64"
        except TypeError:
            dt = np.dtype(indices.dtype)  # array-like
        dt = {np.int32: torch.int32, np.int64: torch.int64}.get(dt.type, dt)
    if dt not in INDEX_DTYPES:
        raise ValueError(f"unsupported index dtype: {dt}")
    return dt


@dataclass(frozen=True)
class FixedFormat:
    """Fixed-hotness index layout: ``indices`` has shape ``[batch, hotness]``."""

    hotness: int

    def __post_init__(self):
        if self.hotness <= 0:
            raise ValueError("fixed-hotness format requires hotness > 0")


@dataclass(frozen=True)
class CSRFormat:
    """CSR (variable-hotness) layout: flat ``indices[capacity]`` + ``offsets[batch+1]``.

    ``offsets[i]:offsets[i+1]`` delimits sample ``i``'s lookups. Positions at
    or beyond ``offsets[-1]`` are padding and contribute nothing.
    """

    capacity: int

    def __post_init__(self):
        if self.capacity < 0:
            raise ValueError("capacity must be >= 0")


def combine_coefficients(
    weights: torch.Tensor | None,
    mode: CombineMode,
    batch: int,
    hotness: int,
    *,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Flat ``[batch*hotness]`` fp32 combine coefficients for pooled lookups:
    weights (SUM only) or ones, with MEAN's 1/hotness folded in.

    The ones are made on ``device``, which is required when ``weights`` is
    None; otherwise the result lies on the weights' device.
    """
    if mode == CombineMode.CONCAT:
        raise ValueError("pooled combine; CONCAT has no coefficients")
    if weights is not None and mode != CombineMode.SUM:
        raise ValueError("weights are only supported with CombineMode.SUM")
    if weights is not None:
        coeff = weights.reshape(-1).to(torch.float32)
    elif device is None:
        raise ValueError("combine_coefficients without weights needs a device")
    else:
        coeff = torch.ones(batch * hotness, dtype=torch.float32, device=device)
    if mode == CombineMode.MEAN:
        coeff = coeff / max(hotness, 1)
    return coeff
