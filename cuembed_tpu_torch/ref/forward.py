"""Golden-model forward lookup (pure numpy, scalar semantics).

A copy of ``cuembed_tpu/ref/forward.py`` that imports nothing of the JAX
package: the same inputs give the same bits. Mirrors the behavior of the reference CPU model ``EmbeddingForwardCpu``
(``utils/include/embedding_lookup_cpu.hpp:35-94``):

* fixed-hotness (``offsets is None``) or CSR (``offsets`` given, no hotness),
* SUM / MEAN / CONCAT combine; weights only with SUM; CSR never CONCAT,
* accumulation in fp32 unless ``low_precision_math`` and storage is half,
* MEAN of a zero-hotness sample is exactly zero,
* sequential accumulation over the hotness dimension (the parity order).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cuembed_tpu_torch.types import CombineMode


def accumulation_dtype(storage_dtype, low_precision_math: bool = False) -> np.dtype:
    """The numpy reduction dtype for a storage dtype: fp32, or the storage
    dtype itself for half tables under ``low_precision_math`` (the JAX
    package's rule, on numpy dtypes)."""
    storage_dtype = np.dtype(storage_dtype)
    if storage_dtype == np.float32 or not low_precision_math:
        return np.dtype(np.float32)
    return storage_dtype


def embedding_forward_ref(
    table: np.ndarray,
    indices: np.ndarray,
    *,
    offsets: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    mode: CombineMode = CombineMode.SUM,
    low_precision_math: bool = False,
) -> np.ndarray:
    """Reference forward embedding lookup.

    Args:
      table: ``[num_categories, width]`` embedding table.
      indices: fixed-hotness ``[batch, hotness]`` or flat CSR ``[nnz]``.
      offsets: CSR offsets ``[batch + 1]`` (None => fixed-hotness).
      weights: per-lookup weights, same shape as ``indices`` (SUM only).
      mode: combine mode.
      low_precision_math: accumulate in storage precision for half tables.

    Returns:
      ``[batch, width]`` for SUM/MEAN, ``[batch * hotness, width]`` for CONCAT.
    """
    table = np.asarray(table)
    indices = np.asarray(indices)
    width = table.shape[1]

    if weights is not None and mode != CombineMode.SUM:
        raise ValueError("weights are only supported with CombineMode.SUM")
    if offsets is not None:
        if indices.ndim != 1:
            raise ValueError("CSR indices must be flat [nnz]")
        if mode == CombineMode.CONCAT:
            raise ValueError("CSR does not support CONCAT")
        batch = offsets.shape[0] - 1
    else:
        if indices.ndim != 2:
            raise ValueError("fixed-hotness indices must be [batch, hotness]")
        batch, hotness = indices.shape

    acc_dtype = np.dtype(accumulation_dtype(table.dtype, low_precision_math))

    if mode == CombineMode.CONCAT:
        out = np.zeros((batch * hotness, width), dtype=table.dtype)
        for i in range(batch):
            for j in range(hotness):
                out[i * hotness + j, :] = table[indices[i, j], :]
        return out

    out = np.zeros((batch, width), dtype=table.dtype)
    for i in range(batch):
        if offsets is not None:
            start, end = int(offsets[i]), int(offsets[i + 1])
            sample_idx = indices[start:end]
            sample_w = weights[start:end] if weights is not None else None
        else:
            sample_idx = indices[i]
            sample_w = weights[i] if weights is not None else None
        hot = sample_idx.shape[0]
        acc = np.zeros((width,), dtype=acc_dtype)
        # Sequential accumulation over hotness — the same order as the
        # reference CPU model's inner loop (embedding_lookup_cpu.hpp:66-77).
        for j in range(hot):
            row = table[sample_idx[j], :].astype(acc_dtype)
            if sample_w is not None:
                row = row * acc_dtype.type(sample_w[j])
            acc = acc + row
        if mode == CombineMode.MEAN:
            if hot == 0:
                acc = acc * acc_dtype.type(0.0)
            else:
                acc = acc * acc_dtype.type(1.0 / hot)
        out[i, :] = acc.astype(table.dtype)
    return out
