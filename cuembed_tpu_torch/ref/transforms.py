"""Golden-model index transforms (pure numpy).

A copy of ``cuembed_tpu/ref/transforms.py`` (numpy only): the same inputs give the
same bits. Mirrors ``utils/include/index_transforms_cpu.hpp:35-125``:

* row-id (COO sample-id) extraction for fixed / CSR / concat layouts,
* ``transpose``: sort the COO by lookup index (stable over (idx, sid, w)
  tuples, ``index_transforms_cpu.hpp:104-115``),
* compressed-gradient remapping: dense 0..num_unique-1 ids over the sorted
  index array (``index_transforms.cuh:252-323``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def extract_row_ids_from_fixed_ref(batch: int, hotness: int, dtype=np.int32):
    """``row_ids[i] = i // hotness`` (reference ``index_transforms.cuh:46-55``)."""
    return (np.arange(batch * hotness) // hotness).astype(dtype)


def extract_row_ids_from_csr_ref(offsets: np.ndarray, dtype=np.int32):
    """Expand CSR offsets to per-nonzero sample ids (``index_transforms.cuh:67-74``)."""
    offsets = np.asarray(offsets)
    batch = offsets.shape[0] - 1
    nnz = int(offsets[-1])
    out = np.zeros((nnz,), dtype=dtype)
    for b in range(batch):
        out[int(offsets[b]) : int(offsets[b + 1])] = b
    return out


def extract_row_ids_for_concat_ref(nnz: int, dtype=np.int32):
    """Identity sequence — concat's grad_y has one row per nonzero
    (``index_transforms.cuh:86-93``)."""
    return np.arange(nnz, dtype=dtype)


def transpose_ref(
    sample_ids: np.ndarray,
    indices: np.ndarray,
    weights: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Sort the COO by lookup index.

    Stable sort over (index, sample_id, weight) tuples, matching
    ``TransposeCpu`` (``index_transforms_cpu.hpp:104-115``). Returns
    ``(transpose_indices, transpose_sample_ids, transpose_weights)``.
    """
    indices = np.asarray(indices)
    sample_ids = np.asarray(sample_ids)
    if weights is None:
        order = np.lexsort((sample_ids, indices))
        return indices[order], sample_ids[order], None
    order = np.lexsort((np.asarray(weights), sample_ids, indices))
    return indices[order], sample_ids[order], np.asarray(weights)[order]


def compute_compressed_grad_indices_ref(sorted_indices: np.ndarray) -> np.ndarray:
    """Dense remapped ids over a sorted index array.

    ``remapped[i] = inclusive_scan(sorted[i] != sorted[i-1])`` with
    ``remapped[0] = 0`` (reference ``index_transforms.cuh:278-323``).
    """
    sorted_indices = np.asarray(sorted_indices)
    nnz = sorted_indices.shape[0]
    out = np.zeros((nnz,), dtype=sorted_indices.dtype)
    for i in range(1, nnz):
        out[i] = out[i - 1] + (1 if sorted_indices[i] != sorted_indices[i - 1] else 0)
    return out
