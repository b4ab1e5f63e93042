"""Golden-model backward pass (pure numpy, scalar semantics).

A copy of ``cuembed_tpu/ref/backward.py`` (numpy only): the same inputs give the
same bits. Mirrors ``EmbeddingBackwardCpu`` (``utils/include/embedding_lookup_cpu.hpp:96-144``):
given the transposed (index-sorted) COO triple, scatter-accumulate
``grad_y`` rows into the gradient table.

* full gradient: rows indexed by the original lookup index,
* compressed gradient: rows indexed by the dense remapped id
  (0..num_unique-1), plus an ``inverse_mapping`` from remapped id back to
  the original index (first occurrence per run,
  ``embedding_lookup_cpu.hpp:110-123``),
* ``skip_grad_init``: caller guarantees ``grad_out`` starts zeroed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def embedding_backward_ref(
    grad_y: np.ndarray,
    num_grad_rows: int,
    transpose_indices: np.ndarray,
    transpose_sample_ids: np.ndarray,
    *,
    transpose_remapped_indices: Optional[np.ndarray] = None,
    transpose_weights: Optional[np.ndarray] = None,
    skip_grad_init: bool = False,
    grad_out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Reference backward scatter-accumulate.

    Args:
      grad_y: ``[batch (or nnz for concat), width]`` upstream gradient.
      num_grad_rows: rows in the output gradient (num_categories for full,
        num_unique for compressed).
      transpose_indices: ``[nnz]`` lookup indices sorted ascending.
      transpose_sample_ids: ``[nnz]`` row of grad_y for each nonzero.
      transpose_remapped_indices: optional ``[nnz]`` dense 0..num_unique-1 ids
        (compressed-gradient path).
      transpose_weights: optional ``[nnz]`` per-lookup weights.
      skip_grad_init: if True, accumulate into ``grad_out`` as-is.
      grad_out: optional pre-allocated output (required if skip_grad_init).

    Returns:
      ``(grad_embedding [num_grad_rows, width], inverse_mapping or None)``.
    """
    grad_y = np.asarray(grad_y)
    width = grad_y.shape[1]
    nnz = transpose_indices.shape[0]

    if grad_out is None:
        grad_out = np.zeros((num_grad_rows, width), dtype=grad_y.dtype)
    elif not skip_grad_init:
        grad_out[:] = 0

    inverse_mapping = None
    if transpose_remapped_indices is not None and nnz > 0:
        num_unique = int(transpose_remapped_indices[-1]) + 1
        inverse_mapping = np.zeros((num_unique,), dtype=transpose_indices.dtype)
        inverse_mapping[0] = transpose_indices[0]
        cnt = 1
        for i in range(1, nnz):
            if transpose_remapped_indices[i - 1] != transpose_remapped_indices[i]:
                inverse_mapping[cnt] = transpose_indices[i]
                cnt += 1

    for nz in range(nnz):
        row = (
            int(transpose_remapped_indices[nz])
            if transpose_remapped_indices is not None
            else int(transpose_indices[nz])
        )
        sid = int(transpose_sample_ids[nz])
        w = (
            grad_y.dtype.type(transpose_weights[nz])
            if transpose_weights is not None
            else grad_y.dtype.type(1.0)
        )
        grad_out[row, :] += grad_y[sid, :] * w
    return grad_out, inverse_mapping
