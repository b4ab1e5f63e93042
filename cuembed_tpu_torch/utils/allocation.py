"""Workload descriptor + full problem-instance construction, a copy of
``cuembed_tpu/utils/allocation.py`` that imports nothing of the JAX
package: the same options give the same arrays.

The analog of the reference's ``utils::AllocationOptions`` fluent builder
(``utils/include/embedding_allocation.h:47-101``) and ``AllocateHost``
(``utils/src/embedding_allocation.cu:96-388``), shared by tests and the
benchmark harness. Distribution choices mirror the reference:

* embedding table ~ U(-1, 1), seed 123456 (``embedding_allocation.cu:113-116``),
* CSR per-sample hotness ~ U{0..hotness} (``:130-135``),
* lookup indices ~ power-law, per-sample distinct (``:139-158``),
* weights ∈ {0.5, 0.25} Bernoulli — exactly representable so weighted sums
  stay friendly to tight tolerances (``:160-168``),
* grad_y ~ integer U{-10..10}, seed 654321 — integer-valued so fp32
  accumulation is exact and parity checks can be bitwise (``:234-237``).

Every array is host numpy, as in the JAX package; callers move them to
torch on a device they name.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from cuembed_tpu_torch.ref.transforms import (
    compute_compressed_grad_indices_ref,
    extract_row_ids_for_concat_ref,
    extract_row_ids_from_csr_ref,
    extract_row_ids_from_fixed_ref,
    transpose_ref,
)
from cuembed_tpu_torch.types import CombineMode
from cuembed_tpu_torch.utils.datagen import PowerLawGenerator

EMBEDDING_SEED = 123456
GRAD_SEED = 654321


@dataclass(frozen=True)
class AllocationOptions:
    """Workload descriptor (the reference's fluent builder, as a dataclass)."""

    num_categories: int = 1024
    batch_size: int = 32
    hotness: int = 1
    alpha: float = 0.0
    embed_width: int = 16
    combine_mode: CombineMode = CombineMode.SUM
    is_csr: bool = False
    is_weighted: bool = False
    compressed_grad: bool = False
    skip_grad_init: bool = False
    shuffle_indices: bool = False
    permute_indices: bool = False
    embed_dtype: np.dtype = field(default_factory=lambda: np.dtype(np.float32))
    index_dtype: np.dtype = field(default_factory=lambda: np.dtype(np.int32))
    offset_dtype: np.dtype = field(default_factory=lambda: np.dtype(np.int32))

    def with_(self, **kwargs) -> "AllocationOptions":
        """Fluent-style copy-update, e.g. ``opts.with_(is_csr=True)``."""
        return replace(self, **kwargs)


@dataclass
class Allocation:
    """A fully materialized problem instance (numpy host arrays).

    The analog of ``UniversalEmbeddingAllocation``
    (``utils/include/embedding_allocation.h:103-147``).
    """

    options: AllocationOptions
    table: np.ndarray  # [num_categories, width]
    indices: np.ndarray  # fixed: [batch, hotness]; CSR: flat [nnz]
    offsets: Optional[np.ndarray]  # [batch + 1] (CSR only)
    weights: Optional[np.ndarray]  # same shape as indices (weighted only)
    # Backward-side arrays (None when forward_only):
    sample_ids: Optional[np.ndarray] = None  # [nnz] COO row ids
    transpose_indices: Optional[np.ndarray] = None  # [nnz] sorted
    transpose_sample_ids: Optional[np.ndarray] = None  # [nnz]
    transpose_weights: Optional[np.ndarray] = None  # [nnz]
    transpose_remapped_indices: Optional[np.ndarray] = None  # [nnz]
    grad_y: Optional[np.ndarray] = None  # [batch or nnz, width]
    num_unique: Optional[int] = None

    @property
    def nnz(self) -> int:
        if self.options.is_csr:
            return int(self.offsets[-1])
        return self.indices.shape[0] * self.indices.shape[1]

    @property
    def flat_indices(self) -> np.ndarray:
        return self.indices if self.options.is_csr else self.indices.reshape(-1)


def allocate(options: AllocationOptions, *, forward_only: bool = False) -> Allocation:
    """Build a full problem instance mirroring ``AllocateHost``."""
    o = options
    if o.is_weighted and o.combine_mode != CombineMode.SUM:
        raise ValueError("weights only supported with SUM")
    if o.is_csr and o.combine_mode == CombineMode.CONCAT:
        raise ValueError("CSR does not support CONCAT")

    rng = np.random.default_rng(EMBEDDING_SEED)
    table = rng.uniform(-1.0, 1.0, size=(o.num_categories, o.embed_width)).astype(
        o.embed_dtype
    )

    # Power-law indices; the generator reserves id 0, drawing from
    # [1, num_categories - 1] like the reference, which passes
    # num_categories - 1 to the generator (embedding_allocation.cu:139-144).
    gen = PowerLawGenerator(
        o.num_categories - 1,
        o.hotness,
        o.alpha,
        shuffle=o.shuffle_indices,
        permute=o.permute_indices,
        seed=EMBEDDING_SEED,
        dtype=o.index_dtype,
    )
    dense_indices = gen.sample(o.batch_size)  # [batch, hotness]

    offsets = None
    weights = None
    if o.is_csr:
        # Per-sample hotness ~ U{0..hotness} (embedding_allocation.cu:130-135).
        per_sample = rng.integers(0, o.hotness + 1, size=o.batch_size)
        offsets = np.zeros((o.batch_size + 1,), dtype=o.offset_dtype)
        offsets[1:] = np.cumsum(per_sample)
        mask = (
            np.arange(o.hotness)[None, :] < per_sample[:, None]
        )  # first h_i of each row
        indices = dense_indices[mask].astype(o.index_dtype)
    else:
        indices = dense_indices

    if o.is_weighted:
        # Weights ∈ {0.5, 0.25}: exactly representable in every storage dtype
        # (embedding_allocation.cu:160-168).
        w = np.where(rng.random(indices.size) < 0.5, 0.5, 0.25)
        weights = w.reshape(indices.shape).astype(o.embed_dtype)

    alloc = Allocation(
        options=o, table=table, indices=indices, offsets=offsets, weights=weights
    )
    if forward_only:
        return alloc

    # --- Backward-side arrays (transpose pipeline, reference §3.2) ---
    flat_idx = alloc.flat_indices
    nnz = flat_idx.shape[0]
    if o.combine_mode == CombineMode.CONCAT:
        sample_ids = extract_row_ids_for_concat_ref(nnz, o.index_dtype)
    elif o.is_csr:
        sample_ids = extract_row_ids_from_csr_ref(offsets, o.index_dtype)
    else:
        sample_ids = extract_row_ids_from_fixed_ref(
            o.batch_size, o.hotness, o.index_dtype
        )

    flat_w = weights.reshape(-1).astype(np.float32) if weights is not None else None
    t_idx, t_sid, t_w = transpose_ref(sample_ids, flat_idx, flat_w)
    t_remap = compute_compressed_grad_indices_ref(t_idx) if o.compressed_grad else None
    num_unique = int(np.unique(flat_idx).size) if nnz > 0 else 0

    grad_rng = np.random.default_rng(GRAD_SEED)
    grad_rows = (
        o.batch_size * o.hotness
        if o.combine_mode == CombineMode.CONCAT
        else o.batch_size
    )
    grad_y = grad_rng.integers(
        -10, 11, size=(grad_rows, o.embed_width)
    ).astype(o.embed_dtype)

    alloc.sample_ids = sample_ids
    alloc.transpose_indices = t_idx
    alloc.transpose_sample_ids = t_sid
    alloc.transpose_weights = t_w
    alloc.transpose_remapped_indices = t_remap
    alloc.grad_y = grad_y
    alloc.num_unique = num_unique
    return alloc
