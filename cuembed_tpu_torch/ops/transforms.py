"""Index transforms, the counterpart of ``cuembed_tpu/ops/transforms.py``:
row-id extraction, the COO transpose (a stable sort by index, tie-broken on
sample id) and the compressed-gradient remapping; and the CSR densifier
``csr_to_fixed`` (``cuembed_tpu/ops/pallas_forward.py``). These are plain
PyTorch: ``torch.sort`` is their sort. On the card the update's and the
backward's transpose is K5 (``ops/cuda_transforms.py``, routed by
``dispatch.transpose``), whose plain version is
:func:`transpose_position_ordered`.
"""

from __future__ import annotations

import torch

from cuembed_tpu_torch.types import CombineMode


def fixed_sample_ids(
    n: int,
    hotness: int,
    dtype: torch.dtype = torch.int32,
    *,
    device: torch.device | str,
) -> torch.Tensor:
    """The sample ids of a fixed-hotness lookup's first ``n`` flattened
    positions: ``position // hotness`` (hotness 1 for CONCAT, whose grad_y
    has a row a position). K5 computes the same in its last pass."""
    return torch.arange(n, dtype=dtype, device=device) // hotness


def extract_row_ids_from_fixed(
    batch: int,
    hotness: int,
    dtype: torch.dtype = torch.int32,
    *,
    device: torch.device | str,
) -> torch.Tensor:
    """``row_ids[i] = i // hotness``."""
    return fixed_sample_ids(batch * hotness, hotness, dtype, device=device)


def extract_row_ids_from_csr(offsets: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Per-position sample ids from CSR offsets.

    For position p, the sample i with ``offsets[i] <= p < offsets[i+1]``.
    ``indices`` is only used for its length (the capacity) and dtype;
    positions past ``offsets[-1]`` are clamped into the last sample and must
    be masked by callers.
    """
    nnz = indices.shape[0]
    batch = offsets.shape[0] - 1
    # The number of sample boundaries offsets[1..batch-1] at or before p.
    bounds = offsets[1:batch].contiguous()
    pos = torch.arange(nnz, dtype=bounds.dtype, device=indices.device)
    return torch.searchsorted(bounds, pos, right=True).to(indices.dtype)


def extract_row_ids_for_concat(
    nnz: int, dtype: torch.dtype = torch.int32, *, device: torch.device | str
) -> torch.Tensor:
    """Identity sequence."""
    return fixed_sample_ids(nnz, 1, dtype, device=device)


def _permute(order, sample_ids, indices, weights):
    return (indices[order], sample_ids[order],
            None if weights is None else weights[order])


def transpose(
    sample_ids: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor | None = None,
):
    """Sort the COO by lookup index, ties broken by sample id (the JAX
    two-key ``lax.sort``), for any sample ids. Weights ride along.

    Returns ``(transpose_indices, transpose_sample_ids, transpose_weights)``.
    """
    order = torch.sort(sample_ids, stable=True).indices
    order = order[torch.sort(indices[order], stable=True).indices]
    return _permute(order, sample_ids, indices, weights)


def transpose_position_ordered(
    sample_ids: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor | None = None,
):
    """:func:`transpose` for sample ids that do not decrease with the
    position (every COO the lookup builds: fixed, CONCAT and CSR): one
    stable sort by index then keeps equal indices in sample-id order."""
    order = torch.sort(indices, stable=True).indices
    return _permute(order, sample_ids, indices, weights)


def transpose_masked_compact(
    sample_ids: torch.Tensor,
    masked_idx: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    chunk_elems: int = 2048,
    nonhead_slots: int = 0,
):
    """Index-sort a sentinel-masked COO. Its contract is equality with
    :func:`transpose` on every non-sentinel entry, which ``transpose`` meets
    on all of them; the TPU's per-chunk compaction (``chunk_elems``,
    ``nonhead_slots``) is not needed here."""
    del chunk_elems, nonhead_slots
    return transpose(sample_ids, masked_idx, weights)


def compute_compressed_grad_indices(sorted_indices: torch.Tensor) -> torch.Tensor:
    """Dense ``0..num_unique-1`` ids over a sorted index array:
    ``remapped[i]`` counts the index changes up to ``i``."""
    flags = torch.cat([
        sorted_indices.new_zeros(min(1, sorted_indices.shape[0])),
        (sorted_indices[1:] != sorted_indices[:-1]).to(sorted_indices.dtype),
    ])
    return torch.cumsum(flags, 0).to(sorted_indices.dtype)


def compact_sparse_indices(
    sorted_indices: torch.Tensor,
    remapped_indices: torch.Tensor,
    fill_value: int | None = None,
) -> torch.Tensor:
    """Inverse mapping, ``out[remapped[i]] = sorted_indices[i]``, at the full
    capacity; entries at or past num_unique hold ``fill_value`` (default 0).
    Every position of a run writes the same value."""
    out = torch.full_like(sorted_indices, fill_value or 0)
    out[remapped_indices.long()] = sorted_indices
    return out


def csr_to_fixed(indices: torch.Tensor, offsets: torch.Tensor,
                 weights: torch.Tensor | None = None, *, mode: CombineMode = CombineMode.SUM):
    """Densify a CSR problem into a fixed layout and a coefficient mask.

    Returns ``(dense_indices [batch, capacity] int32, coeff [batch,
    capacity] float32)``: sample ``s``'s ``r``-th position lands at ``[s,
    r]``. Empty slots, and the padding past ``offsets[-1]``, point at row 0
    with coefficient 0. MEAN's ``1/h_s`` (0 for an empty sample) is folded
    into the coefficients. The JAX function's outputs, dtypes included.
    """
    batch = offsets.shape[0] - 1
    cap = indices.shape[0]
    device = indices.device
    counts = (offsets[1:] - offsets[:-1]).to(torch.int32)
    pos = torch.arange(cap, device=device)
    sample = extract_row_ids_from_csr(offsets, indices).long()
    keep = sample < batch  # no sample to land in (batch 0), as JAX drops it
    sample, pos = sample[keep], pos[keep]
    rank = pos - offsets.long()[sample]
    live = pos < offsets[-1]
    dense_idx = torch.zeros((batch, cap), dtype=torch.int32, device=device)
    dense_idx[sample, rank] = torch.where(live, indices[keep], 0).to(torch.int32)
    w = (weights.to(torch.float32)[keep] if weights is not None
         else torch.ones(pos.shape, dtype=torch.float32, device=device))
    coeff = torch.zeros((batch, cap), dtype=torch.float32, device=device)
    coeff[sample, rank] = torch.where(live, w, 0.0)
    if mode == CombineMode.MEAN:
        inv = torch.where(counts == 0, 0.0, 1.0 / counts.clamp(min=1).to(torch.float32))
        coeff = coeff * inv[:, None]
    return dense_idx, coeff
