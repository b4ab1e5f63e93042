"""The sorted-COO backward on its hand-written Hopper kernel, the counterpart
of ``cuembed_tpu/ops/pallas_backward.py``.

* :func:`embedding_backward_cuda` runs K3 in full mode: the
  ``[num_categories, width]`` gradient (``csrc/backward.cu``, which replaces
  ``pallas_backward.py::_make_bwd_kernel``).
* :func:`embedding_backward_cuda_compressed` runs K3 in compressed mode: one
  row per run of equal indices.

Each wrapper checks its inputs, then computes with the plain PyTorch version
(:mod:`cuembed_tpu_torch.ops.lookup_torch`) for tensors on the CPU, and
launches K3 for tensors on a CUDA device, on the current stream. A kernel
that fails to build or launch raises; nothing falls back. Each launch is
counted (``trace.counters()``'s ``launch.k3_full``,
``launch.k3_compressed``) and, while a profiler records, spanned
(``cuembed::launch.k3``), by ``_build.launch``.

K3 sums each run in fp32 in position order, and the output rounds once to
``grad_y``'s dtype; the plain version adds position by position in
``grad_y``'s dtype. The two agree bit for bit where every partial sum is
exact, and are otherwise each within the recursive-sum bound of the exact
sum. Two launches on the same inputs give the same bits.
"""

from __future__ import annotations

import torch

from cuembed_tpu_torch.ops import _build
from cuembed_tpu_torch.ops.lookup_torch import (
    CompressedGrad,
    embedding_backward_compressed_torch,
    embedding_backward_torch,
)
from cuembed_tpu_torch.types import INDEX_DTYPES, STORAGE_DTYPES

# Sorted positions per tile: one block stages a tile's COO in shared memory
# and sums its runs (``kTile`` in ``csrc/backward.cu``, checked when the
# library loads).
TILE = _build.K3_TILE
# The copy route of each row vector width: one bulk copy per row slice
# (16 bytes), cp.async of each column vector (8, 4 bytes), plain loads (2).
ROUTES = {16: "bulk", 8: "cp.async 8 B", 4: "cp.async 4 B", 2: "plain 2 B"}


def _check_coo(grad_y, t_idx, t_sid, t_w):
    if grad_y.dim() != 2 or grad_y.dtype not in STORAGE_DTYPES:
        raise ValueError(
            f"grad_y must be [rows, width] of {STORAGE_DTYPES}, got "
            f"{tuple(grad_y.shape)} {grad_y.dtype}"
        )
    if t_idx.dim() != 1 or t_idx.dtype not in INDEX_DTYPES:
        raise ValueError(f"transpose_indices must be flat int32/int64, got {t_idx.dtype}")
    if t_sid.shape != t_idx.shape or t_sid.dtype not in INDEX_DTYPES:
        raise ValueError("transpose_sample_ids must be int32/int64 like the indices")
    if t_w is not None and (t_w.dtype != torch.float32 or t_w.shape != t_idx.shape):
        raise ValueError("transpose_weights must be float32 like the indices")


def vec_bytes(grad_y: torch.Tensor, out: torch.Tensor) -> int:
    """The widest row vector (16, 8 or 4 bytes, else one element) that
    divides the row stride and the ``grad_y`` and output pointers; it picks
    K3's copy route (:data:`ROUTES`)."""
    row = grad_y.shape[1] * grad_y.element_size()
    for vec in (16, 8, 4):
        if row % vec == 0 and grad_y.data_ptr() % vec == 0 and out.data_ptr() % vec == 0:
            return vec
    return grad_y.element_size()


def launch_shape(dtype: torch.dtype, width: int, *, index_bytes: int = 8,
                 weighted: bool = False, vec: int = 16, compressed: bool = False,
                 zeroed: bool = False) -> dict:
    """K3's launch shape for such a call, from the built library: dynamic
    shared memory per block, threads per block, resident blocks per SM on
    the current card, and column slices a row (one block each)."""
    shape = torch.zeros(4, dtype=torch.int64)
    err = _build.load_library().cuembed_coo_backward_shape(
        width, _build.DTYPE_CODE[dtype], index_bytes, int(weighted), vec, int(compressed),
        int(zeroed), shape.data_ptr())
    _build.raise_on_error(err, "coo_backward_kernel")
    smem, threads, blocks, slices = shape.tolist()
    return {"smem_bytes": smem, "threads": threads, "blocks_per_sm": blocks,
            "slices": slices}


def _live(nnz, cap: int) -> int:
    return cap if nnz is None else max(0, min(int(nnz), cap))


def _launch(grad_y, t_idx, t_sid, t_w, out, uniq, live, num_rows, compressed,
            zeroed=False):
    """K3 over the first ``live`` sorted positions; returns num_unique (a
    0-dim int64 tensor) in compressed mode. ``zeroed``: full mode into an
    output this module zeroed, whose old rows K3 need not read."""
    width = grad_y.shape[1]
    num_tiles = -(-live // TILE)
    device = grad_y.device
    head = torch.empty((num_tiles, width), dtype=torch.float32, device=device)
    tail = torch.empty_like(head)
    ranks = tail_rank = num_unique = None
    if compressed:
        ranks = torch.empty(num_tiles, dtype=torch.int64, device=device)
        tail_rank = torch.empty_like(ranks)
        num_unique = torch.empty((), dtype=torch.int64, device=device)
    t_sid = t_sid if t_sid.dtype == torch.int32 else t_sid.to(torch.int32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.launch(
        "cuembed_coo_backward",
        (grad_y.data_ptr(), t_idx.data_ptr(), t_sid.data_ptr(), ptr(t_w),
         out.data_ptr(), ptr(uniq), head.data_ptr(), tail.data_ptr(),
         ptr(ranks), ptr(tail_rank), ptr(num_unique),
         num_rows, grad_y.shape[0], live, width,
         _build.DTYPE_CODE[grad_y.dtype], t_idx.element_size(),
         vec_bytes(grad_y, out), int(compressed), int(zeroed)),
        device=device, kernel="coo_backward_kernel", span="launch.k3",
        counter="launch.k3_compressed" if compressed else "launch.k3_full")
    return num_unique


def embedding_backward_cuda(
    grad_y: torch.Tensor,
    num_categories: int,
    transpose_indices: torch.Tensor,
    transpose_sample_ids: torch.Tensor,
    transpose_weights: torch.Tensor | None = None,
    *,
    nnz=None,
    initial_grad: torch.Tensor | None = None,
    live_cap: int | None = None,
) -> torch.Tensor:
    """Full gradient on K3 (arguments as
    :func:`~cuembed_tpu_torch.ops.lookup_torch.embedding_backward_torch`).

    ``transpose_indices`` must be sorted over the live prefix. Entries out
    of ``[0, num_categories)`` and positions at or past ``nnz`` are dropped.
    ``initial_grad`` (``grad_y``'s dtype, contiguous) is added into in
    place and returned. ``live_cap`` changes nothing here: K3 reads only the
    live prefix.
    """
    _check_coo(grad_y, transpose_indices, transpose_sample_ids, transpose_weights)
    shape = (num_categories, grad_y.shape[1])
    if initial_grad is not None and (
        tuple(initial_grad.shape) != shape or initial_grad.dtype != grad_y.dtype
    ):
        raise ValueError(f"initial_grad must be {shape} of {grad_y.dtype}")
    tensors = [grad_y, transpose_indices, transpose_sample_ids] + [
        t for t in (transpose_weights, initial_grad) if t is not None
    ]
    if not _build.check_placement(tensors):
        return embedding_backward_torch(
            grad_y, num_categories, transpose_indices, transpose_sample_ids,
            transpose_weights, nnz=nnz, initial_grad=initial_grad, live_cap=live_cap,
        )
    out = (torch.zeros(shape, dtype=grad_y.dtype, device=grad_y.device)
           if initial_grad is None else initial_grad)
    live = _live(nnz, transpose_indices.shape[0])
    if live == 0 or grad_y.shape[1] == 0:
        return out
    _launch(grad_y, transpose_indices, transpose_sample_ids, transpose_weights, out,
            None, live, num_categories, compressed=False, zeroed=initial_grad is None)
    return out


def embedding_backward_cuda_compressed(
    grad_y: torch.Tensor,
    transpose_indices: torch.Tensor,
    transpose_sample_ids: torch.Tensor,
    transpose_weights: torch.Tensor | None = None,
    *,
    nnz=None,
    live_cap: int | None = None,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> CompressedGrad:
    """Compressed gradient on K3 (arguments as
    :func:`~cuembed_tpu_torch.ops.lookup_torch.embedding_backward_compressed_torch`):
    run ``r`` of the live prefix, out-of-range runs included, goes to
    ``rows[r]`` and ``unique_indices[r]``. Entries past ``num_unique`` keep
    ``out``'s values; without ``out`` they are unspecified (K3 stores every
    rank below the count and reads no old row, so its buffers are not
    zeroed), and a reader takes only the first ``num_unique``."""
    _check_coo(grad_y, transpose_indices, transpose_sample_ids, transpose_weights)
    cap, width = transpose_indices.shape[0], grad_y.shape[1]
    if out is not None and (
        tuple(out[0].shape) != (cap, width) or out[0].dtype != grad_y.dtype
        or tuple(out[1].shape) != (cap,) or out[1].dtype != transpose_indices.dtype
    ):
        raise ValueError(f"out must be [{cap}, {width}] of {grad_y.dtype} rows and "
                         f"[{cap}] of {transpose_indices.dtype} indices")
    tensors = [grad_y, transpose_indices, transpose_sample_ids] + [
        t for t in (transpose_weights, *(out or ())) if t is not None]
    if not _build.check_placement(tensors):
        return embedding_backward_compressed_torch(
            grad_y, transpose_indices, transpose_sample_ids, transpose_weights,
            nnz=nnz, live_cap=live_cap, out=out,
        )
    if out is None:
        rows = torch.empty((cap, width), dtype=grad_y.dtype, device=grad_y.device)
        uniq = torch.empty_like(transpose_indices)
    else:
        rows, uniq = out
    live = _live(nnz, cap)
    if live == 0:
        return CompressedGrad(rows, uniq, torch.zeros((), dtype=torch.int64,
                                                      device=grad_y.device))
    num_unique = _launch(grad_y, transpose_indices, transpose_sample_ids,
                         transpose_weights, rows, uniq, live, 0, compressed=True)
    return CompressedGrad(rows, uniq, num_unique)
