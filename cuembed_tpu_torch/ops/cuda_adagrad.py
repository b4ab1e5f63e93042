"""Row-wise AdaGrad's apply on its hand-written Hopper kernel (K4,
``csrc/adagrad.cu::rowwise_adagrad_apply_kernel``).

The apply takes K3's compressed gradient (:class:`CompressedGrad`) as it
lies on the card, with its row count on the device, and updates the table
and its accumulators in place. It replaces no Pallas kernel: the JAX package
applies the step with XLA gathers and scatters (``cuembed_tpu/train.py``,
``apply_compressed``).

* :func:`rowwise_adagrad_apply_torch` is the plain PyTorch version, with
  ``apply_compressed``'s masked arithmetic: it reads nothing back to the
  host, and ranks at or past the count are selected away, never used.
* :func:`rowwise_adagrad_apply_cuda` checks its inputs, then computes with
  the plain version for tensors on the CPU, and launches K4 for tensors on
  a CUDA device, on the current stream. A kernel that fails to build or
  launch raises; nothing falls back. Each launch is counted
  (``trace.counters()``'s ``launch.k4``) and, while a profiler records,
  spanned (``cuembed::launch.k4``), by ``_build.launch``.

Both update each rank ``r < min(num_unique, capacity)`` whose index ``u``
lies in ``[0, num_rows)``, and nothing else::

    g2 = mean(rows[r]^2)                     # fp32
    accum[u] = a = accum[u] + g2
    s = -lr / sqrt(a + eps)                  # IEEE fp32 division and root
    table[u] = T(table[u] + T(rows[r] * s))  # T: the table's dtype

The two differ only in the order of a row's sum of squares, so they agree
bit for bit where that sum is exact.
"""

from __future__ import annotations

import torch

from cuembed_tpu_torch.ops import _build
from cuembed_tpu_torch.ops.lookup_torch import CompressedGrad
from cuembed_tpu_torch.types import INDEX_DTYPES, STORAGE_DTYPES


def _check(table, accum, cg):
    rows, uniq, num_unique = cg
    if table.dim() != 2 or table.dtype not in STORAGE_DTYPES:
        raise ValueError(f"table must be [rows, width] of {STORAGE_DTYPES}, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if tuple(accum.shape) != (table.shape[0],) or accum.dtype != torch.float32:
        raise ValueError(f"accum must be [{table.shape[0]}] float32, got "
                         f"{tuple(accum.shape)} {accum.dtype}")
    if rows.dim() != 2 or rows.dtype != torch.float32 or rows.shape[1] != table.shape[1]:
        raise ValueError(f"rows must be [capacity, {table.shape[1]}] float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if tuple(uniq.shape) != (rows.shape[0],) or uniq.dtype not in INDEX_DTYPES:
        raise ValueError(f"unique_indices must be [{rows.shape[0]}] int32/int64, got "
                         f"{tuple(uniq.shape)} {uniq.dtype}")
    if (not isinstance(num_unique, torch.Tensor) or num_unique.dim() != 0
            or num_unique.dtype != torch.int64):
        raise ValueError("num_unique must be a 0-dim int64 tensor")


def _vec_elems(table: torch.Tensor, rows: torch.Tensor) -> int:
    """4 where the width is a multiple of 4 and the gradient rows and the
    table start on a 4-element boundary (16-byte gradient loads), else 1:
    K4's elements a lane loads at a time."""
    if (table.shape[1] % 4 == 0 and rows.data_ptr() % 16 == 0
            and table.data_ptr() % (4 * table.element_size()) == 0):
        return 4
    return 1


def launch_shape(dtype: torch.dtype, width: int, *, index_bytes: int = 8,
                 vec: int = 4) -> dict:
    """K4's launch for such a call, from the built library: threads a
    block, resident blocks per SM on the current card, rows a warp keeps in
    flight, and register chunks of a row (0: two passes over the gradient)."""
    shape = torch.zeros(4, dtype=torch.int64)
    err = _build.load_library().cuembed_rowwise_adagrad_apply_shape(
        width, _build.DTYPE_CODE[dtype], index_bytes, vec, shape.data_ptr())
    _build.raise_on_error(err, "rowwise_adagrad_apply_kernel")
    threads, blocks, rows, chunks = shape.tolist()
    return {"threads": threads, "blocks_per_sm": blocks, "rows_in_flight": rows,
            "chunks": chunks}


@torch.no_grad()
def rowwise_adagrad_apply_torch(table: torch.Tensor, accum: torch.Tensor,
                                cg: CompressedGrad, *, lr: float, eps: float):
    """The apply in plain PyTorch ops; returns ``(table, accum)``, updated
    in place. A rank it leaves alone adds -0 to a row of its own (its rank
    modulo the rows), which changes no bit of it."""
    rows, uniq, num_unique = cg
    if rows.shape[0] == 0 or table.shape[0] == 0:
        return table, accum
    rid = torch.arange(rows.shape[0], device=rows.device)
    valid = (rid < num_unique) & (uniq >= 0) & (uniq < table.shape[0])
    safe = torch.where(valid, uniq.long(), rid % table.shape[0])
    # Quotients of two tensors: the card divides by a host scalar as a
    # product with its reciprocal, which is not the IEEE quotient.
    sq = (rows * rows).sum(dim=1)
    g2 = torch.where(valid, sq / torch.full_like(sq, rows.shape[1]), -0.0)
    new_acc = accum.index_select(0, safe) + g2
    scale = torch.where(valid, torch.full_like(new_acc, -lr) / torch.sqrt(new_acc + eps), 0.0)
    upd = torch.where(valid[:, None], (rows * scale[:, None]).to(table.dtype), -0.0)
    accum.index_add_(0, safe, g2)
    table.index_add_(0, safe, upd)
    return table, accum


def rowwise_adagrad_apply_cuda(table: torch.Tensor, accum: torch.Tensor,
                               cg: CompressedGrad, *, lr: float, eps: float):
    """The apply on K4 (arguments as :func:`rowwise_adagrad_apply_torch`).

    ``table`` ``[num_rows, width]`` fp32/fp16/bf16 and ``accum``
    ``[num_rows]`` fp32; ``cg.rows`` ``[capacity, width]`` fp32,
    ``cg.unique_indices`` ``[capacity]`` int32/int64 and ``cg.num_unique``
    a 0-dim int64 tensor; all on one device, contiguous. Rows and indices
    at or past ``num_unique`` are never read.
    """
    _check(table, accum, cg)
    rows, uniq, num_unique = cg
    if not _build.check_placement([table, accum, rows, uniq, num_unique]):
        return rowwise_adagrad_apply_torch(table, accum, cg, lr=lr, eps=eps)
    if rows.shape[0] == 0:
        return table, accum
    _build.launch(
        "cuembed_rowwise_adagrad_apply",
        (rows.data_ptr(), uniq.data_ptr(), num_unique.data_ptr(), table.data_ptr(),
         accum.data_ptr(), rows.shape[0], table.shape[0], table.shape[1],
         _build.DTYPE_CODE[table.dtype], uniq.element_size(), _vec_elems(table, rows),
         lr, eps),
        device=table.device, kernel="rowwise_adagrad_apply_kernel", span="launch.k4",
        counter="launch.k4")
    return table, accum
