"""Forward lookups on the hand-written Hopper kernels, the counterpart of
``cuembed_tpu/ops/pallas_forward.py``.

* :func:`embedding_forward_cuda_many` runs K1, the fixed-hotness
  gather-reduce (``csrc/forward.cu::fixed_forward_kernel``, which replaces
  ``pallas_forward.py::_make_fwd_kernel``), for a list of lookups: one host
  pass checks, plans and packs them (:func:`pack_fixed_many`), and one call
  into the library a device (``cuembed_fixed_forward_many``) launches each
  lookup's K1. :func:`embedding_forward_cuda` is that path with one lookup.
* :func:`embedding_forward_cuda_csr` runs K2, the ragged CSR combine
  (``csrc/forward.cu::csr_forward_kernel``, which replaces
  ``pallas_forward.py::_make_csr_fwd_kernel``).

Each wrapper checks its inputs, then computes with the plain PyTorch
version (:mod:`cuembed_tpu_torch.ops.lookup_torch`) for tensors on the CPU,
and launches its kernel for tensors on a CUDA device, on the current
stream, as :func:`launch_plan` lays it out (``_build.launch``). A kernel
that fails to build or launch raises; nothing falls back. Each launch is
counted (``trace.counters()``'s ``launch.k1``, ``launch.k2``) and, while a
profiler records, spanned (``cuembed::launch.k1``, ``cuembed::launch.k2``);
a call of the list form into the library is counted as ``launch.k1_batch``
besides and spanned ``cuembed::launch.k1_batch``, and the lookups the list
form serves as ``collection.batched_tables``.
"""

from __future__ import annotations

import functools
import struct
from typing import NamedTuple

import torch

from cuembed_tpu_torch.ops import _build
from cuembed_tpu_torch.ops.lookup_torch import (
    embedding_forward_torch,
    rounded_reciprocal,
)
from cuembed_tpu_torch.types import (
    INDEX_DTYPES,
    STORAGE_DTYPES,
    CombineMode,
    accumulation_dtype,
)
from cuembed_tpu_torch.utils import trace

# The launch plan (tools/fwd_sweep.py times others): warps a block of K1
# and of K2; and work items each worker of a block takes, in turn, from the
# block's queue (K1's bags are all alike; K2's are ragged), where the batch
# still gives FULL_GRID blocks.
FIXED_WARPS = 8
CSR_WARPS = 8
FIXED_ITEMS = 2
CSR_ITEMS = 8
FULL_GRID = 1024  # blocks: about two waves of 4 blocks on an H100's 132 SMs
MAX_THREADS = 256  # kThreads in csrc/common.cuh
MAX_SMEM_BYTES = 232_448  # the most shared memory an H100 block can use (227 KB)


class LaunchPlan(NamedTuple):
    """How K1 or K2 covers a batch (``csrc/forward.cu``)."""

    lanes: int  # threads of a worker, one column vector each: 8, 16 or 32
    slabs: int  # column slabs of ``lanes`` vectors a row
    threads: int  # threads a block
    items_per_block: int  # (bag, slab) work items a block owns
    blocks: int
    smem_bytes: int  # dynamic shared memory a block


@functools.lru_cache(maxsize=4096)
def launch_plan(nvec: int, batch: int, csr: bool, weighted: bool) -> LaunchPlan:
    """The launch of K1 (``csr=False``) or K2 over ``batch`` bags of rows of
    ``nvec`` column vectors, cached: a plan depends on nothing else.

    A worker is a warp, or 8 or 16 lanes of one for rows of up to 16
    vectors; wider rows are cut into slabs of 32 vectors, each its own work
    item. Shared memory: each thread stages one position at a time, an
    int64 row offset and, weighted, a 32-bit coefficient; a K2 block also
    holds its bags' int64 offsets.
    """
    if nvec < 1 or batch < 1:
        raise ValueError(f"nothing to launch for {batch} bags of {nvec} vectors")
    lanes = 8
    while lanes < min(nvec, 32):
        lanes *= 2
    slabs = -(-nvec // lanes)
    threads = 32 * (CSR_WARPS if csr else FIXED_WARPS)
    items_per_block = threads // lanes * (CSR_ITEMS if csr else FIXED_ITEMS)
    if -(-batch * slabs // items_per_block) < FULL_GRID:
        items_per_block = threads // lanes
    blocks = -(-batch * slabs // items_per_block)
    smem_bytes = threads * (8 + 4 * weighted) + (8 * (items_per_block + 2) if csr else 0)
    if threads > MAX_THREADS or smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"a block of {threads} threads and {smem_bytes} bytes does not fit")
    if blocks > 2**31 - 1:
        raise ValueError(f"{batch} bags need {blocks} blocks, more than a grid holds")
    return LaunchPlan(lanes, slabs, threads, items_per_block, blocks, smem_bytes)


def launch_shape(dtype: torch.dtype, width: int, batch: int, *, csr: bool = False,
                 index_bytes: int = 8, offset_bytes: int = 8, weighted: bool = False,
                 low_precision_math: bool = False, vec: int = 16) -> dict:
    """K1's (or K2's) launch shape for a batch at this width, from the built
    library on the current card: registers and spill bytes a thread, shared
    memory a block, threads a block and resident blocks per SM."""
    plan = launch_plan(width * (torch.finfo(dtype).bits // 8) // vec, batch, csr=csr,
                       weighted=weighted)
    shape = torch.zeros(4, dtype=torch.int64)
    err = _build.load_library().cuembed_forward_shape(
        int(csr), _build.DTYPE_CODE[dtype], index_bytes, offset_bytes, int(weighted),
        int(low_precision_math), vec, plan.lanes, plan.threads, plan.smem_bytes,
        shape.data_ptr())
    _build.raise_on_error(err, "csr_forward_kernel" if csr else "fixed_forward_kernel")
    regs, spill, smem, blocks = shape.tolist()
    return {"registers": regs, "spill_bytes": spill, "smem_bytes": smem,
            "threads": plan.threads, "blocks_per_sm": blocks, "lanes": plan.lanes}


def _check_common(table, indices, weights, mode):
    if mode == CombineMode.CONCAT:
        raise ValueError("CONCAT is a pure gather and has no kernel")
    if weights is not None and mode != CombineMode.SUM:
        raise ValueError("weights are only supported with CombineMode.SUM")
    if table.dim() != 2 or table.dtype not in STORAGE_DTYPES:
        raise ValueError(
            f"table must be [num_categories, width] of {STORAGE_DTYPES}, got "
            f"{tuple(table.shape)} {table.dtype}"
        )
    if indices.dtype not in INDEX_DTYPES:
        raise ValueError(f"unsupported index dtype: {indices.dtype}")
    if weights is not None:
        if weights.dtype != torch.float32:
            raise ValueError(f"weights must be float32, got {weights.dtype}")
        if weights.shape != indices.shape:
            raise ValueError(
                f"weights {tuple(weights.shape)} must match indices "
                f"{tuple(indices.shape)}"
            )


def _check_fixed(table, indices, weights, mode) -> bool:
    """A fixed-hotness lookup's checks, in their order; True on CUDA.
    :func:`pack_fixed_many`'s combined test refuses exactly what they raise
    on, and the CPU."""
    _check_common(table, indices, weights, mode)
    if indices.dim() != 2:
        raise ValueError("fixed-hotness indices must be [batch, hotness]")
    return _build.check_placement([table, indices] + ([] if weights is None else [weights]))


def _vec_bytes(bits: int, itemsize: int) -> int:
    """The widest load (16 or 8 bytes, else one element) that divides a row's
    bytes and every data pointer, all OR-ed into ``bits``: a power of two
    divides them all where it divides that."""
    return 16 if bits % 16 == 0 else 8 if bits % 8 == 0 else itemsize


def embedding_forward_cuda(
    table: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    mode: CombineMode = CombineMode.SUM,
    low_precision_math: bool = False,
) -> torch.Tensor:
    """Fixed-hotness forward on K1: :func:`embedding_forward_cuda_many` of
    one lookup, spanned ``cuembed::launch.k1``; where that refuses it, the
    checks raise their error, or the plain version serves it on the CPU. A
    lookup on the card that the checks pass and the host pass refuses raises
    ``RuntimeError``: the two tests disagree, and nothing falls back.

    Args:
      table: ``[num_categories, width]`` fp32/fp16/bf16, contiguous.
      indices: ``[batch, hotness]`` int32/int64, contiguous, in range.
      weights: optional ``[batch, hotness]`` fp32 (SUM only).
      mode: SUM or MEAN.
      low_precision_math: accumulate half tables in half precision.

    Returns:
      ``[batch, width]`` in the table's dtype.
    """
    out, = _forward_fixed([table], [indices], [weights], [mode], low_precision_math,
                          batched=False)
    if out is not None:
        return out
    if _check_fixed(table, indices, weights, mode):
        raise RuntimeError("K1's host pass refused a lookup that its checks accept")
    return embedding_forward_torch(table, indices, None, weights, mode=mode,
                                   low_precision_math=low_precision_math)


def embedding_forward_cuda_csr(
    table: torch.Tensor,
    indices: torch.Tensor,
    offsets: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    mode: CombineMode = CombineMode.SUM,
    low_precision_math: bool = False,
) -> torch.Tensor:
    """CSR forward on K2.

    Args:
      table: ``[num_categories, width]`` fp32/fp16/bf16, contiguous.
      indices: flat ``[capacity]`` int32/int64, contiguous; entries at or
        past ``offsets[-1]`` are padding and never read.
      offsets: ``[batch + 1]`` int32/int64, nondecreasing from 0.
      weights: optional ``[capacity]`` fp32 (SUM only).
      mode: SUM or MEAN (a zero-hotness sample's MEAN row is 0).
      low_precision_math: accumulate half tables in half precision.

    Returns:
      ``[batch, width]`` in the table's dtype.
    """
    _check_common(table, indices, weights, mode)
    if indices.dim() != 1:
        raise ValueError("CSR indices must be flat [capacity]")
    if offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError("CSR offsets must be [batch + 1]")
    if offsets.dtype not in INDEX_DTYPES:
        raise ValueError(f"unsupported offsets dtype: {offsets.dtype}")
    tensors = [table, indices, offsets] + ([weights] if weights is not None else [])
    if not _build.check_placement(tensors):
        return embedding_forward_torch(
            table, indices, offsets, weights, mode=mode,
            low_precision_math=low_precision_math,
        )
    num_rows, width = table.shape
    batch = offsets.shape[0] - 1
    out = torch.empty((batch, width), dtype=table.dtype, device=table.device)
    if batch == 0 or width == 0:
        return out
    acc_dt = accumulation_dtype(table.dtype, low_precision_math)
    itemsize = table.element_size()
    vec = _vec_bytes(width * itemsize | table.data_ptr() | out.data_ptr(), itemsize)
    plan = launch_plan(width * itemsize // vec, batch, True, weights is not None)
    _build.launch(
        "cuembed_csr_forward",
        (table.data_ptr(), indices.data_ptr(), offsets.data_ptr(),
         weights.data_ptr() if weights is not None else None, out.data_ptr(),
         num_rows, batch, indices.shape[0], width, _build.DTYPE_CODE[table.dtype],
         indices.element_size(), offsets.element_size(), int(acc_dt != torch.float32),
         vec, int(mode == CombineMode.MEAN), plan.lanes, plan.slabs, plan.items_per_block,
         plan.threads, plan.smem_bytes),
        device=table.device, kernel="csr_forward_kernel", span="launch.k2",
        counter="launch.k2")
    return out


# int64 words of one K1 descriptor (csrc/forward.cu::cuembed_fixed_forward_many).
FIXED_DESC_WORDS = 20
# Bytes of an element of each table and index dtype.
_ITEMSIZE = {torch.float32: 4, torch.float16: 2, torch.bfloat16: 2, torch.int32: 4,
             torch.int64: 8}


@functools.lru_cache(maxsize=16384)
def _fixed_words(dtype: torch.dtype, low_precision_math: bool, hotness: int, mean: bool,
                 width: int, batch: int, weighted: bool, align: int) -> tuple:
    """Words 9-19 of a K1 descriptor, which depend on these alone: the load
    width (``align``: the row's bytes and the table and output pointers
    OR-ed, modulo 16), the dtype code, low-precision math, the bits of the C
    float MEAN scales by (its rounded 1/hotness, else 1), MEAN, and the
    launch plan."""
    itemsize = _ITEMSIZE[dtype]
    vec = _vec_bytes(align, itemsize)
    acc_dt = accumulation_dtype(dtype, low_precision_math)
    scale = rounded_reciprocal(hotness, acc_dt) if mean else 1.0
    return (vec, _build.DTYPE_CODE[dtype], int(acc_dt != torch.float32),
            struct.unpack("<I", struct.pack("<f", scale))[0], int(mean),
            *launch_plan(width * itemsize // vec, batch, False, weighted))


def pack_fixed_many(tables, indices, weights, modes, *, low_precision_math=False):
    """The host pass of :func:`embedding_forward_cuda_many`, which launches
    nothing: one combined test a lookup of :func:`embedding_forward_cuda`'s
    checks and of the card, which leaves a lookup that fails it without an
    output (None); one output buffer for the others that share (batch,
    width, dtype, device), each output a view of it (a lookup alone in its
    group gets a tensor of its own); and the K1 descriptors' words, by
    device, of the lookups with work (``FIXED_DESC_WORDS`` each, in
    ``csrc/forward.cu::cuembed_fixed_forward_many``'s order). Returns
    ``(outputs, {device: words})``."""
    outs, looks, groups = [None] * len(tables), [], {}
    for i, (table, idx, w, mode) in enumerate(zip(tables, indices, weights, modes)):
        tshape, ishape, dtype, device = table.shape, idx.shape, table.dtype, table.device
        if (not table.is_cuda or dtype not in STORAGE_DTYPES or idx.dtype not in INDEX_DTYPES
                or len(tshape) != 2 or len(ishape) != 2 or idx.device != device
                or mode == CombineMode.CONCAT
                or not (table.is_contiguous() and idx.is_contiguous())
                or (w is not None and (mode != CombineMode.SUM or w.dtype != torch.float32
                                       or w.shape != ishape or w.device != device
                                       or not w.is_contiguous()))):
            continue
        key = (ishape[0], tshape[1], dtype, device)
        groups.setdefault(key, []).append(i)
        looks.append((i, table, idx, w, mode == CombineMode.MEAN, tshape[0], ishape[1], key))
    out_ptrs = {}
    for (batch, width, dtype, device), members in groups.items():
        if len(members) == 1:
            out = outs[members[0]] = torch.empty((batch, width), dtype=dtype, device=device)
            out_ptrs[members[0]] = out.data_ptr()
            continue
        buf = torch.empty((len(members), batch, width), dtype=dtype, device=device)
        ptr, step = buf.data_ptr(), batch * width * _ITEMSIZE[dtype]
        for k, (i, out) in enumerate(zip(members, buf.unbind(0))):
            outs[i], out_ptrs[i] = out, ptr + k * step
    descs = {}
    for i, table, idx, w, mean, num_rows, hotness, (batch, width, dtype, device) in looks:
        if batch == 0 or width == 0:
            continue
        tp, op = table.data_ptr(), out_ptrs[i]
        words = descs.get(device)
        if words is None:
            words = descs[device] = []
        words += (tp, idx.data_ptr(), 0 if w is None else w.data_ptr(), op,
                  num_rows, batch, hotness, width, _ITEMSIZE[idx.dtype],
                  *_fixed_words(dtype, low_precision_math, hotness, mean, width, batch,
                                w is not None, (width * _ITEMSIZE[dtype] | tp | op) % 16))
    return outs, descs


def embedding_forward_cuda_many(tables, indices, weights, modes, *,
                                low_precision_math=False) -> list:
    """Fixed-hotness forwards on K1, the list form: one host pass tests every
    lookup and packs its descriptor (:func:`pack_fixed_many`), and one call
    into the library per device launches them in turn on that device's
    current stream. Lookups that share (batch, width, dtype, device) return
    views of one buffer.

    Returns:
      for each lookup, in order, ``embedding_forward_cuda(tables[i],
      indices[i], weights[i], mode=modes[i],
      low_precision_math=low_precision_math)``, bit for bit, or None where
      the test refused it (on the CPU, or inputs whose checks raise): the
      caller routes those one at a time.
    """
    return _forward_fixed(tables, indices, weights, modes, low_precision_math,
                          batched=True)


def _forward_fixed(tables, indices, weights, modes, low_precision_math, *,
                   batched: bool) -> list:
    """K1's one host path: the host pass, then one call into the library a
    device, spanned ``launch.k1`` for one lookup, ``launch.k1_batch`` (and
    counted as such besides) for the list form."""
    outs, descs = pack_fixed_many(tables, indices, weights, modes,
                                  low_precision_math=low_precision_math)
    for device, words in descs.items():
        n = len(words) // FIXED_DESC_WORDS
        _build.launch("cuembed_fixed_forward_many", (struct.pack(f"{len(words)}q", *words), n),
                      device=device, kernel="fixed_forward_kernel",
                      span="launch.k1_batch" if batched else "launch.k1",
                      counter="launch.k1", count=n)
        if batched:
            trace.COUNTS["launch.k1_batch"] += 1
    if batched:
        trace.COUNTS["collection.batched_tables"] += sum(o is not None for o in outs)
    return outs
