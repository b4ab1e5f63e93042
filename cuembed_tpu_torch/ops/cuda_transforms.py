"""The COO transpose on its hand-written Hopper kernel (K5,
``csrc/transpose.cu``): a lookup's COO sorted by row, stably, with its sample
ids and coefficients in the sorted order, as K3 takes it.

K5 replaces no Pallas kernel (the JAX package sorts with ``lax.sort``): it
replaces ``torch.sort(stable=True)`` of the ids and the gathers that permuted
the sample ids and coefficients after it.

* :func:`coo_transpose_torch` is the plain PyTorch version:
  :func:`~cuembed_tpu_torch.ops.transforms.transpose_position_ordered`, one
  stable ``torch.sort`` by id, with the fixed-hotness sample ids made first.
* :func:`coo_transpose_cuda` checks its inputs, then computes with the plain
  version for tensors on the CPU, and launches K5 for tensors on a CUDA
  device, on the current stream: a radix sort over only the bits the keys
  ``clamp(id, -1, num_rows) + 1`` use (:func:`sort_plan`; the library plans
  them and sizes the scratch, :func:`library_plan`), whose last pass writes
  the sorted ids, sample ids and coefficients. A kernel that fails to
  build or launch raises; nothing falls back. Each transpose it serves is
  counted (``trace.counters()``'s ``launch.k5``) and, while a profiler
  records, spanned (``cuembed::launch.k5``), by ``_build.launch``.

Both return ``(t_idx, t_sid, t_coeff)``: the ids, the sample ids (int32 for a
fixed hotness, else ``sample_ids``' dtype) and the coefficients (or None) in
the order of a stable sort by id. They are equal bit for bit wherever the ids
hold at most one value below 0 and one at or past ``num_rows``, as every COO
the port builds does (the lookups refuse out-of-range ids, and padding and
masks use the one sentinel). Where several distinct values lie below 0, or at
or past ``num_rows``, K5 keeps each group in position order, where the plain
version orders it by value; every update drops such runs, so tables and
optimizer state come out the same. The exception is a ``unique_cap`` cut under
``overflow="drop"``, which counts runs from the front: there several distinct
negative ids could move the cut.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cuembed_tpu_torch.ops import _build
from cuembed_tpu_torch.ops.transforms import fixed_sample_ids, transpose_position_ordered
from cuembed_tpu_torch.types import INDEX_DTYPES

# Positions K5 takes, and the most rows (their keys, 0..num_rows + 1, in 31 bits).
MAX_POSITIONS = 2**31 - 1
MAX_ROWS = 2**31 - 2


def sort_plan(num_rows: int) -> tuple[int, int]:
    """``(key_bits, passes)`` for a table of ``num_rows`` rows: the keys run
    over ``0 .. num_rows + 1``, so K5 sorts ``bit_length(num_rows + 1)`` bits
    in as many 8-bit digit passes as they need. This states the rule for
    readers and reports; what K5 runs is ``plan()`` in
    ``csrc/transpose.cu``, which also lays out the scratch
    (:func:`library_plan` reads it, and the card tests hold the two
    together)."""
    bits = (num_rows + 1).bit_length()
    return bits, -(-bits // 8)


@functools.lru_cache(maxsize=1024)
def library_plan(n: int, num_rows: int) -> tuple[int, int, int]:
    """``(key_bits, passes, scratch_bytes)`` from the library's K5 plan for
    ``n`` positions into ``num_rows`` rows."""
    out = (ctypes.c_int64 * 3)()
    _build.raise_on_error(
        _build.load_library().cuembed_coo_transpose_plan(n, num_rows, out), "K5 plan")
    return tuple(out)


def _check(ids, num_rows, hotness, sample_ids, coeff):
    if ids.dim() != 1 or ids.dtype not in INDEX_DTYPES:
        raise ValueError(f"ids must be flat int32/int64, got {tuple(ids.shape)} {ids.dtype}")
    n = ids.shape[0]
    if n > MAX_POSITIONS:
        raise ValueError(f"K5 takes fewer than 2**31 positions, got {n}")
    if not 0 <= num_rows <= MAX_ROWS:
        raise ValueError(f"K5 takes 0 to 2**31 - 2 rows, got {num_rows}")
    if (hotness is None) == (sample_ids is None):
        raise ValueError("give exactly one of hotness and sample_ids")
    if hotness is not None and not (1 <= hotness < 2**32 or n == 0):
        raise ValueError(f"hotness must be in [1, 2**32), got {hotness}")
    if sample_ids is not None and (tuple(sample_ids.shape) != (n,)
                                   or sample_ids.dtype not in INDEX_DTYPES):
        raise ValueError(f"sample_ids must be [{n}] int32/int64, got "
                         f"{tuple(sample_ids.shape)} {sample_ids.dtype}")
    if coeff is not None and (tuple(coeff.shape) != (n,) or not coeff.is_floating_point()
                              or coeff.element_size() not in (2, 4, 8)):
        raise ValueError(f"coeff must be [{n}] floating point, got "
                         f"{tuple(coeff.shape)} {coeff.dtype}")


def coo_transpose_torch(ids: torch.Tensor, num_rows: int, *, hotness: int | None = None,
                        sample_ids: torch.Tensor | None = None,
                        coeff: torch.Tensor | None = None):
    """The transpose in plain PyTorch (arguments as :func:`coo_transpose_cuda`)."""
    del num_rows
    if sample_ids is None:
        sample_ids = fixed_sample_ids(ids.shape[0], hotness, device=ids.device)
    return transpose_position_ordered(sample_ids, ids, coeff)


def coo_transpose_cuda(ids: torch.Tensor, num_rows: int, *, hotness: int | None = None,
                       sample_ids: torch.Tensor | None = None,
                       coeff: torch.Tensor | None = None):
    """``(t_idx, t_sid, t_coeff)``: the COO of ``ids`` (``[n]`` int32/int64)
    into a table of ``num_rows`` rows sorted by id, stably, on K5.

    The sample id of position ``p`` is ``p // hotness`` (a fixed hotness; 1
    for CONCAT, whose gradient has a row a position) or ``sample_ids[p]``:
    give exactly one. ``coeff`` (``[n]``, 2, 4 or 8 bytes an element)
    rides along. All on one device; a strided input is read through a
    contiguous copy. K5 takes ``n < 2**31`` and ``num_rows + 2 <= 2**31``,
    and raises on more.
    """
    _check(ids, num_rows, hotness, sample_ids, coeff)
    ids, sample_ids, coeff = (None if t is None else t.contiguous()
                              for t in (ids, sample_ids, coeff))
    given = [t for t in (ids, sample_ids, coeff) if t is not None]
    if not _build.check_placement(given):
        return coo_transpose_torch(ids, num_rows, hotness=hotness, sample_ids=sample_ids,
                                   coeff=coeff)
    n = ids.shape[0]
    scratch_bytes = library_plan(n, num_rows)[2]
    device = ids.device
    t_idx = torch.empty_like(ids)
    t_sid = torch.empty(n, dtype=torch.int32 if sample_ids is None else sample_ids.dtype,
                        device=device)
    t_coeff = None if coeff is None else torch.empty_like(coeff)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.launch(
        "cuembed_coo_transpose",
        (ids.data_ptr(), ids.element_size(), n, num_rows,
         0 if hotness is None else hotness, ptr(sample_ids), t_sid.element_size(),
         ptr(coeff), 0 if coeff is None else coeff.element_size(),
         t_idx.data_ptr(), t_sid.data_ptr(), ptr(t_coeff),
         scratch.data_ptr(), scratch.numel()),
        device=device, kernel="digit_pass_kernel", span="launch.k5", counter="launch.k5")
    return t_idx, t_sid, t_coeff
