"""ctypes bindings for the native host pipeline (``native/cuembed_host.cpp``),
the counterpart of ``cuembed_tpu/native/__init__.py``.

The C++ library speeds up the host side of the engine: index generation,
id->row remapping for the frequency-ordered layout, CSR transforms and
frequency statistics, so the input pipeline outruns the device. Every
function has a numpy fallback with the same results; ``AVAILABLE`` tells
which implementation serves.

The library is looked up on the same path as the JAX package's binding,
``<repo>/native/libcuembed_host.so`` (then the loader's own search path), so
that both packages take the same branch in one process: with the library,
:func:`powerlaw_indices` draws its own deterministic stream, and
``utils.calibration.calibrate_powerlaw_workload`` calibrates on it.

Build the library once per machine:  ``make -C native``
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB_PATHS = [
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libcuembed_host.so",
    ),
    "libcuembed_host.so",
]

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def load_library(path: str) -> ctypes.CDLL:
    """Load the host library at ``path`` and declare its C interface (raises
    ``OSError`` when it does not load). The module loads it from the JAX
    package's path at import; tests load a copy built elsewhere."""
    lib = ctypes.CDLL(path)
    lib.cuembed_powerlaw_indices.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_double, ctypes.c_int64,
        ctypes.c_uint64, _i32p, ctypes.c_int32, _i32p,
    ]
    lib.cuembed_remap_indices.argtypes = [_i32p, ctypes.c_int64, _i32p, _i32p]
    lib.cuembed_count_frequencies.argtypes = [
        _i32p, ctypes.c_int64, _i64p, ctypes.c_int64,
    ]
    lib.cuembed_extract_row_ids_from_csr.argtypes = [
        _i32p, ctypes.c_int64, _i32p,
    ]
    lib.cuembed_transpose.argtypes = [
        _i32p, _i32p, _f32p, ctypes.c_int64, ctypes.c_int64, _i64p,
        _i32p, _i32p, _f32p,
    ]
    lib.cuembed_cold_counts.argtypes = [
        _i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        _i32p, ctypes.c_int64,
    ]
    lib.cuembed_native_abi_version.restype = ctypes.c_int32
    if hasattr(lib, "cuembed_offload_prepare"):
        lib.cuembed_offload_prepare.argtypes = [
            _i32p, ctypes.c_int64, ctypes.c_int32, _f32p,
            ctypes.c_int64, ctypes.c_int64,
            _i32p, _i32p, _u8p, _i32p, _f32p,
        ]
        lib.cuembed_offload_prepare.restype = ctypes.c_int64
    return lib


_lib = None
for _p in _LIB_PATHS:
    try:
        _lib = load_library(_p)
        break
    except OSError:
        continue

AVAILABLE = _lib is not None
_HAS_OFFLOAD = AVAILABLE and hasattr(_lib, "cuembed_offload_prepare")

_fallback_noticed: set = set()


def _fallback(feature: str) -> None:
    """One-time notice (or hard error) when a hot path loses the C++ library.

    The numpy fallbacks give the same results, more slowly; a user who
    skipped ``make -C native`` hears about it once instead of paying it
    every batch unawares. ``CUEMBED_NATIVE=require`` turns the notice into
    an ImportError for deployments that must not regress.
    """
    if os.environ.get("CUEMBED_NATIVE", "").lower() == "require":
        raise ImportError(
            f"libcuembed_host.so not found and CUEMBED_NATIVE=require is "
            f"set ({feature} would fall back to numpy); build it with "
            f"`make -C native`"
        )
    if feature not in _fallback_noticed:
        _fallback_noticed.add(feature)
        import warnings

        warnings.warn(
            f"cuembed_tpu_torch.native: libcuembed_host.so not found — "
            f"{feature} is using the numpy fallback (identical results, "
            f"slower host pipeline). Build it once: `make -C native`.",
            stacklevel=3,
        )


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def powerlaw_indices(
    num_categories: int,
    hotness: int,
    alpha: float,
    batch: int,
    *,
    seed: int = 0,
    permutation: Optional[np.ndarray] = None,
    shuffle: bool = False,
) -> np.ndarray:
    """[batch, hotness] per-sample-distinct power-law indices.

    Native path: deterministic per (seed, sample) whatever the thread
    count. The native generator is its own deterministic stream: it matches
    the *distribution* of
    :class:`cuembed_tpu_torch.utils.datagen.PowerLawGenerator`, not its
    draws.
    """
    if not AVAILABLE:
        _fallback("powerlaw_indices (datagen)")
        from cuembed_tpu_torch.utils.datagen import PowerLawGenerator

        gen = PowerLawGenerator(
            num_categories, hotness, alpha, seed=seed, shuffle=shuffle
        )
        out = gen.sample(batch)
        if permutation is not None:
            out = permutation[out]
        return out.astype(np.int32)
    out = np.empty((batch, hotness), np.int32)
    perm = None
    perm_ptr = ctypes.cast(None, _i32p)
    if permutation is not None:
        perm = np.ascontiguousarray(permutation, np.int32)
        perm_ptr = _ptr(perm, ctypes.c_int32)
    _lib.cuembed_powerlaw_indices(
        num_categories, hotness, float(alpha), batch,
        ctypes.c_uint64(seed), perm_ptr, int(shuffle),
        _ptr(out, ctypes.c_int32),
    )
    return out


def remap_indices(indices: np.ndarray, remap: np.ndarray) -> np.ndarray:
    """``remap[indices]``: the frequency-ordered layout's id->row translation."""
    indices = np.ascontiguousarray(indices, np.int32)
    if not AVAILABLE:
        return np.asarray(remap, np.int32)[indices]
    remap = np.ascontiguousarray(remap, np.int32)
    out = np.empty_like(indices)
    _lib.cuembed_remap_indices(
        _ptr(indices, ctypes.c_int32), indices.size,
        _ptr(remap, ctypes.c_int32), _ptr(out, ctypes.c_int32),
    )
    return out


def count_frequencies(
    indices: np.ndarray, num_categories: int, counts: Optional[np.ndarray] = None
) -> np.ndarray:
    """``counts += bincount(indices)`` over ``[0, num_categories)``."""
    if counts is None:
        counts = np.zeros((num_categories,), np.int64)
    indices = np.ascontiguousarray(indices, np.int32).reshape(-1)
    if not AVAILABLE:
        add = np.bincount(indices, minlength=num_categories)[:num_categories]
        counts += add
        return counts
    counts = np.ascontiguousarray(counts, np.int64)
    _lib.cuembed_count_frequencies(
        _ptr(indices, ctypes.c_int32), indices.size,
        _ptr(counts, ctypes.c_int64), num_categories,
    )
    return counts


def extract_row_ids_from_csr(offsets: np.ndarray) -> np.ndarray:
    """The sample id of each live CSR position."""
    offsets = np.ascontiguousarray(offsets, np.int32)
    nnz = int(offsets[-1])
    if not AVAILABLE:
        return np.repeat(
            np.arange(offsets.size - 1, dtype=np.int32), np.diff(offsets)
        )
    out = np.empty((nnz,), np.int32)
    _lib.cuembed_extract_row_ids_from_csr(
        _ptr(offsets, ctypes.c_int32), offsets.size - 1,
        _ptr(out, ctypes.c_int32),
    )
    return out


def transpose(
    indices: np.ndarray,
    sample_ids: np.ndarray,
    weights: Optional[np.ndarray],
    num_categories: int,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Stable sort of the COO by lookup index (host side)."""
    indices = np.ascontiguousarray(indices, np.int32)
    sample_ids = np.ascontiguousarray(sample_ids, np.int32)
    if not AVAILABLE:
        order = np.argsort(indices, kind="stable")
        w = None if weights is None else np.asarray(weights, np.float32)[order]
        return indices[order], sample_ids[order], w
    nnz = indices.size
    work = np.zeros((num_categories + 1,), np.int64)
    out_i = np.empty((nnz,), np.int32)
    out_s = np.empty((nnz,), np.int32)
    out_w = None
    w_ptr = ctypes.cast(None, _f32p)
    ow_ptr = ctypes.cast(None, _f32p)
    if weights is not None:
        weights = np.ascontiguousarray(weights, np.float32)
        out_w = np.empty((nnz,), np.float32)
        w_ptr = _ptr(weights, ctypes.c_float)
        ow_ptr = _ptr(out_w, ctypes.c_float)
    _lib.cuembed_transpose(
        _ptr(indices, ctypes.c_int32), _ptr(sample_ids, ctypes.c_int32),
        w_ptr, nnz, num_categories, _ptr(work, ctypes.c_int64),
        _ptr(out_i, ctypes.c_int32), _ptr(out_s, ctypes.c_int32), ow_ptr,
    )
    return out_i, out_s, out_w


def cold_counts(
    indices: np.ndarray, hot_rows: int, chunk_elems: int
) -> np.ndarray:
    """Per-chunk count of indices >= hot_rows (tiered capacity planning)."""
    indices = np.ascontiguousarray(indices, np.int32).reshape(-1)
    n = indices.size
    num_chunks = -(-n // chunk_elems)
    if not AVAILABLE:
        pad = num_chunks * chunk_elems - n
        flat = np.pad(indices, (0, pad))
        return (
            (flat.reshape(num_chunks, chunk_elems) >= hot_rows)
            .sum(axis=1)
            .astype(np.int32)
        )
    out = np.empty((num_chunks,), np.int32)
    _lib.cuembed_cold_counts(
        _ptr(indices, ctypes.c_int32), n, hot_rows, chunk_elems,
        _ptr(out, ctypes.c_int32), num_chunks,
    )
    return out


def offload_prepare(
    indices: np.ndarray, hot: int, tail: np.ndarray, cap: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host side of the offloaded lookup: dedupe cold ids, gather rows.

    Returns ``(idx_hot, slot, is_cold, uniq, rows)``: the ids with cold ones
    set to 0, each cold position's slot in ``uniq``, the cold mask, the
    ascending unique cold rows (tail-relative), and their ``tail`` rows in a
    zero-padded ``[cap, width]`` block. Raises ``ValueError`` when the batch's
    unique cold rows exceed ``cap``.
    """
    idx = np.ascontiguousarray(indices, np.int32)
    tail = np.ascontiguousarray(tail, np.float32)
    width = tail.shape[1]
    if not _HAS_OFFLOAD:
        _fallback("offload_prepare (host tail gather)")
        is_cold = idx >= hot
        uniq = np.unique(idx[is_cold]) - hot
        if uniq.shape[0] > cap:
            raise ValueError(
                f"batch touches {uniq.shape[0]} unique cold rows > "
                f"cold_cap {cap}; raise cold_cap or the head"
            )
        rows = np.zeros((cap, width), np.float32)
        rows[: uniq.shape[0]] = tail[uniq]
        slot = np.zeros(idx.shape, np.int32)
        slot[is_cold] = np.searchsorted(uniq, idx[is_cold] - hot)
        return (
            np.where(is_cold, 0, idx).astype(np.int32), slot,
            is_cold, uniq.astype(np.int32), rows,
        )
    idx_hot = np.empty_like(idx)
    slot = np.empty_like(idx)
    is_cold = np.empty(idx.shape, np.uint8)
    uniq = np.empty((cap,), np.int32)
    rows = np.empty((cap, width), np.float32)
    k = _lib.cuembed_offload_prepare(
        _ptr(idx, ctypes.c_int32), idx.size, hot,
        _ptr(tail, ctypes.c_float), width, cap,
        _ptr(idx_hot, ctypes.c_int32), _ptr(slot, ctypes.c_int32),
        _ptr(is_cold, ctypes.c_uint8), _ptr(uniq, ctypes.c_int32),
        _ptr(rows, ctypes.c_float),
    )
    if k < 0:
        raise ValueError(
            f"batch touches {-k} unique cold rows > cold_cap {cap}; "
            "raise cold_cap or the head"
        )
    return idx_hot, slot, is_cold.astype(bool), uniq[:k], rows
