"""Build and load the kernels' shared library.

``csrc/forward.cu`` (K1, K2), ``csrc/backward.cu`` (K3),
``csrc/adagrad.cu`` (K4) and ``csrc/transpose.cu`` (K5) are compiled by
``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started together,
then linked into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at the first CUDA use, into
``cuembed_tpu_torch/_build/``, and the
library's name carries a hash of the sources, the shared header and the
flags, so a stale library is never loaded. A failed build raises with
nvcc's output. The log beside the library ends with each ``nvcc``'s wall
time and the build's.
Every kernel wrapper (K1-K5) launches through :func:`launch`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from cuembed_tpu_torch.utils import trace

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("forward.cu", "backward.cu", "adagrad.cu", "transpose.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Storage dtype -> the kernels' dtype code.
DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# Sorted positions of a K3 tile (``kTile`` in ``csrc/backward.cu``), for which
# K3's wrapper sizes its scratch; the library is checked against it when it loads.
K3_TILE = 256


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default install location."""
    candidates = [
        os.path.join(home, "bin", "nvcc")
        for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"))
        if home
    ]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources is built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((SOURCE_DIR / name).read_bytes())
    return BUILD_DIR / f"libcuembed_{digest.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    """nvcc's output for the library, with ``-Xptxas -v``'s register and
    spill lines for every kernel."""
    return library_path().with_suffix(".log")


def _run(cmd):
    """Run one command; return its output and its wall time in seconds, or
    raise with its output."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stdout}"
        )
    return proc.stdout, seconds


def build() -> Path:
    """Compile the library unless it is already built; return its path. A
    compile is counted (``trace.counters()``'s ``build``) and, while a
    profiler records, spanned (``cuembed::build``)."""
    path = library_path()
    if path.exists():
        return path
    trace.COUNTS["build"] += 1
    with trace.span("build"):
        _compile(path)
    return path


def _compile(path: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objects = [Path(tmpdir) / f"{Path(name).stem}.o" for name in SOURCES]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            compiled = list(pool.map(_run, [
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(SOURCE_DIR / name)]
                for name, obj in zip(SOURCES, objects)
            ]))
        tmp = Path(tmpdir) / path.name
        linked, link_s = _run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)])
        wall = time.perf_counter() - t0
        times = ", ".join(f"{name} {s:.1f} s" for name, (_, s) in zip(SOURCES, compiled))
        build_log_path().write_text(
            "".join(out for out, _ in compiled) + linked
            + f"build times: {times}, link {link_s:.1f} s, wall {wall:.1f} s\n"
        )
        # Atomic: concurrent builds each rename a complete library into place.
        os.replace(tmp, path)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with its C signatures; raise
    unless its K3 tile is :data:`K3_TILE`."""
    lib = ctypes.CDLL(str(build()))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    # The launch plan: lanes, slabs, items_per_block, threads, smem_bytes.
    plan = [i32, i32, i64, i32, i32]
    lib.cuembed_fixed_forward_many.argtypes = [ptr, i32, ptr]  # descriptors, n, stream
    lib.cuembed_fixed_forward_many.restype = i32
    lib.cuembed_csr_forward.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # table, indices, offsets, weights, out
        i64, i64, i64, i64,  # num_rows, batch, capacity, width
        i32, i32, i32, i32, i32,  # dtype, index_bytes, offset_bytes, lpm, vec_bytes
        i32,  # mean
        *plan,
        ptr,  # stream
    ]
    lib.cuembed_csr_forward.restype = i32
    lib.cuembed_forward_shape.argtypes = [
        i32, i32, i32, i32, i32,  # csr, dtype, index_bytes, offset_bytes, has_w
        i32, i32, i32, i32, i32,  # lpm, vec_bytes, lanes, threads, smem_bytes
        ptr,  # shape: int64[4]
    ]
    lib.cuembed_forward_shape.restype = i32
    lib.cuembed_coo_backward.argtypes = [
        ptr, ptr, ptr, ptr,  # grad_y, t_idx, t_sid, coeff
        ptr, ptr, ptr, ptr,  # out, uniq, head, tail
        ptr, ptr, ptr,  # ranks, tail_rank, num_unique
        i64, i64, i64, i64,  # num_rows, gy_rows, live, width
        i32, i32, i32, i32, i32,  # dtype, index_bytes, vec_bytes, compressed, zeroed
        ptr,  # stream
    ]
    lib.cuembed_coo_backward.restype = i32
    lib.cuembed_coo_backward_tile.argtypes = []
    lib.cuembed_coo_backward_tile.restype = i32
    lib.cuembed_coo_backward_shape.argtypes = [
        i64, i32, i32, i32,  # width, dtype, index_bytes, has_w
        i32, i32, i32,  # vec_bytes, compressed, zeroed
        ptr,  # shape: int64[4]
    ]
    lib.cuembed_coo_backward_shape.restype = i32
    lib.cuembed_rowwise_adagrad_apply.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # rows, uniq, num_unique, table, accum
        i64, i64, i64,  # cap, num_rows, width
        i32, i32, i32,  # dtype, index_bytes, vec
        ctypes.c_float, ctypes.c_float,  # lr, eps
        ptr,  # stream
    ]
    lib.cuembed_rowwise_adagrad_apply.restype = i32
    lib.cuembed_rowwise_adagrad_apply_shape.argtypes = [
        i64, i32, i32, i32,  # width, dtype, index_bytes, vec
        ptr,  # shape: int64[4]
    ]
    lib.cuembed_rowwise_adagrad_apply_shape.restype = i32
    lib.cuembed_coo_transpose_plan.argtypes = [i64, i64, ptr]  # n, num_rows, out: int64[3]
    lib.cuembed_coo_transpose_plan.restype = i32
    lib.cuembed_coo_transpose.argtypes = [
        ptr, i32, i64, i64,  # ids, id_bytes, n, num_rows
        i64, ptr, i32,  # hotness, sample_ids, sid_bytes
        ptr, i32,  # coeff, coeff_bytes
        ptr, ptr, ptr,  # t_idx, t_sid, t_coeff
        ptr, i64,  # scratch, scratch_bytes
        ptr,  # stream
    ]
    lib.cuembed_coo_transpose.restype = i32
    if lib.cuembed_coo_backward_tile() != K3_TILE:
        raise RuntimeError(f"K3 was built for tiles of {lib.cuembed_coo_backward_tile()} "
                           f"positions, its wrapper sizes its scratch for {K3_TILE}")
    return lib


def check_placement(tensors) -> bool:
    """Same device for all, contiguous; True if that device is CUDA."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"all inputs must be on {device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {device}")
    return device.type == "cuda"


def raise_on_error(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError_t {err}")


def launch(entry: str, args, *, device, kernel: str, span: str, counter: str,
           count: int = 1):
    """Call the library's ``entry(*args, stream)`` with ``device`` current, on
    its current stream; raise naming ``kernel`` if the launch failed; count
    ``count`` launches in ``counter``. The span ``cuembed::<span>`` covers the
    call and its check while a profiler records (opened by hand, as
    :mod:`~cuembed_tpu_torch.utils.trace` sets out)."""
    opened = (trace.begin(span) if trace.torch_profiler._is_profiler_enabled else None)
    try:
        with torch.cuda.device(device):
            err = getattr(load_library(), entry)(*args,
                                                 torch.cuda.current_stream().cuda_stream)
        raise_on_error(err, kernel)
    finally:
        if opened is not None:
            trace.end(opened)
    trace.COUNTS[counter] += count
