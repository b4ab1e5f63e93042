"""What the port measures with: the reference's application-bytes formulas,
least-time bounds for the lookup and its backward, a CUDA-event timer, the
JAX package's chained timers, and its measurement hygiene (plausibility
floors and re-measuring).

``forward_app_bytes``, ``transpose_app_bytes`` and ``backward_app_bytes``
are copies of those in ``cuembed_tpu/utils/benchmarking.py`` (the
reference's ``manual_benchmark.cu:250-261, 338-354, 444-473``), and so are
``lookups_per_sec``, ``plausible_floor_s``, ``measure_until_plausible`` and
``_slope_stats``. :func:`cuda_time_ms` times the device with CUDA events,
one call at a time, and with ``return_stats`` gives the statistics
``measure_until_plausible`` re-runs on.

The chained timers keep the JAX package's names, signatures and statistics.
A chain threads a state through ``k`` calls of a step and times chains of
two lengths; the slope between them is the time of one step, with every
fixed cost of a chain cancelled:

* :func:`chain_time` calls the step ``k`` times from the host, to a fence
  (``torch.cuda.synchronize()`` for CUDA state, a scalar read for CPU
  state), so its slope holds the host's time per call as well as the
  device's;
* :func:`fori_chain_time` captures ``k`` steps once as a CUDA graph and
  times each replay, so its slope holds the device's time per step only,
  the launch of the graph cancelled as the JAX version cancels its round
  trip. It needs the card;
* :func:`robust_chain_time` takes the smaller of the two.

The probes (:func:`opaque_bump`, :func:`bump_from`, :func:`carry_probe`,
:func:`full_carry_x0`) are the JAX package's definitions in plain torch.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from cuembed_tpu_torch.types import CombineMode

# NVIDIA H100 SXM data sheet: HBM3 rate, and the fp32 rate outside the
# tensor cores (the kernels' adds and multiplies run there). Both assume the
# card's full 700 W power limit.
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOP_PER_S = 67e12

# Larger than the H100's 50 MB L2, so writing it evicts every cached line.
L2_FLUSH_BYTES = 256 * 2**20
# A device-side wait queued ahead of each timed call (about 1 ms at the
# H100's clock), longer than the host takes to enqueue the call.
HOST_SLACK_CYCLES = 2_000_000

# Peak device-memory rate (GB/s) by card name, from NVIDIA's data sheet.
HBM_PEAK_GBPS = {
    "h100": H100_HBM_BYTES_PER_S / 1e9,
}

# A time at or below this carries no signal (the clamp of a chained slope
# whose long chain was no slower than its short one, or an event pair that
# read zero). Every consumer treats a degenerate stat as "re-measure", never
# as a time.
DEGENERATE_SLOPE_S = 1e-9


def detect_hbm_peak_gbps(default: float = H100_HBM_BYTES_PER_S / 1e9) -> float:
    """Peak device-memory GB/s of the card, by its name, from
    :data:`HBM_PEAK_GBPS`; ``default`` (the H100 SXM's 3,350) for a card the
    table does not know. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("detect_hbm_peak_gbps needs a CUDA device")
    kind = torch.cuda.get_device_name(0).lower()
    for key, bw in HBM_PEAK_GBPS.items():
        if key in kind:
            return bw
    return default


def _slope_stats(mn: float, med: float, mx: float) -> dict:
    return {
        "min": mn,
        "median": med,
        "max": mx,
        "degenerate": mn <= DEGENERATE_SLOPE_S or med <= DEGENERATE_SLOPE_S,
    }


def plausible_floor_s(app_bytes: float, peak_gbps: float,
                      safety: float = 1.25) -> float:
    """Fastest physically possible time for ``app_bytes`` of traffic.

    Application bytes are a LOWER bound on device-memory traffic (the
    reference's formulas count logical bytes only,
    ``manual_benchmark.cu:250-261``), so ``bytes / peak`` bounds the
    elapsed time from below; ``safety`` leaves headroom for traffic served
    from cache.
    """
    return app_bytes / (safety * peak_gbps * 1e9)


def measure_until_plausible(measure, floor_s: float, retries: int = 2) -> dict:
    """Re-run ``measure()`` while its median is physically impossible.

    ``measure`` returns timing stats (:func:`cuda_time_ms` with
    ``return_stats``); a median below ``floor_s`` (or a degenerate stat)
    means the number is garbage and must never be committed. Returns the
    last stats with ``stats["implausible"]`` set when every attempt failed;
    callers must refuse to emit such a row as a plain measurement.
    """
    floor_s = max(floor_s, DEGENERATE_SLOPE_S)
    st = measure()
    for _ in range(retries):
        if st["median"] >= floor_s and not st.get("degenerate"):
            break
        st = measure()
    st = dict(st)
    st["implausible"] = st["median"] < floor_s or bool(st.get("degenerate"))
    return st


def lookups_per_sec(batch: int, hotness: int, seconds: float) -> float:
    return batch * hotness / seconds


def forward_app_bytes(
    *,
    batch: int,
    hotness: int,
    width: int,
    elem_bytes: int,
    mode: CombineMode = CombineMode.SUM,
    is_csr: bool = False,
    nnz: int | None = None,
) -> int:
    """Forward application bytes (``manual_benchmark.cu:250-261``).

    fixed: elem * batch * (hotness + (1 if sum else hotness)) * width —
    only kSum pools to one output row in the reference's accounting;
    kMean and kConcat both count hotness output rows.
    CSR:   elem * (nnz - 1 + batch) * width
    """
    if is_csr:
        if nnz is None:
            raise ValueError("CSR app bytes need nnz")
        return elem_bytes * (nnz - 1 + batch) * width
    reads = batch * hotness * width
    writes = (
        batch * width
        if mode == CombineMode.SUM
        else batch * hotness * width
    )
    return elem_bytes * (reads + writes)


def transpose_app_bytes(
    *,
    nnz: int,
    index_bytes: int,
    batch: int = 0,
    is_csr: bool = False,
    is_weighted: bool = False,
    weight_bytes: int = 4,
    compressed: bool = False,
) -> int:
    """Transpose application bytes (``manual_benchmark.cu:338-354``).

    The reference counts CSR offset reads at nnz * sizeof(OffsetT) (one
    offset word per nonzero), and weights at sizeof(ElemT).
    """
    del batch  # kept for signature stability; the reference counts nnz
    reads = nnz * index_bytes
    if is_csr:
        reads += nnz * index_bytes  # offsets, nnz * sizeof(OffsetT)
    if is_weighted:
        reads += nnz * weight_bytes
    writes = (3 if compressed else 2) * nnz * index_bytes
    if is_weighted:
        writes += nnz * weight_bytes
    return reads + writes


def backward_app_bytes(
    *,
    nnz: int,
    batch: int,
    width: int,
    num_unique: int,
    elem_bytes: int,
    index_bytes: int,
    mode: CombineMode = CombineMode.SUM,
    is_weighted: bool = False,
    l2_variant: bool = False,
) -> int:
    """Backward application bytes, DRAM or L2 variant
    (``manual_benchmark.cu:444-473``).

    Reference semantics: CONCAT reads grad_y at nnz rows and L2 == DRAM;
    otherwise DRAM reads batch rows and L2 = DRAM + nnz rows (the re-read
    of grad_y rows served by the L2).
    """
    writes = width * num_unique * elem_bytes
    reads = 2 * nnz * index_bytes
    if is_weighted:
        reads += nnz * elem_bytes
    if mode == CombineMode.CONCAT:
        reads += width * nnz * elem_bytes
    else:
        reads += width * batch * elem_bytes
        if l2_variant:
            reads += width * nnz * elem_bytes
    return writes + reads


def backward_bound(
    *,
    gy_rows: int,
    width: int,
    elem_bytes: int,
    live: int,
    index_bytes: int,
    num_unique: int,
    weighted: bool,
    compressed: bool,
    sid_bytes: int = 4,
) -> dict:
    """The least time an H100 could take for K3's work.

    Bytes: the ``grad_y`` rows read once; the sorted COO streams of the
    live prefix (index, sample id and weight) read once; and each of the
    ``num_unique`` distinct output rows read and written once (full mode,
    which adds into the old row) or written once with its index (compressed
    mode). Operations: one fp32 add per live element (and one multiply when
    weighted). The bound is the larger of the two times.
    """
    row = width * elem_bytes
    nbytes = gy_rows * row + live * (index_bytes + sid_bytes + (4 if weighted else 0))
    nbytes += num_unique * (row + index_bytes if compressed else 2 * row)
    flops = live * width * (2 if weighted else 1)
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / H100_FP32_FLOP_PER_S * 1e3
    return {
        "unique_rows": num_unique,
        "bytes": nbytes,
        "flops": flops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def forward_bound(
    table: torch.Tensor,
    live_indices: torch.Tensor,
    out_rows: int,
    *,
    extra_bytes: int = 0,
    flops_per_element: int = 1,
) -> dict:
    """The least time an H100 could take for one forward lookup.

    Bytes: every distinct table row the lookup touches read once
    (``torch.unique`` of the live indices; power-law ids repeat, and the
    repeats can come from L2), the indices and ``extra_bytes`` (offsets,
    weights) read once, and the output written once. Operations: the fp32
    adds (and multiplies, ``flops_per_element=2``) per looked-up element.
    The bound is the larger of the two times.
    """
    width, elem = table.shape[1], table.element_size()
    unique_rows = int(torch.unique(live_indices).numel())
    nbytes = (
        unique_rows * width * elem
        + live_indices.numel() * live_indices.element_size()
        + extra_bytes
        + out_rows * width * elem
    )
    flops = flops_per_element * live_indices.numel() * width
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / H100_FP32_FLOP_PER_S * 1e3
    return {
        "unique_rows": unique_rows,
        "bytes": nbytes,
        "flops": flops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def cuda_time_ms(fn, *, warmup: int = 3, iters: int = 20, flush_l2: bool = True,
                 return_stats: bool = False):
    """Device time of ``fn()`` from CUDA events on the current stream.

    After ``warmup`` calls, each of ``iters`` calls is bracketed by its own
    pair of events; between calls, outside the events, a write to a buffer
    larger than L2 evicts what the previous call left there, so every call
    starts cold, as a caller's next batch would. Ahead of the start event
    the device spins for ``HOST_SLACK_CYCLES``, so the call is already
    queued when the event fires and the events time the device, not the
    host's launch overhead. Returns the median in milliseconds; with
    ``return_stats``, ``{"min", "median", "max", "degenerate"}`` in
    seconds, the form :func:`measure_until_plausible` takes.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        if flush_l2:
            flush.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_SLACK_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in pairs]
    if return_stats:
        return _slope_stats(min(ms) / 1e3, statistics.median(ms) / 1e3, max(ms) / 1e3)
    return statistics.median(ms)


def stream_rate_gbps(mib: int = 512) -> float:
    """Measured streaming-reduce rate (GB/s) over a ``mib`` MiB int32 buffer
    on the card: one ``sum`` read the whole buffer, timed with
    :func:`cuda_time_ms` (the buffer is larger than L2). A healthy card
    reads most of :func:`detect_hbm_peak_gbps`; far less says the device is
    degraded and its measurements are not to be trusted."""
    if not torch.cuda.is_available():
        raise RuntimeError("stream_rate_gbps needs a CUDA device")
    big = torch.arange(mib * 2**20 // 4, dtype=torch.int32, device="cuda")
    ms = cuda_time_ms(lambda: big.sum(), warmup=2, iters=10, flush_l2=False)
    return mib * 2**20 / (ms / 1e3) / 1e9


# ---------------------------------------------------------------------------
# Chained timers and their probes (cuembed_tpu/utils/benchmarking.py)
# ---------------------------------------------------------------------------


def _tensor_leaves(tree) -> list:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _fence(state) -> None:
    """Wait for ``state``: synchronize each CUDA device it lies on, or, for
    CPU state, read a scalar of its first leaf (as the JAX version reads)."""
    devices = {t.device for t in _tensor_leaves(state) if t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    if not devices:
        float(torch.as_tensor(pytree.tree_leaves(state)[0]).sum())


def chain_time(
    step: Callable,
    x0,
    *,
    k_lo: int = 2,
    k_hi: int = 10,
    repeats: int = 3,
    return_stats: bool = False,
) -> float | dict:
    """Per-call seconds of ``step`` (a function x -> x), best of repeats.

    The state threads through every call and never resets; a fence
    (:func:`_fence`) ends each run, and the host clock times it. The slope
    between ``k_hi`` and ``k_lo`` calls is one call's time, host included.
    With ``return_stats`` returns ``{"min", "median", "max", "degenerate"}``:
    the min-of-repeats slope is the headline, the median guards against the
    min flattering a noisy run, and max/min is the noise indicator.
    """
    state = [x0]

    def run(k: int) -> float:
        t0 = time.perf_counter()
        for _ in range(k):
            state[0] = step(state[0])
        _fence(state[0])
        return time.perf_counter() - t0

    run(2)  # first use: builds, caches, allocator
    lo = [run(k_lo) for _ in range(repeats)]
    hi = [run(k_hi) for _ in range(repeats)]

    def slope(red) -> float:
        return max((red(hi) - red(lo)) / (k_hi - k_lo), DEGENERATE_SLOPE_S)

    if return_stats:
        return _slope_stats(slope(min), slope(statistics.median), slope(max))
    return slope(min)


def opaque_bump(dep: torch.Tensor) -> torch.Tensor:
    """A runtime-zero int32 from ``dep``: ``(dep > 3e38)`` in fp32.

    Chained steps perturb their static operands with a value derived from
    the carry, so that every step depends on the one before. The JAX
    package needs the comparison because XLA folds ``dep * 0`` to a
    constant inside its loop; eager PyTorch folds nothing, and the
    definition is kept so that the two packages time the same work. A NaN
    ``dep`` bumps 0 too.
    """
    return (dep.to(torch.float32) > 3e38).to(torch.int32)


def bump_from(dep) -> torch.Tensor:
    """:func:`opaque_bump` of the first element of a carried output (array
    or scalar)."""
    return opaque_bump(torch.as_tensor(dep).reshape(-1)[0])


def carry_probe(out) -> torch.Tensor:
    """An fp32 scalar that depends on every element of a step's output: the
    sum of squares over every leaf.

    A step that carries this scalar in place of its full output keeps the
    chain's state small (the JAX package's full-output carry held a 512 MB
    gradient across its loop), while every output element still feeds the
    next step. Each leaf is summed as an fp32 dot product with itself, one
    pass over it. Values stay far below the 3e38 of :func:`opaque_bump`, so
    the bump derived from the probe stays zero.
    """
    acc = None
    for leaf in pytree.tree_leaves(out):
        x = torch.as_tensor(leaf).to(torch.float32).reshape(-1)
        for part in x.split(1 << 30):
            sq = torch.dot(part, part)
            acc = sq if acc is None else acc + sq
    return acc if acc is not None else torch.zeros((), dtype=torch.float32)


def full_carry_x0(step: Callable, *operands) -> tuple:
    """The initial ``(0, zeros)`` carry of a full-output-carrying step.

    Runs the step once on the ``(0, 0.0)`` bootstrap carry, on the device of
    the first tensor operand, to find the output's shape and dtype; steps
    read their perturbation with :func:`bump_from`, which takes a scalar or
    an array.
    """
    ops = _tensor_leaves(operands)
    device = ops[0].device if ops else torch.device("cpu")
    boot = (torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.float32, device=device))
    o = step(boot, *operands)[1]
    return (torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros(o.shape, dtype=o.dtype, device=o.device))


def fori_chain_time(
    step: Callable,
    x0,
    *,
    operands=(),
    k_lo: int = 4,
    k_hi: int = 16,
    repeats: int = 3,
    return_stats: bool = False,
) -> float | dict:
    """Per-step seconds with the chain captured as one CUDA graph.

    :func:`chain_time` launches every step from the host, so its slope
    holds the host's time per call. Here ``k`` steps are captured once as a
    ``torch.cuda.CUDAGraph`` and each timed run is one replay, to a
    ``torch.cuda.synchronize()``: ``t(k) = launch + k * step``, and the
    slope over ``(k_lo, k_hi)`` cancels the launch, as the JAX version's
    ``lax.fori_loop`` in one executable cancels its round trip.
    Requirements:

    * ``step(carry, *operands)`` maps the carry to a carry of the same
      structure, shapes and dtypes, and can be captured: no host read
      (``.item()``, a Python branch on a device value), no synchronize, no
      copy from the host inside it. It is run once on a side stream before
      the capture, so that builds and caches are done by then;
    * every tensor of ``x0`` and ``operands`` lies on one CUDA device.
      CPU tensors raise ``RuntimeError``: the CPU has no such chain, and
      nothing else is timed in its place (time CPU steps with
      :func:`chain_time`).

    ``operands``: the tensors the step reads (the table, the index batch),
    passed as ``step(carry, *operands)``, as in the JAX version, where a
    closure capture became a constant of the executable; the graph reads
    them where they lie.

    The contract of the JAX version's salt is kept: ``x0`` needs a float
    leaf (``ValueError`` otherwise), and each timed replay starts from
    ``x0`` with ``salt * 1e-38`` added to the first one. On the card no run
    is memoized, so the salt guards nothing here, and in fp16 or bf16 it
    rounds away wherever the leaf is not 0.
    """
    leaves, spec = pytree.tree_flatten(x0)
    leaves = [torch.as_tensor(x) for x in leaves]
    salt_i = next((i for i, x in enumerate(leaves) if x.is_floating_point()), None)
    if salt_i is None:
        raise ValueError(
            "fori_chain_time needs at least one float leaf in x0 to carry the "
            "anti-memoization salt"
        )
    devices = {t.device for t in leaves + _tensor_leaves(operands)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise RuntimeError(
            "fori_chain_time captures the chain as a CUDA graph and needs every "
            f"tensor of x0 and operands on one CUDA device, got {sorted(map(str, devices))}"
        )
    device = next(iter(devices))
    static = [x.clone() for x in leaves]

    def chain(k):
        x = pytree.tree_unflatten(static, spec)
        for _ in range(k):
            x = step(x, *operands)
        return x

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        chain(1)
    torch.cuda.current_stream(device).wait_stream(side)
    graphs = {}
    for k in (k_lo, k_hi):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = chain(k)
        graphs[k] = (g, out)

    def t(k, salt):
        t0 = time.perf_counter()
        for dst, src in zip(static, leaves):
            dst.copy_(src)
        static[salt_i].add_(salt * 1e-38)
        graphs[k][0].replay()
        torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    t(k_lo, -1.0)  # first replays
    t(k_hi, -2.0)
    lo = [t(k_lo, 10.0 + i) for i in range(repeats)]
    hi = [t(k_hi, 100.0 + i) for i in range(repeats)]
    del graphs

    def slope(red) -> float:
        return max((red(hi) - red(lo)) / (k_hi - k_lo), DEGENERATE_SLOPE_S)

    if return_stats:
        return _slope_stats(slope(min), slope(statistics.median), slope(max))
    return slope(min)


def robust_chain_time(
    step: Callable,
    x0,
    *,
    operands=(),
    k_lo: int = 2,
    k_hi: int = 10,
    repeats: int = 3,
    fori_crossover_s: float = 5e-3,
    return_stats: bool = False,
) -> float | dict:
    """``min(host chain, graph chain)`` per-step seconds: both are upper
    bounds.

    :func:`chain_time` adds the host's time per call, which inflates short
    steps; :func:`fori_chain_time` cancels it. Each only ever adds, so the
    smaller is the tighter bound. As in the JAX version, the graph chain is
    consulted only when the host chain's estimate is below
    ``fori_crossover_s`` (or degenerate), sized so that its slope spans
    about 0.1 s of device work, and a degenerate estimate never wins over
    one that is not. The graph chain exists for CUDA state only: for CPU
    state this is :func:`chain_time`.

    ``step(carry, *operands)`` follows :func:`fori_chain_time`'s contract.
    """
    st = chain_time(
        lambda c: step(c, *operands), x0,
        k_lo=k_lo, k_hi=k_hi, repeats=repeats, return_stats=True,
    )
    on_card = any(t.is_cuda for t in _tensor_leaves((x0, operands)))
    if on_card and (st["min"] < fori_crossover_s or st.get("degenerate")):
        target = max(k_hi, int(0.1 / max(st["min"], 1e-6)))
        fk_hi = min(1024, target)
        fk_lo = max(2, fk_hi // 8)
        fst = fori_chain_time(
            step, x0, operands=operands,
            k_lo=fk_lo, k_hi=fk_hi, repeats=2, return_stats=True,
        )
        if st.get("degenerate") and not fst.get("degenerate"):
            st = fst
        elif fst["min"] < st["min"] and not fst.get("degenerate"):
            st = fst
    if return_stats:
        return st
    return st["min"]
