#!/usr/bin/env python3
"""Time variants of K1 and K2 (``cuembed_tpu_torch/csrc/forward.cu``) on one GPU.

    python3 tools/fwd_sweep.py VARIANT[,VARIANT...] [--rounds N]

Each VARIANT is ``base`` or ``+``-joined changes to the code as it is:

* source changes, each built into its own library (all ``nvcc`` runs
  started together): ``k1unroll=N``, ``k2unroll=N`` (``kFixedUnroll``,
  ``kCsrUnroll``: row loads in flight a lane), ``minblocks=N``
  (``kMinBlocks``, the register cap of ``__launch_bounds__``);
  ``carveout=N``: K1 and K2 launched with a preferred shared-memory
  carveout of N percent;
* ``nol1``: row loads through L2 only (``ld.global.cg``), not L1: how
  much of the row traffic L1 absorbs today; ``narrow``: row offsets staged
  as 32-bit counts of vectors;
* ``dedup``: K1 replaced by ``tools/fwd_dedup.cuh``, which loads each
  distinct row of a block's bags once into shared memory, a column slice
  at a time, and sums from there; after it, ``dedupbags=N`` (bags a block),
  ``dedupslice=N`` (row bytes a slice), ``deduprows=N`` (rows a block
  caches), ``dedupmin=N`` (cache only rows looked up N times in the block),
  ``dedupunroll=N`` (loads in flight a thread);
* launch-plan changes (``ops/cuda_forward.py``, no build):
  ``k1warps=N``, ``k2warps=N`` (warps a block), ``k1items=N``,
  ``k2items=N`` (work items a worker takes from its block's queue).

For example ``base,k1unroll=8+minblocks=4,k2warps=1+k2items=1,dedup+dedupbags=16``.
At the flagship table (10M x 256 fp16) every variant is checked bit for
bit against the plain version, then timed (CUDA events, L2 flushed before each
launch, median of 20; variants in turns over ``--rounds`` rounds) on three
id sets of batch 65536 x hotness 64: the alpha 1.15 power-law ids of the
main path; uniform ids over all 10M rows (nearly every row from device
memory: the memory-bound ceiling); and every id on one row (every load on
chip: the on-chip ceiling). K1 runs fixed SUM on each; K2 runs weighted SUM
on each CSR batch (per-bag hotness U{0..64}, as the main path), and, on the
power-law ids, weighted SUM with low-precision math and MEAN with and
without it. K1 is also timed at BASELINE.json config 1 (100K x 32 fp32,
batch 1024, hotness 8, L2 warm, as ``chip_smoke.py`` times a module
request). It prints the share of distinct rows among a block's lookups for
blocks of several sizes, and the launch shape of each variant. This
measures design choices; the kernels' own record is ``chip_smoke.py``'s.

Run from an earlier checkout of the repository (``base`` only), it times
that checkout's kernels on the same inputs.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import cuembed_tpu_torch as tce  # noqa: E402
from cuembed_tpu_torch.ops import _build, cuda_forward  # noqa: E402
from cuembed_tpu_torch.utils import benchmarking as bench  # noqa: E402
from cuembed_tpu_torch.utils.datagen import PowerLawGenerator  # noqa: E402

SOURCE_KNOBS = {"k1unroll": "kFixedUnroll", "k2unroll": "kCsrUnroll",
                "minblocks": "kMinBlocks", "dedupbags": "kDedupBags",
                "dedupslice": "kDedupSliceBytes", "deduprows": "kDedupRows",
                "dedupmin": "kDedupMin", "dedupunroll": "kDedupUnroll"}
PLAN_KNOBS = {"k1warps": "FIXED_WARPS", "k2warps": "CSR_WARPS", "k1items": "FIXED_ITEMS",
              "k2items": "CSR_ITEMS"}
K1_KERNEL = (
    "template <typename T, typename IdxT, bool HAS_W, bool LPM, int BYTES>\n"
    "__global__ void __launch_bounds__(kThreads, kMinBlocks) fixed_forward_kernel("
    "const FwdArgs a) {\n"
    "  FixedBags bags;\n"
    "  combine_items<T, IdxT, HAS_W, LPM, BYTES>(a, bags);\n"
    "}\n")
DEDUP_KERNEL = (
    "template <typename T, typename IdxT, bool HAS_W, bool LPM, int BYTES>\n"
    "__global__ void __launch_bounds__(kThreads, 1) fixed_forward_kernel(const FwdArgs a) {\n"
    "  dedup_items<T, IdxT, HAS_W, LPM, BYTES>(a);\n"
    "}\n")
DEDUP_SOURCE = Path(__file__).resolve().parent / "fwd_dedup.cuh"
PATCHES = {
    "nol1": [("raw[u] = V::load(row(j + u));",
              "raw[u] = __ldcg(reinterpret_cast<const typename V::Raw*>(row(j + u)));")],
    # Row offsets staged as 32-bit counts of vectors (tables below 2^32 of
    # them, as every table of the sweep): one IMAD.WIDE.U32 a row address.
    "narrow": [
        ("s_row[slot0 + gl] = static_cast<int64_t>(id) * a.width * static_cast<int64_t>(sizeof(T));",
         "reinterpret_cast<uint32_t*>(s_row + slot0)[gl] = static_cast<uint32_t>(id) * "
         "static_cast<uint32_t>(a.width / N);"),
        ("return reinterpret_cast<const T*>(base + rows[j]);",
         "return reinterpret_cast<const T*>(base + static_cast<uint64_t>("
         "reinterpret_cast<const uint32_t*>(rows)[j]) * BYTES);"),
    ],
}
SWEEP_DIR = _build.BUILD_DIR / "fwd_sweep"
ONE_ROW = 4_321_987  # the row every id of the on-chip set names


def parse(variant: str):
    """(source text, {plan constant: value}, K1's launch plan or None) of a
    variant."""
    src = (_build.SOURCE_DIR / "forward.cu").read_text()
    plan = {}
    for change in filter(None, variant.split("+")):
        if change == "base":
            continue
        if change.startswith("carveout="):
            old = "  cudaError_t err = cudaSuccess;\n"
            if old not in src:
                raise SystemExit(f"{variant}: the source has no {old!r}")
            src = src.replace(old, "  cudaError_t err = cudaFuncSetAttribute(kernel, "
                              "cudaFuncAttributePreferredSharedMemoryCarveout, "
                              f"{int(change.partition('=')[2])});\n"
                              "  if (err != cudaSuccess) return err;\n")
            continue
        if change == "dedup":
            if K1_KERNEL not in src:
                raise SystemExit(f"{variant}: the source has no fixed_forward_kernel to replace")
            src = src.replace(K1_KERNEL, DEDUP_SOURCE.read_text() + DEDUP_KERNEL)
            continue
        if change in PATCHES:
            for old, new in PATCHES[change]:
                if old not in src:
                    raise SystemExit(f"{variant}: the source has no {old[:60]!r}")
                src = src.replace(old, new)
            continue
        name, _, value = change.partition("=")
        if name in PLAN_KNOBS:
            if not hasattr(cuda_forward, PLAN_KNOBS[name]):
                raise SystemExit(f"{variant}: this checkout has no {PLAN_KNOBS[name]}")
            plan[PLAN_KNOBS[name]] = int(value)
            continue
        if name not in SOURCE_KNOBS:
            raise SystemExit(f"{variant}: unknown change {change!r}")
        pattern = rf"constexpr int {SOURCE_KNOBS[name]} = \d+;"
        if not re.search(pattern, src):
            raise SystemExit(f"{variant}: the source has no {SOURCE_KNOBS[name]}")
        src = re.sub(pattern, f"constexpr int {SOURCE_KNOBS[name]} = {int(value)};", src)
    return src, plan, dedup_plan(src) if "dedup_items" in src else None


LAUNCH_PLAN = getattr(cuda_forward, "launch_plan", None)  # None in older checkouts


def dedup_plan(src):
    """K1's launch plan for the dedup variant of this source: 256 threads
    and kDedupBags bags a block, and the shared memory tools/fwd_dedup.cuh
    lays out for bags of up to cs.HOTNESS positions (the kernel stops if
    its bags need more). K2 keeps its plan."""
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    bags, slice_bytes, rows = const("kDedupBags"), const("kDedupSliceBytes"), const("kDedupRows")
    n = bags * cs.HOTNESS
    hs = 32
    while hs < 2 * n:
        hs *= 2
    smem = -(-(4 * n + 4 * rows) // 16) * 16 + max(8 * hs, rows * slice_bytes)

    def plan(nvec, batch, csr, weighted):
        if csr:
            return LAUNCH_PLAN(nvec, batch, csr=csr, weighted=weighted)
        if nvec > 32 or smem > cuda_forward.MAX_SMEM_BYTES:
            raise ValueError(f"dedup: {nvec} vectors a row, {smem} bytes: no plan")
        return cuda_forward.LaunchPlan(32, 1, 256, bags, -(-batch // bags), smem)
    return plan


def build_all(keys):
    """One library per forward source: backward.cu and adagrad.cu once,
    each forward source, all compiled together. Returns {source: (library, ptxas log)}."""
    nvcc = _build.find_nvcc()
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    SWEEP_DIR.mkdir(parents=True)
    bwd = SWEEP_DIR / "backward.o"
    dirs = []
    for i, src in enumerate(keys):
        d = SWEEP_DIR / f"v{i}"
        d.mkdir()
        shutil.copy(_build.SOURCE_DIR / "common.cuh", d)
        (d / "forward.cu").write_text(src)
        dirs.append(d)
    flags = list(_build.NVCC_FLAGS)
    jobs = [[nvcc, *flags, "-c", "-o", str(bwd), str(_build.SOURCE_DIR / "backward.cu")]]
    jobs += [[nvcc, *flags, "-c", "-o", str(d / "forward.o"), str(d / "forward.cu")]
             for d in dirs]
    apply = SWEEP_DIR / "adagrad.o"
    jobs.append([nvcc, *flags, "-c", "-o", str(apply), str(_build.SOURCE_DIR / "adagrad.cu")])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = [out for out, _ in pool.map(_build._run, jobs)]
    print(f"[sweep] {len(jobs)} compiles started together: {time.perf_counter() - t0:.1f} s")
    libs = {}
    for key, d, log in zip(keys, dirs, logs[1:-1]):
        so = d / "libcuembed.so"
        _build._run([nvcc, "-shared", "-o", str(so), str(d / "forward.o"), str(bwd), str(apply)])
        _build.build = lambda so=so: so  # load_library's body on this library
        libs[key] = (_build.load_library.__wrapped__(), log)
    return libs


def ptxas_registers(log: str) -> str:
    """Registers of the flagship instantiations (fp16 rows, int64 ids,
    16-byte loads): K1 unweighted, K2 weighted with int64 offsets."""
    out = []
    for label, name in (("K1", r"20fixed_forward_kernelI6__halflLb0ELb0ELi16E"),
                        ("K2", r"18csr_forward_kernelI6__halfllLb1ELb0ELi16E")):
        m = re.search(rf"Compiling entry function '_ZN7cuembed{name}\S*'[\s\S]*?"
                      rf"Used (\d+) registers", log)
        out.append(f"{label} {m.group(1) if m else '?'} registers")
    return ", ".join(out)


def csr_of(idx, per, gen):
    """The CSR batch of a fixed batch's first per[b] ids of each bag, padded
    to capacity B x H, and random fp32 weights."""
    batch, hotness = idx.shape
    keep = torch.arange(hotness, device=idx.device)[None, :] < per[:, None]
    nnz = int(per.sum())
    flat = torch.zeros(batch * hotness, dtype=idx.dtype, device=idx.device)
    flat[:nnz] = idx[keep]
    offsets = torch.cat([per.new_zeros(1), per.cumsum(0)])
    w = torch.rand(batch * hotness, device=idx.device, generator=gen)
    return flat, offsets, w


def distinct_shares(idx, sizes):
    """Mean share of distinct rows among the lookups of consecutive blocks
    of `s` bags, for each s, and the top 256 rows' share of all lookups."""
    flat = idx.reshape(-1)
    out = {}
    for s in sizes:
        per_block = s * idx.shape[1]
        blocks = flat[: flat.numel() // per_block * per_block].view(-1, per_block)
        srt = torch.sort(blocks, dim=1).values
        distinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(dim=1)
        out[s] = distinct.double().mean().item() / per_block
    counts = torch.bincount(flat)
    top = torch.topk(counts, min(256, counts.numel())).values.sum().item() / flat.numel()
    return out, top


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fwd_sweep: no CUDA device is available")
    variants = args.variants.split(",")
    print(f"[sweep] {cs.nvidia_smi_line()}")
    parsed = {v: parse(v) for v in variants}
    libs = build_all(list(dict.fromkeys(p[0] for p in parsed.values())))

    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn((cs.NUM_ROWS, cs.WIDTH), device="cuda", generator=gen).half()
    ids = PowerLawGenerator(cs.NUM_ROWS - 1, cs.HOTNESS, cs.ALPHA, permute=True, seed=0,
                            dtype=np.int64)
    id_sets = {
        "power-law": torch.from_numpy(ids.sample(cs.BATCH)).cuda(),
        "uniform": torch.randint(0, cs.NUM_ROWS, (cs.BATCH, cs.HOTNESS), device="cuda",
                                 generator=gen),
        "one row": torch.full((cs.BATCH, cs.HOTNESS), ONE_ROW, device="cuda"),
    }
    rng = np.random.default_rng(11)
    per = torch.from_numpy(rng.integers(0, cs.HOTNESS + 1, cs.BATCH)).cuda()
    csr = {name: csr_of(idx, per, gen) for name, idx in id_sets.items()}
    small = torch.randn((cs.SMALL_ROWS, cs.SMALL_WIDTH), device="cuda", generator=gen)
    small_idx = torch.randint(0, cs.SMALL_ROWS, (cs.SMALL_BATCH, cs.SMALL_HOTNESS),
                              device="cuda", generator=gen)

    sizes = (1, 8, 16, 32, 64, 128, 512)
    shares, top = distinct_shares(id_sets["power-law"], sizes)
    print(f"[sweep] power-law ids: distinct rows among a block's lookups, by bags a "
          f"block: {', '.join(f'{s}: {shares[s]:.1%}' for s in sizes)}; the 256 most "
          f"looked-up rows take {top:.1%} of all lookups")
    for name, idx in id_sets.items():
        b = bench.forward_bound(table, idx, cs.BATCH)
        print(f"[sweep] {name} ids: {b['unique_rows']} distinct rows, K1 bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})")

    k1, k2 = cuda_forward.embedding_forward_cuda, cuda_forward.embedding_forward_cuda_csr
    SUM, MEAN = tce.CombineMode.SUM, tce.CombineMode.MEAN
    # (label, kernel call, its plain version); kernel calls read the plan
    # constants when they run.
    cases = [(f"K1 sum {name}", (lambda i=idx: k1(table, i)), (lambda i=idx: cs.plain(table, i)))
             for name, idx in id_sets.items()]
    for name, (flat, offsets, w) in csr.items():
        cases.append((f"K2 sum_w {name}",
                      lambda f=flat, o=offsets, w=w: k2(table, f, o, w),
                      lambda f=flat, o=offsets, w=w: cs.plain(table, f, o, w)))
    flat, offsets, w = csr["power-law"]
    for label, weights, mode, lpm in (("sum_w lpm", w, SUM, True), ("mean", None, MEAN, False),
                                      ("mean lpm", None, MEAN, True)):
        cases.append((f"K2 {label} power-law",
                      lambda ww=weights, m=mode, lp=lpm: k2(table, flat, offsets, ww, mode=m,
                                                            low_precision_math=lp),
                      lambda ww=weights, m=mode, lp=lpm: cs.plain(table, flat, offsets, ww,
                                                                  mode=m,
                                                                  low_precision_math=lp)))
    wants = {}
    for label, _, plain_fn in cases:
        wants[label] = plain_fn()
    wants["K1 config 1"] = cs.plain(small, small_idx)
    cases.append(("K1 config 1", lambda: k1(small, small_idx), None))

    defaults = {name: getattr(cuda_forward, name) for name in PLAN_KNOBS.values()
                if hasattr(cuda_forward, name)}
    times = {v: {} for v in variants}
    for rnd in range(args.rounds):
        for v in variants:
            src, plan, k1_plan = parsed[v]
            lib, log = libs[src]
            _build.load_library = lambda lib=lib: lib
            cuda_forward.launch_plan = k1_plan or LAUNCH_PLAN
            for name, value in {**defaults, **plan}.items():
                setattr(cuda_forward, name, value)
            for cached in (LAUNCH_PLAN, getattr(cuda_forward, "_fixed_words", None)):
                if hasattr(cached, "cache_clear"):
                    cached.cache_clear()  # plans and K1 descriptor words of the last variant
            if rnd == 0:
                bad = [label for label, fn, _ in cases if not torch.equal(fn(), wants[label])]
                if bad:
                    raise SystemExit(f"[sweep] {v}: not bit for bit the plain version: {bad}")
                shape = ""
                if hasattr(cuda_forward, "launch_shape"):
                    s1 = cuda_forward.launch_shape(torch.float16, cs.WIDTH, cs.BATCH)
                    s2 = cuda_forward.launch_shape(torch.float16, cs.WIDTH, cs.BATCH, csr=True,
                                                   weighted=True)
                    shape = "".join(
                        f"; {k} {s['registers']} registers, {s['spill_bytes']} B spilled, "
                        f"{s['threads']} threads, {s['smem_bytes']} B shared, "
                        f"{s['blocks_per_sm']} blocks/SM" for k, s in (("K1", s1), ("K2", s2)))
                print(f"[sweep] {v}: bit for bit on every case; ptxas {ptxas_registers(log)}"
                      f"{shape}")
            for label, fn, _ in cases:
                ms = bench.cuda_time_ms(fn, flush_l2=label != "K1 config 1")
                times[v].setdefault(label, []).append(ms)
                print(f"[sweep] round {rnd + 1} {v} {label}: {ms:.4f} ms")
    print("[sweep] medians over rounds (ms):")
    labels = [label for label, _, _ in cases]
    print("| variant | " + " | ".join(labels) + " |")
    print("|---" * (len(labels) + 1) + "|")
    for v in variants:
        row = " | ".join(f"{statistics.median(times[v][label]):.4f}" for label in labels)
        print(f"| {v} | {row} |")
    print(f"[sweep] {cs.nvidia_smi_line()}")


if __name__ == "__main__":
    main()
