#!/usr/bin/env python3
"""Time variants of K3 (``cuembed_tpu_torch/csrc/backward.cu``) on one GPU.

    python3 tools/k3_sweep.py VARIANT[,VARIANT...] [--rounds N]

Each VARIANT is ``base`` or ``+``-joined changes to the source as it is:

* ``stages=N``, ``slots=N``, ``slice=BYTES``, ``tile=N``, ``fixup=N``,
  ``fixcols=N``: the constants ``kStages``, ``kSlots``, ``kSliceBytes``,
  ``kTile``, ``kFixupFloats`` and ``kFixupCols``;
* ``cpasync``: 16-byte rows copied by each lane's ``cp.async`` instead of
  one bulk copy per row;
* ``l2hint``: the bulk copies of grad_y rows marked L2 evict-last and those
  of old output rows evict-first.

For example ``base,slice=1024,stages=3+slots=8,cpasync``. Every variant is
built in its own directory under ``cuembed_tpu_torch/_build/sweep/`` (all
``nvcc`` runs started together), checked bit for bit against the plain
version on integer grad_y at the flagship fixed COO (10M x 256, batch 65536,
hotness 64, alpha 1.15 power-law ids), and timed there: the device time of
each K3 kernel (``torch.profiler``, mean of three launches) in full mode
into an fp32 buffer, on the dense step's bf16 call into a buffer and into
a zeroed output, fp32 into a zeroed output, and compressed. Variants take
turns over ``--rounds`` rounds. This measures design choices; the kernel's
own record is ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cuembed_tpu_torch.ops import _build, cuda_backward  # noqa: E402
from cuembed_tpu_torch.utils.datagen import PowerLawGenerator  # noqa: E402

CONSTANTS = {"stages": "kStages", "slots": "kSlots", "slice": "kSliceBytes",
             "tile": "kTile", "fixup": "kFixupFloats", "fixcols": "kFixupCols"}
PATCHES = {
    "cpasync": [
        ("static constexpr bool kBulk = BYTES == 16;", "static constexpr bool kBulk = false;"),
        ("static constexpr bool kCpAsync = BYTES == 8 || BYTES == 4;",
         "static constexpr bool kCpAsync = BYTES != 2;"),
        ('static_assert(BYTES == 4 || BYTES == 8, "cp.async copies 4 or 8 bytes here");', ""),
    ],
    "l2hint": [
        ("template <int BYTES>\n__device__ __forceinline__ void cp_async(",
         "__device__ __forceinline__ void bulk_copy_hint(void* dst, const void* src, "
         "uint32_t bytes, uint64_t* bar, uint64_t policy) {\n"
         '  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes'
         '.L2::cache_hint [%0], [%1], %2, [%3], %4;\\n" ::"r"(smem_addr(dst)), "l"(src), '
         '"r"(bytes), "r"(smem_addr(bar)), "l"(policy) : "memory");\n}\n'
         "template <int BYTES>\n__device__ __forceinline__ void cp_async("),
        # CUTLASS's encodings of the evict-last and evict-first L2 policies.
        ("bulk_copy(slot_of(k, sl & 15), gy + s * a.width + col0 * N, slice, &bars[k % kStages]);",
         "bulk_copy_hint(slot_of(k, sl & 15), gy + s * a.width + col0 * N, slice, "
         "&bars[k % kStages], 0x14F0000000000000ull);"),
        ("bulk_copy(slot_of(k, sl >> 4), out", "bulk_copy_hint(slot_of(k, sl >> 4), out"),
        ("                  slice, &bars[k % kStages]);",
         "                  slice, &bars[k % kStages], 0x12F0000000000000ull);"),
    ],
}
SWEEP_DIR = _build.BUILD_DIR / "sweep"


def variant_source(variant: str) -> str:
    src = (_build.SOURCE_DIR / "backward.cu").read_text()
    for change in filter(None, variant.split("+")):
        if change == "base":
            continue
        if change in PATCHES:
            for old, new in PATCHES[change]:
                if old not in src:
                    raise SystemExit(f"{variant}: the source has no {old[:60]!r}")
                src = src.replace(old, new)
            continue
        name, _, value = change.partition("=")
        pattern = rf"constexpr int {CONSTANTS[name]} = \d+;"
        if not re.search(pattern, src):
            raise SystemExit(f"{variant}: the source has no {CONSTANTS[name]}")
        src = re.sub(pattern, f"constexpr int {CONSTANTS[name]} = {int(value)};", src)
    return src


def build_all(variants):
    """One library per variant: forward.cu and adagrad.cu once, each
    backward.cu variant, all compiled together. Returns {variant: ctypes library}."""
    nvcc = _build.find_nvcc()
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    SWEEP_DIR.mkdir(parents=True)
    fwd = SWEEP_DIR / "forward.o"
    dirs = {}
    for i, v in enumerate(variants):
        d = SWEEP_DIR / f"v{i}"
        d.mkdir()
        shutil.copy(_build.SOURCE_DIR / "common.cuh", d)
        (d / "backward.cu").write_text(variant_source(v))
        dirs[v] = d
    jobs = [[nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(fwd), str(_build.SOURCE_DIR / "forward.cu")]]
    jobs += [[nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(d / "backward.o"), str(d / "backward.cu")]
             for d in dirs.values()]
    apply = SWEEP_DIR / "adagrad.o"
    jobs.append([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(apply),
                 str(_build.SOURCE_DIR / "adagrad.cu")])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = [out for out, _ in pool.map(_build._run, jobs)]
    print(f"[sweep] {len(jobs)} compiles started together: {time.perf_counter() - t0:.1f} s")
    libs = {}
    for (v, d), log in zip(dirs.items(), logs[1:-1]):
        so = d / "libcuembed.so"
        _build._run([_build.find_nvcc(), "-shared", "-o", str(so), str(fwd), str(d / "backward.o"),
                     str(apply)])
        _build.build = lambda so=so: so  # load_library's body on this library
        if hasattr(_build, "K3_TILE"):  # the tile load_library checks the variant against
            _build.K3_TILE = int(re.search(r"constexpr int kTile = (\d+);",
                                           (d / "backward.cu").read_text()).group(1))
        libs[v] = _build.load_library.__wrapped__()
        flagship = r"_ZN7cuembed19coo_backward_kernelIflLb0ELi16E\S*"
        regs = re.findall(rf"Compiling entry function '({flagship})'[\s\S]*?Used (\d+) registers",
                          log)
        print(f"[sweep] {v}: fp32 flagship instantiation {regs[0][1] if regs else '?'} registers")
    return libs


def device_ms(fn, reps=3):
    """Mean device ms of each cuembed kernel over ``reps`` calls of fn."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0].split("::")[-1].split("<")[0]:
            round(e.device_time_total / e.count / 1e3, 4)
            for e in prof.key_averages() if "cuembed" in e.key}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_sweep: no CUDA device is available")
    variants = args.variants.split(",")
    print(f"[sweep] {cs.nvidia_smi_line()}")
    libs = build_all(variants)
    ids = PowerLawGenerator(cs.NUM_ROWS - 1, cs.HOTNESS, cs.ALPHA, permute=True, seed=0,
                            dtype=np.int64)
    idx = torch.from_numpy(ids.sample(cs.BATCH)).cuda()
    t_idx, t_sid = cs.fixed_coo(idx)
    V, W = cs.NUM_ROWS, cs.WIDTH
    gen = torch.Generator(device="cuda").manual_seed(0)
    gy32 = torch.randn((cs.BATCH, W), device="cuda", generator=gen)
    gyh = gy32.bfloat16()
    gyi = torch.randint(-8, 9, (cs.BATCH, W), device="cuda", generator=gen).float()
    want = cs.plain_bwd(gyi, V, t_idx, t_sid)
    buf = torch.zeros((V, W), device="cuda")
    bufh = torch.zeros((V, W), device="cuda", dtype=torch.bfloat16)
    kb, kc = cuda_backward.embedding_backward_cuda, cuda_backward.embedding_backward_cuda_compressed
    for rnd in range(args.rounds):
        for v, lib in libs.items():
            _build.load_library = lambda lib=lib: lib
            cuda_backward.TILE = lib.cuembed_coo_backward_tile()
            if rnd == 0:
                got = kb(gyi, V, t_idx, t_sid)
                if not torch.equal(got, want):
                    raise SystemExit(f"[sweep] {v}: not bit for bit the plain version")
                del got
                shape = cuda_backward.launch_shape(torch.float32, W)
                print(f"[sweep] {v}: exact; fp32 {shape}")
            times = {
                "fp32 full into a buffer": device_ms(lambda: kb(gy32, V, t_idx, t_sid,
                                                                initial_grad=buf)),
                "bf16 full into a buffer": device_ms(lambda: kb(gyh, V, t_idx, t_sid,
                                                                initial_grad=bufh)),
                "bf16 full, zeroed output": device_ms(lambda: kb(gyh, V, t_idx, t_sid)),
                "fp32 full, zeroed output": device_ms(lambda: kb(gy32, V, t_idx, t_sid)),
                "fp32 compressed": device_ms(lambda: kc(gy32, t_idx, t_sid)),
            }
            for label, t in times.items():
                print(f"[sweep] round {rnd + 1} {v} {label}: {t}")
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                   check=True)


if __name__ == "__main__":
    main()
