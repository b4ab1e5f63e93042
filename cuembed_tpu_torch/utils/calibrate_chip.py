"""Measure the chip constants record (:mod:`cuembed_tpu_torch.utils.chip`) on
the card, the counterpart of ``benchmarks/calibrate_chip.py``.

    python -m cuembed_tpu_torch.utils.calibrate_chip [--quick] [--out PATH]

Runs the three measurements whose results gate the configurations and the
dispatcher, on the JAX script's grids, each step timed with
:func:`~cuembed_tpu_torch.utils.benchmarking.robust_chain_time` (the median
of its statistics) and probed with ``bump_from`` and ``carry_probe``:

1. ``vmem_gather``: the row-gather rate against table size, a width-256
   fp32 table and 2**21 ids, gathered and summed by K1 as a fixed-hotness
   lookup of hotness 64 (``backend="auto"``): 32,768 bags, so the output
   (32 MiB) is small beside the 2 GiB of rows read, as in the JAX script,
   whose probe fuses into its gather and writes no rows out. At hotness 1
   K1 would write every row out and the output stream, not the table's
   place in the cache, would set the rate. The sizes are the JAX script's
   plus points around the H100's 50 MB L2;
2. ``pack_relayout_gbps``: ``pack_narrow`` of a 2**20 x 32 fp32 table, in
   lane-padded bytes per second as the JAX script counts them, with its
   positional lane scale in the probe;
3. ``tiering_ab``: ``backend="tiered"`` (with the calibrated config) against
   ``backend="xla"`` (the plain version) on the JAX script's (hotness,
   positions) grid over a 1M x 128 fp32 table.

It prints each measurement and the derived constants, and writes the raw
record (with the card's ``nvidia-smi`` name and power limit) to ``--out``,
by default ``cuembed_tpu_torch/data/chip_constants_<kind>.json``, the record
:func:`~cuembed_tpu_torch.utils.chip.chip_constants` loads on that card.
``--quick`` measures a smaller grid. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from cuembed_tpu_torch.ops.api import embedding_lookup
from cuembed_tpu_torch.ops.narrow import pack_narrow
from cuembed_tpu_torch.types import CombineMode
from cuembed_tpu_torch.utils.benchmarking import bump_from, carry_probe, robust_chain_time
from cuembed_tpu_torch.utils.calibration import calibrate_powerlaw_workload
from cuembed_tpu_torch.utils.chip import data_dir, derive_chip_constants, device_kind, kind_slug

GATHER_WIDTH = 256
GATHER_IDS = 1 << 21
GATHER_HOTNESS = 64
GATHER_MB = [4, 16, 32, 48, 64, 96, 112, 144, 256]
GATHER_MB_QUICK = [4, 48, 144]
PACK_ROWS, PACK_WIDTH = 1 << 20, 32
AB_ROWS, AB_WIDTH = 1_000_000, 128
AB_HOTNESS, AB_POSITIONS = [1, 2, 4, 8], [8192, 16384, 32768, 65536]
AB_HOTNESS_QUICK, AB_POSITIONS_QUICK = [1, 8], [8192, 65536]


def _timed(step, *operands, iters=6) -> float:
    device = operands[0].device
    x0 = (torch.zeros((), dtype=torch.int32, device=device),
          torch.zeros((), dtype=torch.float32, device=device))
    st = robust_chain_time(step, x0, operands=operands, k_lo=1, k_hi=iters, repeats=3,
                           return_stats=True)
    return st["median"]


def _gather_step(carry, src, idx):
    i, dep = carry
    ii = (idx + bump_from(dep)) % src.shape[0]
    return (i + 1, carry_probe(embedding_lookup(src, ii.view(-1, GATHER_HOTNESS))))


def _pack_step(carry, raw, lane_scale):
    # The probe must not commute past the relayout: the positional lane
    # scale ties each element to its place in the packed line.
    i, dep = carry
    r = raw * (1.0 + bump_from(dep).to(torch.float32))
    return (i + 1, carry_probe(pack_narrow(r) * lane_scale))


def _lookup_step(backend, tiered):
    def step(carry, table, idx):
        i, dep = carry
        out = embedding_lookup(table, idx + bump_from(dep), mode=CombineMode.SUM,
                               backend=backend, tiered_cfg=tiered)
        return (i + 1, carry_probe(out))
    return step


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def measure(quick: bool = False, log=print) -> dict:
    """The raw record of the attached card (see the module's docstring)."""
    if not torch.cuda.is_available():
        raise RuntimeError("calibrate_chip measures the card and needs a CUDA device")
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    record = {"device_kind": device_kind(), "nvidia_smi": nvidia_smi_line()}

    with torch.no_grad():
        vmem = []
        for mb in GATHER_MB_QUICK if quick else GATHER_MB:
            rows = mb * 1024 * 1024 // (GATHER_WIDTH * 4)
            src = torch.randn((rows, GATHER_WIDTH), device=device, generator=gen)
            idx = torch.randint(0, rows, (GATHER_IDS,), device=device, generator=gen,
                                dtype=torch.int32)
            dt = _timed(_gather_step, src, idx)
            vmem.append({"mb": mb, "mrows_per_s": round(GATHER_IDS / dt / 1e6, 1)})
            log(f"gather from {mb:4d} MB: {GATHER_IDS / dt / 1e6:8.1f} M rows/s")
            del src, idx
        record["vmem_gather"] = vmem

        raw = torch.randn((PACK_ROWS, PACK_WIDTH), device=device, generator=gen)
        lane_scale = 1.0 + torch.arange(128, dtype=torch.float32, device=device)[None] / 128
        dt = _timed(_pack_step, raw, lane_scale)
        phys_bytes = PACK_ROWS * 128 * 4  # lane-padded source, as the JAX script counts
        record["pack_relayout_gbps"] = round(phys_bytes / dt / 1e9, 2)
        log(f"pack relayout: {record['pack_relayout_gbps']} GB/s")
        del raw

        table = torch.empty((AB_ROWS, AB_WIDTH), device=device).uniform_(-1, 1,
                                                                         generator=gen)
        pos_grid = AB_POSITIONS_QUICK if quick else AB_POSITIONS
        ab = []
        for h in AB_HOTNESS_QUICK if quick else AB_HOTNESS:
            cfg, idx_rm, _ = calibrate_powerlaw_workload(
                AB_ROWS, max(pos_grid) // h, h, 1.05, AB_WIDTH, 4, permute=True,
                seed=3, calib_batches=6)
            for positions in pos_grid:
                idx = torch.from_numpy(idx_rm[:positions // h]).to(device)
                t_t = _timed(_lookup_step("tiered", cfg), table, idx)
                t_x = _timed(_lookup_step("xla", None), table, idx)
                ab.append({"positions": positions, "hotness": h,
                           "tiered_ms": round(t_t * 1e3, 4), "xla_ms": round(t_x * 1e3, 4)})
                log(f"H={h:3d} pos={positions:6d}: tiered {t_t * 1e3:7.3f} ms vs "
                    f"xla {t_x * 1e3:7.3f} ms")
        record["tiering_ab"] = ab
    return record


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None)
    p.add_argument("--quick", action="store_true")
    args = p.parse_args(argv)
    record = measure(args.quick, log=lambda s: print(s, flush=True))
    print(json.dumps(derive_chip_constants(record), indent=1))
    out = args.out or os.path.join(
        data_dir(), f"chip_constants_{kind_slug(record['device_kind'])}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {out}")
    return record


if __name__ == "__main__":
    main()
