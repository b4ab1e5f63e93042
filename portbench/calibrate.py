"""The readings the limits are set from, on the card at a cell's own size, in
one process: the program's numbers over many seeds (the lower readings), the
control's (the upper ones) and each planted fault's.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--faults half_batch,altered] --seconds 10 \
        --out cal_<name>.json

Give ``--seconds`` the benchmark's ``run_seconds``: a training cell's numbers
over the whole run grow with its count of steps.

The control is the step below the configuration's stated precision: for a
served cell the program's own half-precision sums (``low_precision_math``
on the checked requests, the same K1); for a training cell the reference put
in the program's place and computed in bfloat16. The benchmark's own runs do
none of this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import check, faults, harness  # noqa: E402
from portbench.tracing import Tracer  # noqa: E402


def run_loop(workload, seed, seconds, *, root=ROOT, device="cuda"):
    """A cell's loop after its set-up and a window of ``seconds``."""
    cell = harness.resolve(root, workload, seed, device)
    loop = harness.make_loop(cell, Tracer(False))
    loop.setup()
    loop.window(seconds)
    loop.close()
    return cell, loop


def control_numbers(cell, loop):
    """The check's numbers with the control in the program's place."""
    if cell.traffic["loop"] == "serve":
        from cuembed_tpu_torch.ops.api import embedding_lookup

        for q in loop.saved:
            s, n = loop.starts[q], loop.sizes[q]
            loop.saved[q] = {name: embedding_lookup(t, ids[s:s + n], low_precision_math=True)
                             for name, t, ids in zip(loop.names, loop.tables, loop.ids)}
        loop.free_program()
        return loop.numbers()
    loop.free_program()
    ref = loop.reference()
    ctl = loop.reference(dtype=torch.bfloat16)
    return check.train_numbers(ctl, ref)


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    out = {"workload": a.workload, "kind": torch.cuda.get_device_name(), "program": {},
           "control": {}, "faults": {}}

    def save():
        Path(a.out).write_text(json.dumps(out, indent=1))

    for kind, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t0 = time.time()
            cell, loop = run_loop(a.workload, seed, a.seconds)
            if kind == "program":
                loop.free_program()
                nums = loop.numbers()
            else:
                nums = control_numbers(cell, loop)
            del cell, loop
            _free()
            out[kind][str(seed)] = nums
            print(f"[{kind} {seed}] {time.time() - t0:.1f} s {nums}", flush=True)
            save()
    for fault in [f for f in a.faults.split(",") if f]:
        for seed in [int(s) for s in a.control_seeds.split(",") if s]:
            t0 = time.time()
            with faults.planted(fault):
                cell, loop = run_loop(a.workload, seed, a.seconds)
                loop.free_program()
                nums = loop.numbers()
            del cell, loop
            _free()
            out["faults"].setdefault(fault, {})[str(seed)] = nums
            print(f"[{fault} {seed}] {time.time() - t0:.1f} s {nums}", flush=True)
            save()
    save()


if __name__ == "__main__":
    main()
