"""The benchmark's general part: it finds a cell's configuration, traffic mix,
limits and metric readers by the names in ``BENCHMARK.json``, runs the mix's
loop (``portbench/loops/<loop>.py``) against the program, checks what the
timed path produced, and builds the result line.

Data lives under the benchmark root: ``BENCHMARK.json``, the configuration
``file`` it names, ``portbench/traffic/<traffic>.json`` and
``portbench/limits/<workload>.json``. Code lives beside this file: the
loops, the references and ``portbench/metrics/<metric>.py``, one reader a
per-layer metric. A cell that reuses a loop needs data files only.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from portbench import check
from portbench.tracing import Tracer, idle_by_span, top_device_ops, union_s

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cuembed_tpu")
DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    workload: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    seed: int
    device: torch.device

    @property
    def width(self) -> int:
        return int(self.config["embedding_dim"])

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.config["dtype"]]

    @property
    def tables(self) -> list:
        """``(rows, hotness)`` of each table, in the configuration's order."""
        return list(zip(self.config["num_embeddings_per_feature"], self.config["multi_hot_sizes"]))


def _listed(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def resolve(root: Path, workload: str, seed: int, device) -> Cell:
    """The cell called ``workload`` in ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    data = root / HERE.name
    return Cell(
        workload=workload,
        config=json.loads((root / configs[w["config"]]["file"]).read_text()),
        traffic=json.loads((data / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((data / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _listed(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _listed(m, workload)],
        seed=seed,
        device=torch.device(device),
    )


def make_loop(cell: Cell, tracer: Tracer):
    """The traffic mix's loop (``portbench/loops/<loop>.py``) for the cell."""
    return importlib.import_module(f"portbench.loops.{cell.traffic['loop']}").Loop(cell, tracer)


def process_start() -> float:
    """The process's start on ``time.time()``'s clock (Linux ``/proc``)."""
    ticks = os.sysconf("SC_CLK_TCK")
    start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return time.time() - uptime + start


def reader(name: str):
    """The per-layer metric reader ``portbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(cell: Cell, peak: int) -> dict:
    if cell.device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(cell.device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def run_cell(root: Path, workload: str, *, seed: int, seconds: float, trace: bool,
             device="cuda", started: float | None = None) -> dict:
    """Run one cell; return the result line's object (``checks`` last).

    A traced run measures two windows of ``seconds``: one untraced, whose
    host-clock records the per-layer readers of host time take
    (``host_records``), then one under the profiler for the device's."""
    started = process_start() if started is None else started
    cell = resolve(root, workload, seed, device)
    tracer = Tracer(trace)
    loop = make_loop(cell, tracer)
    loop.setup()
    setup_s = time.time() - started - loop.check_setup_s
    gc.collect()
    gc.freeze()  # the window's collections skip what set-up left
    if trace:  # the host-clock readings come from a window the profiler does not slow
        loop.window(seconds)
        host_records = loop.records
    with tracer.window():
        loop.window(seconds)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    loop.close()
    info = device_info(cell, peak)
    result = {"attempted": loop.attempted, "failed": loop.failed}
    if trace:
        ev = tracer.events
        if ev is not None and cell.device.type == "cuda":
            lo, hi = ev.window
            info["busy_s"] = union_s([(s, e) for _, s, e, _ in ev.device], lo, hi)
            info["window_s"] = (hi - lo) / 1e6
            result["breakdown"] = {
                "device_ops": top_device_ops(ev),
                "idle_gaps": idle_by_span(ev, loop.LEAF_SPANS, loop.PARENT_SPANS)[:10]}
        ctx = dict(loop.layer_context(ev), host_records=host_records)
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(loop.end_to_end(), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
        result["asides"] = loop.asides()
    loop.free_program()
    correct, checks = check.verdict(loop.numbers(), cell.limits)
    result.update(correct=correct, metrics=metrics, device=info, checks=checks)
    order = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "asides",
             "checks")
    return {k: result[k] for k in order if k in result}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = process_start()
    root = HERE.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s): this benchmark measures the card",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), started=started)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value in result.get("asides", {}).items():
        print(f"aside {name} = {value!r}", file=sys.stderr)
    check.print_checks(result["checks"], result["correct"])
    print(json.dumps(result))
    return 0
