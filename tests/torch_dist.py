"""Spawned gloo ranks for the port's multi-rank tests.

``run_ranks(path, name, world, tmp_path)`` starts ``world`` Python processes,
each of which joins a gloo process group through a ``file://`` store under
``tmp_path`` (no port, so parallel test workers cannot collide), imports the
test module at ``path`` and calls ``name(rank, world, tmp_path)``. What the
function returns is saved with ``torch.save`` and handed back to the parent,
one entry a rank. The ranks import torch and the port only (the test module
must import JAX inside its functions, not at the top).

Every run has a deadline: the group's own timeout for a collective, and the
parent's for the whole run. A rank that fails or a run past its deadline
terminates every rank and fails the test, with each rank's output.

Run as a script, this file is the rank's entry point.
"""

from __future__ import annotations

import datetime
import importlib.util
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COLLECTIVE_TIMEOUT_S = 60


def run_ranks(path, name: str, world: int, tmp_path, *, timeout: float = 120.0):
    """Run ``name`` from the module at ``path`` on ``world`` gloo ranks and
    return their results, rank 0 first."""
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(path), name, str(r), str(world), str(tmp)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
        for r in range(world)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the ranks ran past their {timeout:.0f} s deadline"
                break
            time.sleep(0.05)
        else:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    out = []
    for log in logs:
        log.seek(0)
        out.append(log.read())
        log.close()
    if failed:
        text = "\n".join(f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(out))
        raise AssertionError(f"{failed}\n{text}")
    import torch

    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _main(path, name, rank, world, tmp):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        spec = importlib.util.spec_from_file_location(f"_ranks_{Path(path).stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        result = getattr(module, name)(rank, world, Path(tmp))
        torch.save(result, Path(tmp) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        _main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
