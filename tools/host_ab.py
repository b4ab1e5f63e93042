#!/usr/bin/env python3
"""Host times of the port's small request and training steps on one GPU.

    python3 tools/host_ab.py [--label NAME] [--requests N] [--passes N] [--steps N]

Times, as ``chip_smoke.py`` does and with its functions: ``--requests``
EmbeddingBag requests at BASELINE.json config 1 (100K x 32 fp32, batch
1024, hotness 8, uniform ids), host clock to a synchronize, in
``--passes`` passes after a warm-up pass; the host time a request takes to
enqueue its work, without a synchronize (the same requests issued back to
back, the clock read before the queue drains); K1's device time on that
request (CUDA events, L2 warm); the host time of one ``launch_plan`` call
where the checkout has one; the enqueue time by layer, the layers in
turns (the module request, the K1 wrapper, and the wrapper's C call alone
on its recorded arguments, ``cuembed_fixed_forward_many`` with one
descriptor, or ``cuembed_fixed_forward`` in a checkout before it); then,
unless ``--steps 0``, the flagship dense step (autograd +
``torch.optim.SGD``) and row-wise AdaGrad step on a 10M x 256 bf16 table
(``chip_smoke.step_timings``: two warm-up steps, medians of ``--steps``,
and a ``torch.profiler`` breakdown of each). It prints one ``[host_ab]``
line of medians.

To tell a change from the host's noise, run it from two checkouts in turns
in one call, e.g. for an earlier commit unpacked (``git archive``) into
``_checkout/parent`` with this file copied into its ``tools/``:
``for c in parent . . parent parent .; do (cd _checkout/$c && python3
tools/host_ab.py --label $c); done`` (with ``.`` as the repository's root).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import cuembed_tpu_torch as tce  # noqa: E402
from cuembed_tpu_torch.ops import _build, cuda_forward  # noqa: E402
from cuembed_tpu_torch.utils import benchmarking as bench  # noqa: E402
from cuembed_tpu_torch.utils.datagen import PowerLawGenerator  # noqa: E402


def layer_times(bag, batches, rounds=5):
    """Host ms a call takes to enqueue, by layer (medians of ``rounds``
    passes over ``batches``, the layers in turns): the module request, the
    K1 wrapper, and the C call the wrapper makes, replayed on its recorded
    arguments."""
    table = bag.weight.detach()
    lib = _build.load_library()
    recorded = {}

    class Recorder:
        def __getattr__(self, name):
            def call(*args):
                recorded[name] = args
                return getattr(lib, name)(*args)
            return call

    load = _build.load_library
    _build.load_library = Recorder
    kept = cuda_forward.embedding_forward_cuda(table, batches[0])  # owns the recorded output
    _build.load_library = load
    entry = next(iter(recorded))  # K1's C entry point in this checkout
    c_call, c_args = getattr(lib, entry), recorded[entry]
    layers = {"module": bag,
              "wrapper": lambda idx: cuda_forward.embedding_forward_cuda(table, idx),
              "C call": lambda idx: c_call(*c_args)}
    times = {name: [] for name in layers}
    with torch.inference_mode():
        for _ in range(rounds):
            for name, fn in layers.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for idx in batches:
                    fn(idx)
                times[name].append((time.perf_counter() - t0) * 1e3 / len(batches))
    torch.cuda.synchronize()
    del kept
    return {name: statistics.median(t) for name, t in times.items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default=str(Path.cwd().name))
    parser.add_argument("--requests", type=int, default=20)
    parser.add_argument("--passes", type=int, default=2)
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("host_ab: no CUDA device is available")
    gen = torch.Generator(device="cuda").manual_seed(0)

    small = tce.EmbeddingBag(cs.SMALL_ROWS, cs.SMALL_WIDTH, dtype=torch.float32)
    small.reset_parameters(generator=gen)
    ids = PowerLawGenerator(cs.SMALL_ROWS - 1, cs.SMALL_HOTNESS, 0.0, seed=0, dtype=np.int64)
    batches = [torch.from_numpy(ids.sample(cs.SMALL_BATCH)).cuda()
               for _ in range(args.requests)]
    medians = [cs.serve(small, batches, f"{args.label} config 1")[1]
               for _ in range(args.passes + 1)][1:]
    enqueue = []
    with torch.inference_mode():
        for _ in range(args.passes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for idx in batches:
                small(idx)
            enqueue.append((time.perf_counter() - t0) * 1e3 / len(batches))
            torch.cuda.synchronize()
    table = small.weight.detach()
    dev = bench.cuda_time_ms(lambda: cuda_forward.embedding_forward_cuda(table, batches[-1]),
                             flush_l2=False)
    plan_ms = "none"
    if hasattr(cuda_forward, "launch_plan"):
        t0 = time.perf_counter()
        for _ in range(10_000):
            cuda_forward.launch_plan(8, cs.SMALL_BATCH, csr=False, weighted=False)
        plan_ms = f"{(time.perf_counter() - t0) * 1e3 / 10_000:.6f} ms"
    layers = layer_times(small, batches)
    del small, table, batches

    bag = tce.EmbeddingBag(cs.NUM_ROWS, cs.WIDTH, dtype=torch.bfloat16)
    bag.reset_parameters(generator=gen)
    big = PowerLawGenerator(cs.NUM_ROWS - 1, cs.HOTNESS, cs.ALPHA, permute=True, seed=0,
                            dtype=np.int64)
    idx = torch.from_numpy(big.sample(cs.BATCH)).cuda()
    steps = ({"dense step": float("nan"), "adagrad step": float("nan")} if not args.steps
             else cs.step_timings(bag, idx, steps=args.steps))
    print(f"[host_ab] {args.label}: enqueue ms by layer: "
          + ", ".join(f"{name} {ms:.4f}" for name, ms in layers.items()))
    print(f"[host_ab] {args.label}: config 1 request median "
          f"{statistics.median(medians):.4f} ms (passes {[round(m, 4) for m in medians]}), "
          f"enqueued in {statistics.median(enqueue):.4f} ms "
          f"({[round(m, 4) for m in enqueue]}), K1 {dev:.4f} ms on the device, "
          f"launch plan {plan_ms}; dense step {steps['dense step']:.4f} ms; adagrad step {steps['adagrad step']:.4f} ms; {cs.nvidia_smi_line()}")


if __name__ == "__main__":
    main()
