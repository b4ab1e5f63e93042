#!/usr/bin/env python
"""End-to-end DLRM training demo on the PyTorch/CUDA port.

The same run as ``examples/train_dlrm.py``, with the same flags and
defaults, on ``cuembed_tpu_torch``:
  * an EmbeddingCollection, frequency calibration, table reordering and a
    host-side remap in the background input pipeline (the native C++ remap
    when ``native/libcuembed_host.so`` is built),
  * the dense towers trained by autograd; the pooled embeddings are
    detached, and their gradient feeds row-sparse AdaGrad on the tables
    (K1 forward and K3 compressed backward on the card, no dense table
    gradient).

Runs on the card by default, on the CPU with ``--device cpu``:
    python examples/train_dlrm_torch.py [--steps 20] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    """The run's flags: those of ``examples/train_dlrm.py``, plus ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--tables", type=int, default=4)
    p.add_argument("--categories", type=int, default=100_000)
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--hotness", type=int, default=8)
    p.add_argument("--alpha", type=float, default=1.15)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain path)")
    return p.parse_args(argv)


def main(argv=None) -> float:
    """Train and return the examples per second of the timed steps."""
    args = parse_args(argv)

    import torch

    from cuembed_tpu_torch import EmbeddingCollection, TableConfig, native
    from cuembed_tpu_torch.models.dlrm import MLP, bce_with_logits, interaction
    from cuembed_tpu_torch.types import default_device
    from cuembed_tpu_torch.utils.datagen import PowerLawGenerator
    from cuembed_tpu_torch.utils.pipeline import InputPipeline, to_device

    device = default_device(args.device)
    names = [f"t{i}" for i in range(args.tables)]
    coll = EmbeddingCollection(
        [
            TableConfig(n, args.categories, args.width, hotness=args.hotness)
            for n in names
        ]
    )
    tables = coll.init(torch.Generator(device=device).manual_seed(0), device=device)
    accums = coll.adagrad_init(device=device)
    bottom = MLP((16, 64, args.width), device=device)
    bottom.reset_parameters(torch.Generator(device=device).manual_seed(1))
    n_feat = args.tables + 1
    top = MLP((args.width + n_feat * (n_feat - 1) // 2, 64, 1), device=device)
    top.reset_parameters(torch.Generator(device=device).manual_seed(2))
    dense_params = list(bottom.parameters()) + list(top.parameters())

    gens = {
        n: PowerLawGenerator(
            args.categories - 1, args.hotness, args.alpha,
            seed=100 + i, permute=True,
        )
        for i, n in enumerate(names)
    }
    label_rng = np.random.default_rng(7)

    # Frequency calibration + reorder before training (production would
    # refresh this periodically from running counts).
    counts = coll.init_counts()
    for _ in range(4):
        counts = coll.update_counts(
            counts, {n: g.sample(args.batch) for n, g in gens.items()}
        )
    tables, remaps = coll.reorder(tables, counts)

    def source():
        return {
            "dense": label_rng.standard_normal((args.batch, 16)).astype(
                np.float32
            ),
            "label": label_rng.integers(0, 2, args.batch).astype(np.float32),
            **{n: g.sample(args.batch).astype(np.int32) for n, g in gens.items()},
        }

    def train_step(batch):
        idx = {n: batch[n] for n in names}
        with torch.no_grad():
            pooled = coll.apply(tables, idx)
        leaves = [pooled[n].requires_grad_() for n in names]
        logits = top(interaction(bottom(batch["dense"]), leaves), final_linear=True)[:, 0]
        loss = torch.mean(bce_with_logits(logits, batch["label"]))
        grads = torch.autograd.grad(loss, dense_params + leaves)
        with torch.no_grad():
            for p_, g in zip(dense_params, grads):
                p_.sub_(args.lr * g)
        coll.adagrad_update(tables, accums, idx,
                            dict(zip(names, grads[len(dense_params):])), lr=args.lr)
        return loss.detach()

    with InputPipeline(
        source, remap={n: remaps[n] for n in names}, depth=2,
        device_put=to_device(device),
    ) as pipe:
        t0 = time.perf_counter()
        for step in range(args.steps):
            loss = train_step(pipe.get())
            if step % 5 == 0 or step == args.steps - 1:
                print(f"step {step:4d}  loss {float(loss):.4f}")
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    rate = args.steps * args.batch / dt
    print(
        f"{args.steps} steps in {dt:.2f}s ({rate:.0f} examples/s) on {device}; "
        f"native host library: {'loaded' if native.AVAILABLE else 'not built (numpy)'}"
    )
    return rate


if __name__ == "__main__":
    main()
