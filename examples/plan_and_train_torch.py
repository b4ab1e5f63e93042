#!/usr/bin/env python
"""Planner-driven multi-table training on the PyTorch/CUDA port: calibrate
-> plan -> train.

The run of ``examples/plan_and_train.py``, with the same flags, tables,
id generators and demo cost model, on ``cuembed_tpu_torch``:

  1. describe the tables (:class:`cuembed_tpu_torch.collection.TableConfig`),
  2. collect frequency statistics from calibration traffic
     (``EmbeddingCollection.update_counts``),
  3. let the placement planner choose per table — replicated / row-sharded
     / hybrid — from the cost model (``EmbeddingCollection.plan_placement``
     -> :mod:`cuembed_tpu_torch.parallel.planner`),
  4. cut each rank's blocks (``apply_plan``) and train with the
     placement-aware lookup and sparse AdaGrad (``planned_lookup`` /
     ``planned_adagrad_update``): every table takes its own path (K1 and K3
     on the card), no dense table gradient anywhere.

The tables route over the ``model`` axis of the world (a ``(1, n)`` mesh);
every rank draws the same global batch and keeps its block. Run it under
``torchrun`` (one card a rank, NCCL)::

    torchrun --nproc-per-node 4 examples/plan_and_train_torch.py [--steps 5]

or let it start its own ranks (ranks that share one card, or the CPU, use
gloo)::

    python examples/plan_and_train_torch.py --ranks 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

LR = 0.05


def parse_args(argv=None) -> argparse.Namespace:
    """The run's flags: those of ``examples/plan_and_train.py``, plus the
    ranks and the device."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks to start (default: torchrun's, else 1)")
    p.add_argument("--device", default=None,
                   help="'cuda' (default, with a card) or 'cpu'")
    return p.parse_args(argv)


def table_configs():
    """1. The tables: one small (will replicate), one big uniform
    (row-sharded), one big skewed (hybrid once stats prove it)."""
    from cuembed_tpu_torch.collection import TableConfig

    return [
        TableConfig("genre", 512, 32, hotness=2, traffic_share=1.0),
        TableConfig("item", 200_000, 32, hotness=4, traffic_share=1.0),
        TableConfig("user", 200_000, 32, hotness=4, traffic_share=2.0),
    ]


def train(args, device, record=()) -> dict:
    """Calibrate, plan and train on this rank (the process group is up).
    Returns the plan, each step's pooled norm (global, the same on every
    rank) and, for each step in ``record``, this rank's blocks (on the
    host) of what a replay of the step on one table needs: the ids and the
    pooled rows (batch blocks over ``model``), and the tables and AdaGrad
    accumulators before and after the step (hybrid ones as (head, tail)
    pairs), each a dict by table."""
    import torch
    import torch.distributed as dist

    from cuembed_tpu_torch.collection import EmbeddingCollection
    from cuembed_tpu_torch.parallel import (
        CostModel,
        apply_plan,
        local_block,
        make_mesh,
        planned_adagrad_init,
        planned_adagrad_update,
        planned_lookup,
    )
    from cuembed_tpu_torch.utils.datagen import PowerLawGenerator

    n = dist.get_world_size()
    mesh = make_mesh(n_model=n, device_type=device.type)
    B = args.batch - args.batch % n or n

    coll = EmbeddingCollection(table_configs())

    # 2. Frequency statistics from calibration traffic. ids land in
    #    [1, V-1] (the generator reserves 0 for "missing").
    gens = {
        "genre": PowerLawGenerator(511, 2, 0.0, seed=1),
        "item": PowerLawGenerator(199_999, 4, 0.0, seed=2),   # uniform
        "user": PowerLawGenerator(199_999, 4, 1.3, seed=3),   # skewed
    }
    # Enough calibration volume that distinct-category counts exceed the
    # candidate head sizes (head_hit_rates refuses to judge skew from a
    # sample too small to tell uniform from zipf).
    counts = coll.init_counts()
    for _ in range(16):
        counts = coll.update_counts(counts, {k: g.sample(4096) for k, g in gens.items()})

    # 3. Plan: a demo cost model so that every strategy appears at toy
    #    scale (the defaults are the H100's).
    plan = coll.plan_placement(n, batch=65536, counts=counts,
                               cost=CostModel(replicate_bytes_max=1 << 20),
                               hot_bytes_total=8 << 20)
    if dist.get_rank() == 0:
        print(plan.summary())

    # 4. Frequency-order the hybrid tables and cut this rank's blocks.
    tables = coll.init(torch.Generator(device=device).manual_seed(0), device=device)
    hybrid = [t.name for t in plan.tables.values() if t.placement == "hybrid"]
    remaps = {}
    if hybrid:
        tables_r, remaps_all = coll.reorder(tables, counts)
        tables.update({k: tables_r[k] for k in hybrid})
        remaps = {k: remaps_all[k] for k in hybrid}
    placed = apply_plan(plan, tables, mesh)
    del tables
    accums = planned_adagrad_init(plan, placed, mesh)

    def host(d):
        return {k: tuple(x.cpu().clone() for x in v) if isinstance(v, tuple)
                else v.detach().cpu().clone() for k, v in d.items()}

    norms, records = [], {}
    for step in range(args.steps):
        if step in record:
            records[step] = {"tables": host(placed), "accums": host(accums)}
        idx = {}
        for k, g in gens.items():
            raw = g.sample(B)
            if k in remaps:  # the id remap belongs in the input pipeline
                raw = remaps[k][raw]
            idx[k] = local_block(torch.from_numpy(raw), mesh, ("model", None)).to(device)
        t0 = time.perf_counter()
        pooled = planned_lookup(plan, placed, idx, mesh=mesh)
        # toy loss: L2 on the pooled embeddings => grad_y = 2 * pooled
        gys = {k: 2.0 * v for k, v in pooled.items()}
        placed, accums = planned_adagrad_update(plan, placed, accums, idx, gys, mesh=mesh,
                                                lr=LR)
        norm = sum((v.float() ** 2).sum() for v in pooled.values()).reshape(1)
        dist.all_reduce(norm)
        norms.append(float(norm))
        if step in record:
            records[step].update(ids=host(idx), pooled=host(pooled), tables_after=host(placed),
                                 accums_after=host(accums))
        if dist.get_rank() == 0:
            print(f"step {step}: pooled-norm {norms[-1]:10.1f}  "
                  f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")
    if dist.get_rank() == 0:
        print("done — placements:", {t.name: t.placement for t in plan.tables.values()})
    return {"plan": plan, "norms": norms, "record": records}


def _device(args, local_rank: int):
    import torch

    from cuembed_tpu_torch.types import default_device

    device = default_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def _backend(args, world: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    import torch

    own_cards = torch.cuda.is_available() and world <= torch.cuda.device_count()
    return "nccl" if own_cards and args.device != "cpu" else "gloo"


def rank_main(rank: int, world: int, store: str, argv, out: str | None = None) -> dict:
    """One started rank: join the group through the file ``store``, train,
    and leave; rank 0 writes its result to ``out`` when given."""
    import torch
    import torch.distributed as dist

    args = parse_args(argv)
    device = _device(args, rank)
    if device.type == "cpu":  # ranks that share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(_backend(args, world), init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        result = train(args, device)
        if out is not None and rank == 0:
            torch.save(result, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return result


def main(argv=None) -> dict:
    """Train under torchrun, or on ``--ranks`` ranks this starts; returns
    rank 0's result."""
    import torch

    args = parse_args(argv)
    if "WORLD_SIZE" in os.environ:  # started by torchrun
        from cuembed_tpu_torch.parallel import multihost

        world = int(os.environ["WORLD_SIZE"])
        device = _device(args, int(os.environ.get("LOCAL_RANK", 0)))
        multihost.initialize(backend=_backend(args, world))
        try:
            return train(args, device)
        finally:
            torch.distributed.destroy_process_group()
    world = args.ranks or 1
    with tempfile.TemporaryDirectory() as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "result.pt")
        if world == 1:
            return rank_main(0, 1, store, argv)
        torch.multiprocessing.spawn(rank_main, args=(world, store, argv, out),
                                    nprocs=world, join=True)
        return torch.load(out, weights_only=False)


if __name__ == "__main__":
    main()
