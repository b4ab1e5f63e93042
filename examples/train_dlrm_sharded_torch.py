#!/usr/bin/env python
"""Multi-rank DLRM training on the PyTorch/CUDA port: row-sharded tables
over a ``torch.distributed`` mesh.

The run of ``examples/train_dlrm_sharded.py``, with the same flags and
defaults, on ``cuembed_tpu_torch``:

  * embedding tables ROW-SHARDED over the ``model`` axis (each rank holds
    ``(model, None)`` blocks), the batch data-parallel over the same axis;
  * the forward served by the all-to-all router
    (:func:`cuembed_tpu_torch.parallel.alltoall_row_sharded_lookup`): ids
    bucketed by owner, two ``all_to_all_single`` exchanges, the combine on
    K1;
  * the dense towers trained by autograd, their gradients all-reduced over
    the ranks;
  * the tables updated by the ROUTED sparse optimizer
    (:func:`cuembed_tpu_torch.parallel.sharded_rowwise_adagrad_sparse_update`):
    (row, gradient row) pairs travel the same wire to the owning rank, which
    sums them on K3; the AdaGrad state is sharded with the table. No dense
    table gradient is made on any rank.

The weights come from one seed through ``models/dlrm.py::params_from_numpy``
(tables by the package's init law, the towers ``sqrt(2/in) N(0, 1)``), so
every rank, and any world size, starts from the same model.

Run it under ``torchrun`` (one card a rank, NCCL)::

    torchrun --nproc-per-node 4 examples/train_dlrm_sharded_torch.py

or let it start its own ranks (``--ranks N``; ranks that share one card, or
the CPU, use gloo)::

    python examples/train_dlrm_sharded_torch.py --ranks 4 [--device cpu]
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


def parse_args(argv=None) -> argparse.Namespace:
    """The run's flags: those of ``examples/train_dlrm_sharded.py``, plus
    the ranks and the device."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--tables", type=int, default=4)
    p.add_argument("--categories", type=int, default=100_000)
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--hotness", type=int, default=8)
    p.add_argument("--alpha", type=float, default=1.15)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks to start (default: torchrun's, else 1)")
    p.add_argument("--device", default=None,
                   help="'cuda' (default, with a card) or 'cpu'")
    return p.parse_args(argv)


SEED = 0


def numpy_params(args) -> dict:
    """The model's parameters in the JAX ``DLRM.init`` layout, as numpy,
    from ``SEED``."""
    import torch

    from cuembed_tpu_torch.types import init_table_

    rng = np.random.default_rng(SEED)
    gen = torch.Generator().manual_seed(SEED)
    tables = [init_table_(torch.empty((args.categories, args.width)), gen).numpy()
              for _ in range(args.tables)]

    def mlp(dims):
        return [{"w": (rng.standard_normal((dims[i], dims[i + 1]))
                       * (2.0 / dims[i]) ** 0.5).astype(np.float32),
                 "b": np.zeros(dims[i + 1], np.float32)} for i in range(len(dims) - 1)]

    n_feat = args.tables + 1
    return {"tables": tables, "bottom": mlp((16, 64, args.width)),
            "top": mlp((args.width + n_feat * (n_feat - 1) // 2, 64, 1))}


def train(args, device, record=()) -> dict:
    """Train on this rank (the process group is up); returns the global
    losses of every step and the examples per second, as every rank sees
    them. For each step in ``record`` it also returns, under ``"record"``,
    this rank's blocks (on the host) of what a replay of the step on one
    table needs: the ids, the pooled rows and their gradients (batch blocks
    over ``model``), and the tables and AdaGrad accumulators before and
    after the step (row blocks over ``model``), each a dict by table."""
    import torch
    import torch.distributed as dist

    from cuembed_tpu_torch.models.dlrm import DLRM, DLRMConfig, bce_with_logits, interaction
    from cuembed_tpu_torch.models.dlrm import params_from_numpy
    from cuembed_tpu_torch.parallel import (
        alltoall_row_sharded_lookup,
        local_block,
        make_mesh,
        pad_table_for_shards,
        sharded_rowwise_adagrad_sparse_update,
    )
    from cuembed_tpu_torch.utils.datagen import PowerLawGenerator

    n = dist.get_world_size()
    mesh = make_mesh(n_model=n, device_type=device.type)
    rows = ("model", None)
    cfg = DLRMConfig(table_sizes=(args.categories,) * args.tables, embed_width=args.width,
                     hotness=args.hotness, dense_features=16, bottom_mlp=(64, args.width),
                     top_mlp=(64, 1))
    model = DLRM(cfg, device=device)
    params_from_numpy(model, numpy_params(args))
    names = [f"t{i}" for i in range(args.tables)]
    tables = {nm: local_block(pad_table_for_shards(bag.weight.detach(), n), mesh,
                              rows).clone() for nm, bag in zip(names, model.bags)}
    del model.bags
    accums = {nm: torch.zeros(t.shape[0], device=device) for nm, t in tables.items()}
    dense_params = list(model.bottom.parameters()) + list(model.top.parameters())

    gens = {nm: PowerLawGenerator(args.categories - 1, args.hotness, args.alpha,
                                  seed=100 + i, permute=True)
            for i, nm in enumerate(names)}
    label_rng = np.random.default_rng(7)

    def block(x):
        return local_block(torch.from_numpy(x), mesh, rows).to(device)

    def host(d):
        return {nm: x.detach().cpu().clone() for nm, x in d.items()}

    losses, records = [], {}
    t0 = time.perf_counter()
    for step in range(args.steps):
        if step in record:
            records[step] = {"tables": host(tables), "accums": host(accums)}
        dense = block(label_rng.standard_normal((args.batch, 16)).astype(np.float32))
        label = block(label_rng.integers(0, 2, args.batch).astype(np.float32)[:, None])[:, 0]
        idx = {nm: block(g.sample(args.batch).astype(np.int32)) for nm, g in gens.items()}
        with torch.no_grad():
            pooled = {nm: alltoall_row_sharded_lookup(tables[nm], idx[nm], mesh=mesh)
                      for nm in names}
        leaves = [pooled[nm].requires_grad_() for nm in names]
        logits = model.top(interaction(model.bottom(dense), leaves), final_linear=True)[:, 0]
        # This rank's share of the global mean loss.
        loss = bce_with_logits(logits, label).sum() / args.batch
        grads = torch.autograd.grad(loss, dense_params + leaves)
        with torch.no_grad():
            flat = torch.cat([g.reshape(-1) for g in grads[:len(dense_params)]] + [
                loss.detach().reshape(1)])
            dist.all_reduce(flat)
            k = 0
            for p_ in dense_params:
                p_.sub_(args.lr * flat[k:k + p_.numel()].view_as(p_))
                k += p_.numel()
        for nm, g in zip(names, grads[len(dense_params):]):
            sharded_rowwise_adagrad_sparse_update(tables[nm], accums[nm], idx[nm], g,
                                                  mesh=mesh, lr=args.lr)
        losses.append(float(flat[-1]))
        if step in record:
            records[step].update(
                ids=host(idx), pooled=host(pooled), grads=host(dict(zip(
                    names, grads[len(dense_params):]))),
                tables_after=host(tables), accums_after=host(accums))
        if dist.get_rank() == 0 and (step % 5 == 0 or step == args.steps - 1):
            print(f"step {step:4d}  loss {losses[-1]:.4f}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = args.steps * args.batch / dt
    if dist.get_rank() == 0:
        print(f"{args.steps} steps on {n} ranks ({dist.get_backend()}, {device}) in "
              f"{dt:.2f}s ({rate:.0f} examples/s)")
    return {"losses": losses, "rate": rate, "record": records}


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
        return torch.load(out)


if __name__ == "__main__":
    main()
