"""A multi-rank dry run: one DLRM training step, row-sharded over a
``(data, model)`` mesh of N ranks, the counterpart of
``__graft_entry__.py::dryrun_multichip``.

Tables row-shard over ``model`` (masked local lookups and an all-reduce,
:func:`~cuembed_tpu_torch.parallel.row_sharded_lookup`; table 0 with a
local tiered config, table 1 on the plain path), the batch shards over
``data``, the dense towers are replicated and their gradients all-reduced.
Then the all-to-all routed lookup on a flat ``model`` mesh, forward and
backward, is held to the unsharded lookup and its gradient. Small shapes:
this checks that the layer's collectives and gradients line up on N ranks,
not speed.

    python -m cuembed_tpu_torch.parallel.dryrun 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from cuembed_tpu_torch.models.dlrm import DLRM, DLRMConfig, bce_with_logits, interaction
from cuembed_tpu_torch.ops.tiered import TieredConfig
from cuembed_tpu_torch.parallel.alltoall_lookup import alltoall_row_sharded_lookup
from cuembed_tpu_torch.parallel.sharded_lookup import row_sharded_lookup
from cuembed_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_size,
    batch_sharding,
    local_block,
    make_mesh,
    pad_table_for_shards,
    table_sharding,
)
from cuembed_tpu_torch.types import default_device


def step(device: torch.device) -> dict:
    """One DLRM step and the routed lookup's parity on this rank (the
    process group is up). Returns the step's global loss and the largest
    errors of the routed forward and gradient against the unsharded ones;
    raises if the loss is not finite or a parity check fails."""
    world = dist.get_world_size()
    mesh = make_mesh(device_type=device.type)
    n_model, n_data = axis_size(mesh, MODEL_AXIS), axis_size(mesh, DATA_AXIS)
    cfg = DLRMConfig(table_sizes=(64 * n_model,) * 2, embed_width=64, hotness=4,
                     dense_features=8, bottom_mlp=(32, 64), top_mlp=(32, 1))
    model = DLRM(cfg, device=device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(0))
    tables = [local_block(pad_table_for_shards(bag.weight.detach(), n_model), mesh,
                          table_sharding(mesh)).clone().requires_grad_()
              for bag in model.bags]
    batch = 8 * n_data
    rng = np.random.default_rng(0)
    bspec = batch_sharding(mesh) + (None,)

    def block(x):
        return local_block(torch.from_numpy(x), mesh, bspec).to(device)

    dense = block(rng.standard_normal((batch, cfg.dense_features)).astype(np.float32))
    sparse = [block(rng.integers(0, v, (batch, cfg.hotness)).astype(np.int32))
              for v in cfg.table_sizes]
    labels = block(rng.integers(0, 2, batch).astype(np.float32)[:, None])[:, 0]
    tiny_tiered = TieredConfig(hot_rows=32, chunk_elems=16, cold_slots=16,
                               mxu_head_rows=8, mid_slots=16)
    emb = [row_sharded_lookup(t, idx, mesh=mesh, backend="xla" if i else "auto",
                              tiered_cfg=None if i else tiny_tiered)
           for i, (t, idx) in enumerate(zip(tables, sparse))]
    logits = model.top(interaction(model.bottom(dense), emb), final_linear=True)[:, 0]
    # This rank's share of the global mean; the model replicas hold the same
    # share, so the sum over the data axis is the loss.
    loss = bce_with_logits(logits, labels).sum() / batch
    dense_params = list(model.parameters())
    grads = torch.autograd.grad(loss, dense_params + tables, allow_unused=True)
    n_dense = len(dense_params)
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(dense_params + tables, grads)):
            if g is None:
                continue
            if i < n_dense:  # replicated towers: the data axis's shares
                dist.all_reduce(g, group=mesh.get_group(DATA_AXIS))
            p.sub_(0.01 * g)
        total = loss.detach().reshape(1).clone()
        dist.all_reduce(total, group=mesh.get_group(DATA_AXIS))
    if not torch.isfinite(total).all():
        raise RuntimeError(f"non-finite loss: {total.item()}")

    # The all-to-all routed lookup on a flat mesh, forward and backward,
    # against the unsharded lookup on the whole table.
    flat = make_mesh(n_model=world, device_type=device.type)
    rows = 64 * world
    t_np = rng.standard_normal((rows, 32)).astype(np.float32)
    ix_np = rng.integers(0, rows, (8 * world, 4)).astype(np.int32)
    spec = (MODEL_AXIS, None)
    t = local_block(torch.from_numpy(t_np), flat, spec).to(device).requires_grad_()
    ix = local_block(torch.from_numpy(ix_np), flat, spec).to(device)
    out = alltoall_row_sharded_lookup(t, ix, mesh=flat)
    (out ** 2).sum().backward()
    whole = torch.from_numpy(t_np).to(device).requires_grad_()
    ref = whole[torch.from_numpy(ix_np).to(device).long()].sum(dim=1)
    (ref ** 2).sum().backward()
    ref_out = local_block(ref.detach(), flat, spec)
    ref_g = local_block(whole.grad, flat, spec)
    fwd_err = (out.detach() - ref_out).abs().max().item()
    grad_err = (t.grad - ref_g).abs().max().item()
    if not (torch.allclose(out.detach(), ref_out, rtol=1e-5, atol=1e-5)
            and torch.allclose(t.grad, ref_g, rtol=1e-4, atol=1e-4)):
        raise RuntimeError(f"routed lookup off the unsharded one: forward {fwd_err}, "
                           f"gradient {grad_err}")
    return {"device": str(device), "loss": total.item(), "mesh": (n_data, n_model),
            "forward_err": fwd_err, "grad_err": grad_err}


def _rank(rank: int, world: int, store: str, device_type: str) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        result = step(torch.device(device_type))
        if rank == 0:
            print(f"dryrun on {world} ranks: {result}")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device_type: str | None = None) -> None:
    """Run :func:`step` on ``n_devices`` gloo ranks started here (on the
    card unless ``device_type="cpu"``; without a card it must be given);
    raises if any rank fails."""
    device_type = default_device(device_type).type
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_rank, args=(n_devices, os.path.join(tmp, "store"),
                                                 device_type), nprocs=n_devices, join=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="one sharded DLRM step on N ranks")
    parser.add_argument("n", type=int)
    parser.add_argument("--device", default=None)
    a = parser.parse_args()
    dryrun_multichip(a.n, a.device)
