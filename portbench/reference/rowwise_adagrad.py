"""Row-wise AdaGrad on a pooled SUM lookup, plainly, in ``dtype``.

For a batch ``ids [batch, hotness]`` with pooled-output gradient
``grad_y [batch, width]``, row ``r``'s gradient is
``G_r = sum over positions (b, j) with ids[b, j] == r of grad_y[b]``; then
``acc[r] += mean(G_r^2)`` and ``table[r] -= lr * G_r / sqrt(acc[r] + eps)``,
the table rounded to its storage dtype once a step.
"""

from __future__ import annotations

import torch

BLOCK_IDS = 1 << 21  # positions summed at a time


def row_grads(ids: torch.Tensor, grad_y: torch.Tensor, dtype=torch.float64):
    """``(rows, G)``: the distinct ids ascending and their gradient rows."""
    batch, hotness = ids.shape
    flat = ids.reshape(-1)
    rows, inverse = torch.unique(flat, return_inverse=True)
    g = torch.zeros((rows.numel(), grad_y.shape[1]), dtype=dtype, device=grad_y.device)
    for p0 in range(0, flat.numel(), BLOCK_IDS):
        p1 = min(p0 + BLOCK_IDS, flat.numel())
        sample = torch.arange(p0, p1, device=flat.device) // hotness
        g.index_add_(0, inverse[p0:p1], grad_y[sample].to(dtype))
    return rows, g


def increment(g: torch.Tensor) -> torch.Tensor:
    """What a step adds to each row's accumulator."""
    return (g * g).mean(dim=1)


def accumulate(acc: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The accumulators after the step, from those before it."""
    return acc + increment(g)


def update(table_rows: torch.Tensor, acc_new: torch.Tensor, g: torch.Tensor, *, lr: float,
           eps: float):
    """``(rows, step)``: the rows after the step, in the table's storage
    dtype, and the step subtracted, in ``g``'s."""
    step = lr * g / torch.sqrt(acc_new + eps)[:, None]
    return (table_rows.to(g.dtype) - step).to(table_rows.dtype), step
