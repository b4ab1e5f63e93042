"""The pooled SUM lookup, plainly: ``out[b] = sum_j table[ids[b, j]]``, summed
in ``dtype`` (float64 for the reference), with the elementwise sum of the
terms' magnitudes beside it for the error bound."""

from __future__ import annotations

import torch

BLOCK_IDS = 1 << 21  # ids gathered at a time


def pooled_sum(table: torch.Tensor, ids: torch.Tensor, dtype=torch.float64):
    """``(out, abs_sum)``, each ``[batch, width]`` in ``dtype``."""
    batch, hotness = ids.shape
    width = table.shape[1]
    out = torch.empty((batch, width), dtype=dtype, device=table.device)
    mag = torch.empty_like(out)
    step = max(1, BLOCK_IDS // hotness)
    for b0 in range(0, batch, step):
        rows = table[ids[b0:b0 + step].reshape(-1)].to(dtype).view(-1, hotness, width)
        out[b0:b0 + step] = rows.sum(1)
        mag[b0:b0 + step] = rows.abs().sum(1)
    return out, mag
