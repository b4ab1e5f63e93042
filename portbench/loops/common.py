"""What the serving and training loops share: the program's collection for a
configuration, the tables and id pools made from the seed, and counts of the
work in each request for the byte arithmetic."""

from __future__ import annotations

import time

import torch

from portbench import gen


def collection(cell):
    """The program's ``EmbeddingCollection`` of the configuration's tables,
    named ``t0``, ``t1``, ... in order, pooled by SUM."""
    from cuembed_tpu_torch.collection import EmbeddingCollection, TableConfig
    from cuembed_tpu_torch.types import CombineMode

    if cell.config["pooling"] != "sum":
        raise ValueError("the loops run SUM pooling only")
    return EmbeddingCollection([
        TableConfig(f"t{i}", rows, cell.width, mode=CombineMode.SUM, dtype=cell.dtype,
                    hotness=hot)
        for i, (rows, hot) in enumerate(cell.tables)])


def make_tables(cell) -> list:
    return [gen.table(cell.seed, i, rows, cell.width, cell.dtype, cell.device)
            for i, (rows, _) in enumerate(cell.tables)]


def make_ids(cell, samples: int, purpose: str) -> list:
    """Each table's ``[samples, hotness]`` ids by the configuration's law."""
    law = cell.config["ids"]
    return [gen.bags(gen.generator(cell.device, cell.seed, purpose, i), rows, samples, hot,
                     float(law["alpha"]), distinct=bool(law["distinct_within_sample"]),
                     permute=bool(law["permute"]))
            for i, (rows, hot) in enumerate(cell.tables)]


def unique_counts(ids: torch.Tensor, sizes: list) -> list:
    """Distinct ids of each consecutive slice of ``sizes`` samples of one
    table's ``[samples, hotness]`` ids, in one sort."""
    span = int(ids.max()) + 1
    owner = torch.repeat_interleave(torch.arange(len(sizes), device=ids.device),
                                    torch.tensor(sizes, device=ids.device))
    uniq = torch.unique(owner[:, None] * span + ids)
    return torch.bincount(uniq // span, minlength=len(sizes)).tolist()


class Timer:
    """Seconds spent on the check's own work during set-up, which ``setup_s``
    leaves out."""

    def __init__(self):
        self.seconds = 0.0

    def __enter__(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.seconds += time.perf_counter() - self._t0
