"""Faults planted under the timed path, to show that the check fails them: the
tests plant each on the CPU, and ``calibrate.py`` reads each on the card at a
cell's own size for the limits' upper readings. The benchmark's own runs
plant nothing.

* ``unchanged``: the update returns the tables and accumulators as they were;
* ``half_batch``: half of each batch left out, the gradient's mean taken over
  the rest (the update sees the first half with twice its ``grad_y``; the
  lookup leaves the second half's pooled rows at zero);
* ``altered``: one answer changed where it is produced: the hottest row's
  update in the hottest table is lost, or one pooled row is negated.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "altered")


def _hottest_table(indices: dict) -> str:
    return max(indices, key=lambda n: indices[n].shape[1])


@contextlib.contextmanager
def planted(fault: str):
    """Plant ``fault`` in the program's ``EmbeddingCollection`` for the block."""
    from cuembed_tpu_torch.collection import EmbeddingCollection

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    apply, update = EmbeddingCollection.apply, EmbeddingCollection.adagrad_update

    def bad_apply(self, tables, indices, *a, **kw):
        out = apply(self, tables, indices, *a, **kw)
        if fault == "half_batch":
            for n, o in out.items():
                o[o.shape[0] // 2:] = 0
        elif fault == "altered":
            o = out[_hottest_table(indices)]
            o[0] = -o[0]
        return out

    def bad_update(self, tables, accums, indices, grads_y, **kw):
        if fault == "unchanged":
            return tables, accums
        if fault == "half_batch":
            half = {n: i[:i.shape[0] // 2] for n, i in indices.items()}
            twice = {n: 2.0 * g[:g.shape[0] // 2] for n, g in grads_y.items()}
            return update(self, tables, accums, half, twice, **kw)
        name = _hottest_table(indices)
        rows, counts = torch.unique(indices[name], return_counts=True)
        r = rows[torch.argmax(counts)]
        keep_t, keep_a = tables[name][r].clone(), accums[name][r].clone()
        out = update(self, tables, accums, indices, grads_y, **kw)
        tables[name][r], accums[name][r] = keep_t, keep_a
        return out

    EmbeddingCollection.apply, EmbeddingCollection.adagrad_update = bad_apply, bad_update
    try:
        yield
    finally:
        EmbeddingCollection.apply, EmbeddingCollection.adagrad_update = apply, update
