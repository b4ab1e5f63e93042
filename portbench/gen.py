"""Inputs made from the seed, on the device: tables, lookup ids, gradients.

Every draw comes from a ``torch.Generator`` on the run's device, seeded by
:func:`subseed` from the run's ``--seed`` and the draw's purpose, so the same
seed gives the same inputs, and a table can be drawn again, chunk by chunk,
for the reference after the program has changed it.

The id law is upstream cuEmbed's ``translateToPowerLaw``
(``utils/src/datagen.cpp``): ``y = (u (max^g - min^g) + min^g)^(1/g)``,
``g = 1 - alpha``, ids in ``[1, rows - 1]``, distinct within a sample (the
first ``hotness`` distinct draws in draw order, as its ``std::set`` loop
keeps them), mapped through a random permutation of ``[0, rows)``, and each
sample sorted ascending. It runs here on the device instead of the host.
"""

from __future__ import annotations

import hashlib

import torch

# Rows drawn per generator call, so that a table can be drawn again a chunk
# at a time.
CHUNK_ROWS = 1 << 22
# Samples de-duplicated at a time (bounds the candidates' memory).
DEDUP_SAMPLES = 1 << 16


def subseed(seed: int, *parts) -> int:
    """A 63-bit seed for one draw, from the run's seed and the draw's name."""
    text = ":".join(str(p) for p in (seed, *parts))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *parts))


def power_law(u: torch.Tensor, lo: float, hi: float, alpha: float) -> torch.Tensor:
    """Uniform ``u`` in [0, 1) onto a power law on [lo, hi); ``alpha == 0``
    is uniform and ``alpha == 1`` the log-uniform limit."""
    if alpha == 1.0:
        return lo * (hi / lo) ** u
    g = 1.0 - alpha
    return (u * (hi**g - lo**g) + lo**g) ** (1.0 / g)


def draw_ids(gen: torch.Generator, rows: int, n: int, alpha: float) -> torch.Tensor:
    """``n`` ids in ``[1, rows - 1]``, int64, by the power law."""
    u = torch.rand(n, dtype=torch.float64, device=gen.device, generator=gen)
    if alpha == 0.0:
        y = 1.0 + torch.floor(u * (rows - 1))
    else:
        y = torch.floor(power_law(u, 1.0, float(rows), alpha))
    return y.clamp_(1, rows - 1).long()


def _distinct_bags(gen, rows, batch, hotness, alpha):
    """``[batch, hotness]`` ids, each row the first ``hotness`` distinct of
    its draws in draw order; rows short of distinct draws draw again with
    twice the candidates."""
    device = gen.device
    out = torch.empty((batch, hotness), dtype=torch.int64, device=device)
    pending = torch.arange(batch, device=device)
    k = max(2 * hotness, hotness + 8)
    while pending.numel():
        n = pending.numel()
        cand = draw_ids(gen, rows, n * k, alpha).view(n, k)
        sv, order = torch.sort(cand, dim=1, stable=True)
        dup_sorted = torch.cat(
            [torch.zeros((n, 1), dtype=torch.bool, device=device), sv[:, 1:] == sv[:, :-1]], 1)
        first = ~torch.empty_like(dup_sorted).scatter_(1, order, dup_sorted)
        rank = torch.cumsum(first, 1) - 1
        done = first.sum(1) >= hotness
        keep = first[done] & (rank[done] < hotness)
        out[pending[done]] = cand[done][keep].view(-1, hotness)
        pending = pending[~done]
        k = min(2 * k, 4 * rows)
    return out


def bags(gen: torch.Generator, rows: int, batch: int, hotness: int, alpha: float,
         *, distinct: bool = True, permute: bool = True) -> torch.Tensor:
    """``[batch, hotness]`` int64 ids for a table of ``rows`` rows."""
    if distinct and hotness > rows - 1:
        raise ValueError(f"{hotness} distinct ids need more than {rows} rows")
    if hotness == 1 or not distinct:
        ids = draw_ids(gen, rows, batch * hotness, alpha).view(batch, hotness)
    else:
        ids = torch.cat([_distinct_bags(gen, rows, min(DEDUP_SAMPLES, batch - b0), hotness, alpha)
                         for b0 in range(0, batch, DEDUP_SAMPLES)])
    if permute:
        perm = torch.randperm(rows, generator=gen, device=gen.device)
        ids = perm[ids]
        del perm
    return torch.sort(ids, dim=1).values


def _chunk(seed, table_no, rows, width, dtype, c, device, out=None):
    r0, r1 = c * CHUNK_ROWS, min(rows, (c + 1) * CHUNK_ROWS)
    if out is None:
        out = torch.empty((r1 - r0, width), dtype=dtype, device=device)
    scale = width ** -0.5
    return out.uniform_(-scale, scale, generator=generator(device, seed, "table", table_no, c))


def table(seed: int, table_no: int, rows: int, width: int, dtype, device) -> torch.Tensor:
    """A ``[rows, width]`` table of U(-1/sqrt(W), 1/sqrt(W)) draws made in
    its storage dtype, one generator call a chunk of rows."""
    t = torch.empty((rows, width), dtype=dtype, device=device)
    for c in range(-(-rows // CHUNK_ROWS)):
        _chunk(seed, table_no, rows, width, dtype, c, device, t[c * CHUNK_ROWS:(c + 1) * CHUNK_ROWS])
    return t


def table_rows(seed: int, table_no: int, rows: int, width: int, dtype, device,
               row_ids: torch.Tensor) -> torch.Tensor:
    """Rows ``row_ids`` of :func:`table`'s draw, drawn again chunk by chunk."""
    out = torch.empty((row_ids.numel(), width), dtype=dtype, device=device)
    chunk_of = row_ids // CHUNK_ROWS
    for c in torch.unique(chunk_of).tolist():
        sel = (chunk_of == c).nonzero().squeeze(1)
        block = _chunk(seed, table_no, rows, width, dtype, c, device)
        out[sel] = block[row_ids[sel] - c * CHUNK_ROWS]
    return out


def grads(gen: torch.Generator, batch: int, width: int, scale: float) -> torch.Tensor:
    """A ``[batch, width]`` fp32 gradient of the pooled rows, N(0, scale^2)."""
    return torch.randn((batch, width), dtype=torch.float32, device=gen.device,
                       generator=gen).mul_(scale)


def sizes(spec: dict, count: int, gen_host: torch.Generator) -> list:
    """``count`` request sizes (samples) by the traffic's ``samples`` rule:
    ``{"fixed": n}``, or ``{"uniform": [lo, hi]}`` as the same evenly spaced
    set for every seed, in an order drawn from the seed."""
    if "fixed" in spec:
        return [int(spec["fixed"])] * count
    lo, hi = spec["uniform"]
    base = [round(lo + (hi - lo) * (i + 0.5) / count) for i in range(count)]
    order = torch.randperm(count, generator=gen_host).tolist()
    return [base[i] for i in order]
