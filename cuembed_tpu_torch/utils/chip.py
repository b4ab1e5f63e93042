"""Chip constants: measured numbers that gate the engine's decisions, the
counterpart of ``cuembed_tpu/utils/chip.py``.

Three numbers steer the configurations and the dispatcher's refusals:

* ``hot_bytes`` / ``vmem_table_bytes``: the largest table the chip still
  gathers from within 75% of its small-table rate. On the TPU that is the
  VMEM budget; on an H100, the L2 boundary, as the record's gather curve
  shows it (K1 summing bags of 64 rows, so that the table's reads, not an
  output stream, set the rate). It sizes the tiered configuration's hot
  head and is the size below which :func:`~cuembed_tpu_torch.ops.tiered.auto_config`
  gives no configuration.
* ``narrow_inline_pack_bytes``: the largest raw narrow table (lane-padded
  bytes) that ``backend="tiered"`` takes as it stands.
* ``tiering_min_hotness`` / ``tiering_min_positions``: the batch-shape law,
  where the tiered route beats the plain version.

The reference queries its device instead of hardcoding
(``embedding_lookup.cuh:356-363``). As in the JAX package,
:func:`derive_chip_constants` derives every constant from a raw measurement
record, which ``python -m cuembed_tpu_torch.utils.calibrate_chip`` measures
on the card and writes to ``cuembed_tpu_torch/data/chip_constants_<kind>.json``,
and :func:`chip_constants` loads the record of the attached card at first
use, falling back to the JAX package's v5e values where no record exists
(always without a card). Point ``CUEMBED_CHIP_CONSTANTS`` at a JSON file to
override. The derivation is the JAX package's, number for number, so that a
record means the same in both packages.
"""

from __future__ import annotations

import json
import os
import threading

import torch

# The JAX package's built-in fallbacks (its v5e measurements).
V5E_DEFAULTS = {
    "device_kind": "v5e (builtin fallback)",
    "hot_bytes": 108 * 1024 * 1024,
    "vmem_table_bytes": 108 * 1024 * 1024,
    "narrow_inline_pack_bytes": 8 * 1024 * 1024,
    "tiering_min_hotness": 4,
    "tiering_min_positions": 32768,
}

_lock = threading.Lock()
_cached: dict | None = None


def derive_chip_constants(measurements: dict) -> dict:
    """Derive every dispatch constant from a raw measurement record.

    ``measurements`` (any subset; a missing section keeps the v5e fallback):

    * ``vmem_gather``: list of ``{"mb": int, "mrows_per_s": float}``, the
      row-gather rate against table size. The budget is the largest table
      still within 75% of the small-table rate (the best rate among tables
      at most 4x the smallest).
    * ``pack_relayout_gbps``: float, the narrow line-pack relayout rate.
      The inline-pack bound allows 100 us of it, clamped to [1 MiB, 64 MiB].
    * ``tiering_ab``: list of ``{"positions": int, "hotness": int,
      "tiered_ms": float, "xla_ms": float}``, the A/B grid on a table past
      the budget. The law is the smallest (hotness, positions) corner such
      that every measured point at or past it has the tiered route faster.
    """
    out = dict(V5E_DEFAULTS)
    out["device_kind"] = measurements.get("device_kind", out["device_kind"])

    g = measurements.get("vmem_gather")
    if g:
        smallest = min(x["mb"] for x in g)
        base = max(p["mrows_per_s"] for p in g if p["mb"] <= smallest * 4)
        inside = [p["mb"] for p in g if p["mrows_per_s"] >= 0.75 * base]
        if inside:
            budget = max(inside) * 1024 * 1024
            out["hot_bytes"] = budget
            out["vmem_table_bytes"] = budget

    rate = measurements.get("pack_relayout_gbps")
    if rate:
        out["narrow_inline_pack_bytes"] = max(
            1 << 20, min(int(rate * 1e9 * 100e-6), 64 << 20)
        )

    ab = measurements.get("tiering_ab")
    if ab:
        hots = sorted({p["hotness"] for p in ab})
        poss = sorted({p["positions"] for p in ab})

        def wins(h0, p0):
            pts = [p for p in ab if p["hotness"] >= h0 and p["positions"] >= p0]
            return bool(pts) and all(p["tiered_ms"] < p["xla_ms"] for p in pts)

        best = None
        for h0 in hots:
            for p0 in poss:
                if wins(h0, p0):
                    if best is None or (h0, p0) < best:
                        best = (h0, p0)
                    break
        if best is not None:
            out["tiering_min_hotness"] = best[0]
            out["tiering_min_positions"] = best[1]
    return out


def data_dir() -> str:
    """The package's directory of committed records."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "data")


def device_kind() -> str:
    """The attached card's name, lower case (``""`` without a card)."""
    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(0).lower()


def kind_slug(kind: str) -> str:
    """A device kind as the file-name part of its record."""
    return "".join(ch if ch.isalnum() else "_" for ch in kind).strip("_")


def record_path() -> str | None:
    """The record :func:`chip_constants` loads: the ``CUEMBED_CHIP_CONSTANTS``
    path, else the attached card's committed record, else None."""
    path = os.environ.get("CUEMBED_CHIP_CONSTANTS")
    if path:
        return path
    slug = kind_slug(device_kind())
    if slug:
        candidate = os.path.join(data_dir(), f"chip_constants_{slug}.json")
        if os.path.exists(candidate):
            return candidate
    return None


def chip_constants(refresh: bool = False) -> dict:
    """The active constants (cached after the first load).

    Resolution order: the ``CUEMBED_CHIP_CONSTANTS`` path ->
    ``cuembed_tpu_torch/data/chip_constants_<kind>.json`` for the attached
    card -> :data:`V5E_DEFAULTS`. The derived fields are recomputed from the
    record's raw measurements at load time, so a committed record stays
    self-describing.
    """
    global _cached
    with _lock:
        if _cached is not None and not refresh:
            return _cached
        path = record_path()
        if path and os.path.exists(path):
            with open(path) as f:
                _cached = derive_chip_constants(json.load(f))
        else:
            _cached = dict(V5E_DEFAULTS)
        return _cached


def _reset_cache_for_tests() -> None:
    global _cached
    with _lock:
        _cached = None
