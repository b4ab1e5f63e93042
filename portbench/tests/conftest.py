"""Fixtures of the benchmark's CPU tests: a throwaway benchmark root with a
tiny configuration, two traffic mixes and their cells, made of data files
only, which the harness runs with no code edited."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"embedding_dim": 16, "num_embeddings_per_feature": [5000, 3, 700],
        "multi_hot_sizes": [64, 1, 5], "dtype": "float16", "pooling": "sum",
        "ids": {"alpha": 1.15, "permute": True, "distinct_within_sample": True}}
SERVE = {"loop": "serve", "samples": {"uniform": [10, 70]}, "pool": 6, "check_requests": 3}
TRAIN = {"loop": "train", "batch": 256, "id_pool": 4, "grad_pool": 2, "grad_scale": 0.01,
         "lr": 0.005, "eps": 1e-8, "checked_steps": 3, "warm_steps": 1, "sample_rows": 500}


def make_root(path: Path, limits_of: dict) -> Path:
    """A benchmark root holding only data: ``BENCHMARK.json`` with the cells
    ``tiny-serve`` and ``tiny-train``, their configuration, traffic and
    limits (each cell's limits copied from the named real cell's)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "limits"):
        (path / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    (path / "portbench/configs/tiny.json").write_text(json.dumps(TINY))
    (path / "portbench/traffic/tiny-serve-mix.json").write_text(json.dumps(SERVE))
    (path / "portbench/traffic/tiny-train-mix.json").write_text(json.dumps(TRAIN))
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [
        {"name": "tiny-serve", "config": "tiny", "traffic": "tiny-serve-mix", "chips": 1, "why": "t"},
        {"name": "tiny-train", "config": "tiny", "traffic": "tiny-train-mix", "chips": 1, "why": "t"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-train" if "train" in m["name"] else "tiny-serve"]
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell, (real, changed) in limits_of.items():
        limits = json.loads((ROOT / f"portbench/limits/{real}.json").read_text())
        (path / f"portbench/limits/{cell}.json").write_text(json.dumps({**limits, **changed}))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    """The tiny cells held to the flagship cells' limits, but for the change
    norm: over 500 sampled rows of width 16 the fp16 rounding of the tables
    reads 2e-5 to 8e-5 of it in sound runs, against at most 1.5e-6 over the
    flagship's 16,448 rows of width 256."""
    return make_root(tmp_path, {"tiny-serve": ("flagship-serve", {}),
                                "tiny-train": ("flagship-train", {"change_norm_gap": 1e-3})})
