"""The harness end to end on the CPU at a tiny size: a cell made of data files
in a throwaway root runs with no code edited, checks come out correct, and
nothing loads JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(__file__).resolve().parents[1]
SEED = 2**40 + 12345  # past 32 bits: run seeds may be


@pytest.mark.parametrize("workload", ["tiny-serve", "tiny-train"])
@pytest.mark.parametrize("trace", [False, True])
def test_added_cell_runs_with_no_code_edit(tiny_root, workload, trace):
    r = harness.run_cell(tiny_root, workload, seed=SEED, seconds=0.2, trace=trace, device="cpu")
    assert list(r)[0] == "correct" and list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    names = set(r["metrics"])
    if not trace:
        want = {"setup_s", "serve_p95_ms", "serve_ids_per_s"} if "serve" in workload else \
            {"setup_s", "train_examples_per_s"}
        assert names == want
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:  # no device on the CPU: only the host's readers find something to read
        assert names <= {"host_ms_per_request.serve", "request_roofline.serve",
                         "host_ms_per_step.train", "step_roofline.train"}
        assert names
    json.dumps(r)


def test_same_seed_same_checks(tiny_root):
    a = harness.run_cell(tiny_root, "tiny-train", seed=SEED, seconds=0.05, trace=False, device="cpu")
    b = harness.run_cell(tiny_root, "tiny-train", seed=SEED, seconds=0.05, trace=False, device="cpu")
    # the numbers of the run and of the step after it follow the window's step count
    first = ("accum_rel_err", "grad_norm_gap", "change_norm_gap", "row_err_ulps")
    assert {k: a["checks"][k] for k in first} == {k: b["checks"][k] for k in first}


@pytest.mark.parametrize("workload", ["flagship-serve", "dlrmv2-train", "dlrmv2-serve-small",
                                      "flagship-train"])
def test_cells_resolve_by_name(workload):
    cell = harness.resolve(BENCH.parent, workload, 1, "cpu")
    assert cell.traffic["loop"] in ("serve", "train")
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    assert cell.end_to_end and cell.per_layer
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    for m in cell.per_layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_configs_as_stated():
    dl = json.loads((BENCH / "configs/dlrmv2-criteo-mh.json").read_text())
    assert len(dl["num_embeddings_per_feature"]) == len(dl["multi_hot_sizes"]) == 26
    assert sum(dl["num_embeddings_per_feature"]) == 204_184_588
    assert sum(dl["multi_hot_sizes"]) * 65536 == 14_024_704
    assert dl["embedding_dim"] == 128 and dl["dtype"] == "float16"
    fl = json.loads((BENCH / "configs/cuembed-flagship.json").read_text())
    assert (fl["num_embeddings_per_feature"], fl["multi_hot_sizes"], fl["embedding_dim"]) == \
        ([10_000_000], [64], 256)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("cuembed_tpu_torch_x", "jaxtyping", "cuembed_tpu_torch.ops"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not [m for m in harness.forbidden_modules() if not m.split(".")[0] in harness.FORBIDDEN]
    for name in ("jax", "cuembed_tpu.ops", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name in harness.forbidden_modules()


def test_no_card_no_result():
    r = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "flagship-serve",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=BENCH.parent,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_jax_in_the_benchmark(path):
    mods = _imports(BENCH / path)
    assert not mods & set(harness.FORBIDDEN)
    if path.startswith("reference/"):
        assert "cuembed_tpu_torch" not in mods and mods <= {"__future__", "torch", "portbench"}
