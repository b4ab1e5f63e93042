"""On the card only (``-m cuda``): the tables drawn again equal the first draw
there too, and a throwaway cell runs end to end on the card."""

from __future__ import annotations

import pytest
import torch

from portbench import gen, harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    return torch.device("cuda")


@pytest.mark.cuda
def test_table_rows_drawn_again_on_card(card, monkeypatch):
    monkeypatch.setattr(gen, "CHUNK_ROWS", 1 << 12)
    t = gen.table(7, 1, 10_000, 128, torch.float16, card)
    rows = torch.tensor([0, 4095, 4096, 9999, 123], device=card)
    assert torch.equal(gen.table_rows(7, 1, 10_000, 128, torch.float16, card, rows), t[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tiny-serve", "tiny-train"])
def test_tiny_cells_on_card(card, tiny_root, workload):
    r = harness.run_cell(tiny_root, workload, seed=2**40 + 3, seconds=0.5, trace=True)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert r["metrics"]
