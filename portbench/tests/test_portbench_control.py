"""The check fails what it must: the control (the step below the stated
precision) and each fault planted under the timed path, on the CPU at a tiny
size, held to the real cells' limits."""

from __future__ import annotations

import contextlib

import pytest

from portbench import check, faults, harness
from portbench.calibrate import control_numbers, run_loop
from portbench.tracing import Tracer

SEED = 2**40 + 99


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
@pytest.mark.parametrize("workload", ["tiny-serve", "tiny-train"])
def test_control_is_not_correct(tiny_root, workload, seed):
    cell, loop = run_loop(workload, seed, 0.05, root=tiny_root, device="cpu")
    correct, checks = check.verdict(control_numbers(cell, loop), cell.limits)
    assert not correct, checks


@pytest.mark.parametrize("fault,workload", [
    ("unchanged", "tiny-train"), ("half_batch", "tiny-train"), ("altered", "tiny-train"),
    ("half_batch", "tiny-serve"), ("altered", "tiny-serve")])
def test_planted_fault_is_not_correct(tiny_root, fault, workload):
    with faults.planted(fault):
        r = harness.run_cell(tiny_root, workload, seed=SEED, seconds=0.05, trace=False,
                             device="cpu")
    assert r["correct"] is False, r["checks"]


FIRST = ("accum_rel_err", "grad_norm_gap", "change_norm_gap", "row_err_ulps")


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("stage", ["window", "close"])
def test_fault_after_the_first_steps_is_not_correct(tiny_root, fault, stage):
    """A fault that starts only once the checked steps are past, in the
    window or in the step after it, passes the numbers of the first steps
    and fails those of the run and of the replayed step."""
    cell = harness.resolve(tiny_root, "tiny-train", SEED, "cpu")
    loop = harness.make_loop(cell, Tracer(False))
    loop.setup()
    with faults.planted(fault) if stage == "window" else contextlib.nullcontext():
        loop.window(0.05)
    with faults.planted(fault) if stage == "close" else contextlib.nullcontext():
        loop.close()
    loop.free_program()
    correct, checks = check.verdict(loop.numbers(), cell.limits)
    assert not correct, checks
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in FIRST), checks


def test_faults_are_removed_after_the_block(tiny_root):
    with faults.planted("altered"):
        pass
    r = harness.run_cell(tiny_root, "tiny-serve", seed=SEED, seconds=0.05, trace=False,
                         device="cpu")
    assert r["correct"] is True
