"""Each driver end to end on the CPU at a tiny width, through the
program's plain paths; its control and each fault that its cell can have,
planted underneath the timed path, come out not correct.

The tiny runs are float32, where the program meets the reference to
rounding, so a sound run reads far below every limit and a fault reads
far above it."""

import pytest

from conftest import control_tiny, run_tiny, tiny_cell
from faults import FAULTS, planted


@pytest.mark.parametrize("name", ["swap.bf16.b64", "swap.int8.b64"])
def test_swap_runs_and_is_correct(name):
    line = run_tiny(tiny_cell(name))
    assert line["correct"], line
    assert line["attempted"] >= 4 and line["failed"] == 0
    assert set(line["metrics"]) == {"rtf", "setup_s"}
    assert list(line)[-1] == "checks"
    line = run_tiny(tiny_cell(name), trace=True)
    assert line["correct"] and "mfu.swap" in line["metrics"]


def test_train_runs_and_is_correct():
    line = run_tiny(tiny_cell("train.bf16.k4"), seconds=0.1)
    assert line["correct"], line
    assert set(line["metrics"]) == {"samples_per_s", "setup_s"}


@pytest.mark.parametrize("name", ["swap.bf16.b64", "swap.int8.b64", "train.bf16.k4"])
def test_control_is_not_correct(name):
    """The control at the cell's own type: the program's int8 path for the
    bfloat16 swap, the reference at 4 bits for the int8 swap, the
    reference at 8 bits for the bfloat16 training."""
    ok, readings = control_tiny(tiny_cell(name, dtype="bfloat16"))
    assert not ok, readings


@pytest.mark.parametrize("fault", sorted(FAULTS["swap"]))
def test_swap_fault_is_not_correct(fault):
    with planted("swap", fault):
        line = run_tiny(tiny_cell("swap.bf16.b64"))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS["train"]))
def test_train_fault_is_not_correct(fault):
    with planted("train", fault):
        line = run_tiny(tiny_cell("train.bf16.k4"), seconds=0.1)
    assert not line["correct"], line["checks"]
