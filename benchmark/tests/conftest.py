"""Tiny cells for the benchmark's CPU tests: the manifest's cells at a
small width and size, in float32 unless a test asks for the cell's own
type, run through the harness on the CPU (the program's plain paths)."""

import os
import sys
import time

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import harness  # noqa: E402

TINY = {
    "swap": dict(model=dict(base_channels=4, dictionary_size=16),
                 traffic=dict(batch=4, clip_seconds=0.4, steps=2, keep_rows=2, check_clips=8)),
    "train": dict(model=dict(base_channels=8, dictionary_size=16, num_labels=3),
                  traffic=dict(batch=4, steps_per_dispatch=2, speakers=3, utterances=1,
                               utterance_seconds=4.6, reference_rows=1)),
}


def tiny_cell(name: str, dtype=None, **resolve_kw) -> harness.Cell:
    cell = harness.resolve(name, **resolve_kw)
    kind = cell.traffic["driver"]
    cell.config["model"].update(TINY[kind]["model"])
    cell.config["dtype"] = dtype
    cell.traffic = dict(cell.traffic, **TINY[kind]["traffic"])
    if cell.traffic.get("act_int8_min_t"):
        cell.traffic["act_int8_min_t"] = 3200
    control = dict(cell.traffic.get("control", {}))
    if "act_int8_min_t" in control:
        control["act_int8_min_t"] = 3200
    cell.traffic["control"] = control
    return cell


def run_tiny(cell: harness.Cell, seed: int = 2**31 + 17, seconds: float = 0.5,
             trace: bool = False):
    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter())


def control_tiny(cell: harness.Cell, seed: int = 2**31 + 23):
    ctx = harness.Context(cell, seed, 0.5, False, torch.device("cpu"), time.perf_counter())
    checks = cell.driver.control(ctx)
    return all(v <= cell.limits[k] for k, v in checks if k in cell.limits), dict(checks)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
