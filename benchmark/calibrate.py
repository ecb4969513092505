#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --cells swap.bf16.b64,swap.int8.b64 \
        --seeds 12 --controls 3 --seconds 2 --out DIR

For each cell, in one process: the cell run ``--seeds`` times for
``--seconds`` at its own load (the lower readings: every number it
compares), then its control on ``--controls`` seeds (the driver's
``control``: the nearest precision below the cell's; the upper readings).
``--fault NAME`` plants a fault of ``faults.py`` in the cell's runs (a
training cell's limit may take its upper reading from one). Each reading
is a line of ``DIR/calibrate.jsonl`` and of standard output."""

import argparse
import json
import os
import sys
import time
from contextlib import nullcontext

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")

import torch  # noqa: E402

from faults import planted  # noqa: E402
from harness import Context, mix_seed, resolve, run_cell  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--fault", default=None, help="plant this fault (faults.py) in the program runs")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "calibrate.jsonl")

    def emit(rec):
        print(json.dumps(rec), flush=True)
        with open(path, "a") as log:
            log.write(json.dumps(rec) + "\n")

    for name in args.cells.split(","):
        for i in range(args.seeds):
            seed = args.first_seed + mix_seed(i, name) % 1_000_000_000
            t0 = time.perf_counter()
            cell = resolve(name)
            with planted(cell.traffic["driver"], args.fault) if args.fault else nullcontext():
                line = run_cell(cell, seed, args.seconds, False, "cuda", t0)
            emit({"cell": name, "kind": args.fault or "program", "seed": seed,
                  "correct": line["correct"],
                  "checks": {k: v["value"] for k, v in line["checks"].items()},
                  "reported": line.get("reported"),
                  "attempted": line["attempted"], "seconds": time.perf_counter() - t0})
        for i in range(args.controls):
            seed = args.first_seed + mix_seed(i, name, "control") % 1_000_000_000
            t0 = time.perf_counter()
            cell = resolve(name)
            ctx = Context(cell, seed, args.seconds, False, torch.device("cuda"), t0)
            checks = cell.driver.control(ctx)
            emit({"cell": name, "kind": "control", "seed": seed, "checks": dict(checks),
                  "control": cell.traffic.get("control"),
                  "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
