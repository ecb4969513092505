"""BENCHMARK.json against the benchmark's contract, and what a later change
adds as files."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, TINY, run_tiny

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_keys_and_characters():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["paths"] == ["benchmark"]
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for name in names:
        assert NAME.match(name), name
    assert len({c["name"] for c in MANIFEST["configs"]}) == len(MANIFEST["configs"])
    assert len({w["name"] for w in MANIFEST["workloads"]}) == len(MANIFEST["workloads"])
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_metrics_follow_their_cells():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert harness.reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        reported = [m for m in MANIFEST["end_to_end"] if harness.reports(m, cell)]
        assert len(reported) >= 2
        assert any(harness.reports(m, cell) for m in MANIFEST["per_layer"])
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= 1


def test_the_full_check_fits():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cells_resolve_their_files(cell):
    c = harness.resolve(cell)
    assert c.traffic["driver"] in TINY
    for m in c.per_layer:
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        assert hasattr(harness.load_module(path, "m"), "read")
    assert set(c.limits) == {name for name in c.limits}


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(os.path.join(BENCH, "reference")):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(BENCH, "reference", name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for mod in mods:
                assert mod.split(".")[0] not in ("vq_voice_swap_torch", "vq_voice_swap_tpu",
                                                 "jax", "flax"), (name, mod)


def test_no_jax_in_a_run():
    """A tiny swap run on the CPU loads no module whose top-level name is
    jax, jaxlib, flax or the JAX package (whole names compared)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from conftest import tiny_cell, run_tiny\n"
        "import harness\n"
        "line = run_tiny(tiny_cell('swap.bf16.b64'))\n"
        "assert line['correct'], line\n"
        "print('FOUND', harness.forbidden_modules())\n"
        "import vq_voice_swap_torch.train\n"
        "print('FOUND', harness.forbidden_modules())\n"
    ) % (os.path.join(BENCH, "tests"), BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert [line for line in out.stdout.splitlines() if line.startswith("FOUND")] == \
        ["FOUND []", "FOUND []"]
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "vq_voice_swap_tpu")


def test_forbidden_names_are_whole():
    import types

    sys.modules["vq_voice_swap_torch_probe"] = types.ModuleType("vq_voice_swap_torch_probe")
    try:
        assert "vq_voice_swap_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["vq_voice_swap_torch_probe"]


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "swap.bf16.b64",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_added_as_files(tmp_path):
    """A new configuration, mix, cell, limits and per-layer metric, added as
    files and entries in a copy, run without an existing file edited."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    manifest = json.loads(json.dumps(MANIFEST))
    b = tmp_path / "benchmark"
    cfg = json.load(open(os.path.join(BENCH, "configs", "vqvae-unet64-mfcc512.json")))
    cfg["model"].update(TINY["swap"]["model"])
    cfg["dtype"] = None
    (b / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = json.load(open(os.path.join(BENCH, "traffic", "swap_b64.json")))
    mix.update(TINY["swap"]["traffic"], steps=3)
    (b / "traffic" / "tiny_mix.json").write_text(json.dumps(mix))
    (b / "limits" / "tiny.swap.json").write_text(json.dumps({"code_gap": 1e-3, "eps_err": 1e-3,
                                                              "step_err": 1e-3}))
    (b / "metrics" / "batches_done.py").write_text(
        "def read(window):\n    return float(window.info['batches'])\n")
    manifest["configs"].append({"name": "tiny", "source": "x", "file": "benchmark/configs/tiny.json",
                                "reduced": ["base_channels"], "why": "x"})
    manifest["workloads"].append({"name": "tiny.swap", "config": "tiny", "traffic": "tiny_mix",
                                  "chips": 1, "why": "x"})
    for m in manifest["end_to_end"]:
        if m["name"] == "rtf":
            m["workloads"].append("tiny.swap")
    manifest["per_layer"].append({"name": "batches_done", "unit": "batches", "better": "higher",
                                  "source": "program_counter", "layer": "x", "moves": "rtf",
                                  "workloads": ["tiny.swap"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.resolve("tiny.swap", root=str(tmp_path), bench_dir=str(b))
    line = run_tiny(cell, trace=True)
    assert line["correct"] and line["metrics"]["batches_done"]["value"] >= 1
    line = run_tiny(cell)
    assert set(line["metrics"]) == {"rtf", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data
