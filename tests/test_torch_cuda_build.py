"""The port's CUDA build step (vq_voice_swap_torch/ops/cuda_build.py) with a
stand-in compiler: a shell script named nvcc that writes its -o file, or
fails for a source whose name says so. The real nvcc runs only on the
card's machine (chip_smoke.py phase 1)."""

import os
import stat

import pytest

from vq_voice_swap_torch.ops import cuda_build

FAKE_NVCC = """#!/bin/sh
# Writes the -o file; fails, with a message, for a source named bad*.cu.
out=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    */bad*.cu) echo "error in $1"; exit 2 ;;
  esac
  shift
done
echo "ptxas info: compiled"
echo built > "$out"
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    """A csrc/ with two sources, an empty build dir and the stand-in nvcc."""
    csrc, build, bin_dir = tmp_path / "csrc", tmp_path / "_build", tmp_path / "cuda" / "bin"
    csrc.mkdir()
    bin_dir.mkdir(parents=True)
    for name in ("alpha", "beta"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    (csrc / "notes.txt").write_text("not a source\n")
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "_CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_build, "_BUILD_DIR", str(build))
    return csrc, build


def test_build_all_builds_every_source_once(fake_tree):
    csrc, build = fake_tree
    assert cuda_build.sources() == ["alpha", "beta"]
    logs = cuda_build.build_all()
    assert set(logs) == {"alpha", "beta"}
    assert all("ptxas info" in log for log in logs.values())
    libs = sorted(os.listdir(build))
    assert [lib.split("-")[0] for lib in libs] == ["libalpha", "libbeta"]
    assert cuda_build.build_all() == {"alpha": None, "beta": None}  # all current

    (csrc / "beta.cu").write_text("// beta, edited\n")
    assert cuda_build.build("beta") is not None  # a new hash, a new library
    assert len(os.listdir(build)) == 3


def test_build_all_reports_every_failure_and_keeps_the_rest(fake_tree):
    csrc, build = fake_tree
    for name in ("bad_one", "bad_two"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    with pytest.raises(RuntimeError) as err:
        cuda_build.build_all()
    assert "nvcc failed for bad_one" in str(err.value)
    assert "nvcc failed for bad_two" in str(err.value)
    built = sorted(lib.split("-")[0] for lib in os.listdir(build))
    assert built == ["libalpha", "libbeta"]  # no half-written or failed library
