"""The port's log reader and tool CLIs against the JAX package's:
``observe.read_log`` on the same files (comments, the blank-line stop, the
error message), ``combine_datasets`` against the root CLI's
``merge_datasets`` on a temporary tree, and ``plot_log`` and
``compare_logs`` each writing a PNG."""

import importlib.util
import io
import json
import os
import wave

import numpy as np
import pytest

from vq_voice_swap_tpu.observe import read_log as jax_read_log
from vq_voice_swap_torch import combine_datasets, compare_logs, plot_log
from vq_voice_swap_torch.observe import Logger, read_log

LOG = """# a comment
step 1: loss=0.50000 base_q0=0.25000 base_q1=0.75000
step 2: loss=0.40000 base_q0=0.20000 base_q1=0.60000
# saved
step 3: loss=0.30000 base_q0=0.15000 base_q1=0.45000

step 4: loss=0.20000
"""


def _jax_root_cli(name: str):
    """The JAX package's root CLI module ``<name>.py``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(root, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("text", [LOG, LOG.replace("\n\n", "\n"), "", "# only\n"],
                         ids=["blank_stop", "to_the_end", "empty", "comment_only"])
def test_read_log_matches_jax(tmp_path, text):
    path = tmp_path / "log.txt"
    path.write_text(text)
    got = list(read_log(str(path)))
    assert got == list(jax_read_log(str(path)))
    assert got == list(read_log(io.StringIO(text)))


@pytest.mark.parametrize("bad", ["step x: loss=1", "step 2: loss", "loss=1", "step 3: a=b"])
def test_read_log_error_matches_jax(tmp_path, bad):
    path = tmp_path / "log.txt"
    path.write_text(f"# header\nstep 1: loss=1.0\n{bad}\n")
    with pytest.raises(ValueError) as want:
        list(jax_read_log(str(path)))
    with pytest.raises(ValueError, match="unexpected log format at line 3") as got:
        list(read_log(str(path)))
    assert str(got.value) == str(want.value)


def test_read_log_reads_the_port_logger(tmp_path):
    path = str(tmp_path / "train_log.txt")
    logger = Logger(path)
    logger.log(1, loss=0.5, vq=0.25)
    logger.log(2, loss=0.25, vq=0.125)
    logger.close()
    assert list(read_log(path)) == list(jax_read_log(path)) == [
        (1, {"loss": 0.5, "vq": 0.25}), (2, {"loss": 0.25, "vq": 0.125})]


def _write_wav(path, seconds: float) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(int(seconds * 16000), "<i2").tobytes())


def test_combine_datasets_matches_jax_merge(tmp_path):
    sources = []
    for i, speakers in enumerate((["19", "26"], ["19", "7"])):
        src = tmp_path / f"src{i}"
        for j, spk in enumerate(speakers):
            _write_wav(str(src / spk / "ch" / f"{spk}-{j}.wav"), 1.0 + 0.5 * j + i)
        sources.append(str(src))
    jax_cli = _jax_root_cli("combine_datasets")
    os.mkdir(tmp_path / "want")
    want = jax_cli.merge_datasets(sources, str(tmp_path / "want"))
    out = str(tmp_path / "got")
    combine_datasets.main([*sources, out])
    with open(os.path.join(out, "index.json")) as f:
        assert json.load(f) == json.loads(json.dumps(want))
    names = sorted(n for n in os.listdir(out) if n != "index.json")
    assert names == sorted(os.listdir(tmp_path / "want")) == [
        "00_19", "00_26", "01_19", "01_7"]
    for name in names:
        assert os.readlink(os.path.join(out, name)) == os.readlink(tmp_path / "want" / name)
    with pytest.raises(SystemExit):
        combine_datasets.main([*sources, out])


def _png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n" and os.path.getsize(path) > 1000


def test_plot_log_and_compare_logs_write_pngs(tmp_path, capsys):
    log = tmp_path / "run.txt"
    log.write_text(LOG.replace("\n\n", "\n"))
    plot_log.main(["--smoothing", "2", str(log), str(tmp_path / "loss.png")])
    assert _png(tmp_path / "loss.png")
    compare_logs.main(["--fields", "base_q.", "missing", "--", str(log), str(log),
                       str(tmp_path / "cmp.png")])
    assert _png(tmp_path / "cmp.png")
    assert "field 'missing' matched nothing" in capsys.readouterr().out
    assert compare_logs.field_value({"base_q0": 1.0, "base_q1": 3.0}, "base_q.") == 2.0
