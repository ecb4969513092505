"""The port's train CLIs on the CPU against the JAX package: a
``train_vqvae`` run on ``tones`` writes ``model.npz`` and EMA files that the
JAX package loads (the same forward, the usage counts carried) and a log
that its ``read_log`` parses; the run resumes from its own save with the
log truncated to it, the same bits twice; ``train_diffusion`` takes a
microbatched step and warm-starts a VQ-VAE through --pretrained-path from a
JAX-saved checkpoint; a JAX Orbax run directory and the flags not ported
are refused; ``train_vqvae`` trains on a WAV
directory. Also the data loaders, the log format and the loss tracker of
both packages.

Models are the full topology at base 2 (no JAX init runs; the JAX package
loads what the port saved). Tolerance: 1e-4 for one forward pass
(convolution sums in another order).
"""

import glob
import json
import os
import shutil
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vq_voice_swap_tpu.data import create_data_loader as jax_create_data_loader
from vq_voice_swap_tpu.diffusion_model import DiffusionModel as JaxDiffusionModel
from vq_voice_swap_tpu.model_base import ModelBase as JaxModelBase
from vq_voice_swap_tpu.observe import Logger as JaxLogger
from vq_voice_swap_tpu.observe import LossTracker as JaxLossTracker
from vq_voice_swap_tpu.observe import read_log
from vq_voice_swap_tpu.observe.logger import _scan_resume_point as jax_scan
from vq_voice_swap_torch import train_diffusion, train_vqvae
from vq_voice_swap_torch.convert import params_to_jax
from vq_voice_swap_torch.data import create_data_loader
from vq_voice_swap_torch.diffusion_model import DiffusionModel
from vq_voice_swap_torch.observe import Logger, LossTracker
from vq_voice_swap_torch.observe.logger import _scan_resume_point
from vq_voice_swap_torch.train import VQVAETrainLoop
from vq_voice_swap_torch.vq_vae import VQVAE

@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """CPU training at base 2-4 is thousands of tiny ops a step: one
    intra-op thread runs it about as fast as eight alone, and does not
    spin against the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


VQVAE_ARGS = ["--device", "cpu", "--base-channels", "2", "--batch-size", "2",
              "--class-cond", "--ema-rate", "0.99,0.9", "--save-interval", "2",
              "--jitter", "0.1", "tones"]


def _steps(path):
    return [step for step, _ in read_log(path)]


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_train_vqvae_cli_loads_in_jax_and_resumes(tmp_path):
    out = str(tmp_path / "run")
    train_vqvae.main(VQVAE_ARGS + ["--max-steps", "3", "--output-dir", out])
    log = os.path.join(out, "train_log.txt")
    with open(log) as f:
        lines = f.read().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["step 1", "step 2", "# saved", "step 3"]
    entries = list(read_log(log))
    assert [s for s, _ in entries] == [1, 2, 3]
    assert set(entries[0][1]) >= {"loss", "vq_loss", "codebook_used", "samples_per_sec"}
    assert all(np.isfinite(v) for _, fields in entries for v in fields.values())
    for name in ("model.npz", "model_ema_0.99.npz", "model_ema_0.9.npz", "opt.pt"):
        assert os.path.exists(os.path.join(out, name)), name

    # The JAX package loads the checkpoints; its forward is the port's.
    jax_model, variables = JaxModelBase.load(os.path.join(out, "model.npz"))
    assert type(jax_model).__name__ == "VQVAE" and jax_model.num_labels == 3
    saved = _arrays(os.path.join(out, "model.npz"))
    assert "buffers/vq/usage_count" in saved
    np.testing.assert_array_equal(np.asarray(variables["buffers"]["vq"]["usage_count"]),
                                  saved["buffers/vq/usage_count"])
    for rate in ("0.99", "0.9"):
        _, ema_vars = JaxModelBase.load(os.path.join(out, f"model_ema_{rate}.npz"))
        np.testing.assert_array_equal(np.asarray(ema_vars["buffers"]["vq"]["usage_count"]),
                                      saved["buffers/vq/usage_count"])
    x = (0.5 * np.tanh(np.random.RandomState(0).randn(2, 512, 1))).astype(np.float32)
    ts, labels = np.array([0.3, 0.8], np.float32), np.array([0, 2], np.int32)
    want = jax.jit(lambda v, x: jax_model.predict_eps(
        v, x, jnp.asarray(ts), cond=jax_model.encode_raw(v, x), labels=jnp.asarray(labels)))(
        variables, jnp.asarray(x))
    model = VQVAE.load(os.path.join(out, "model.npz"), device="cpu")
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = model.predict_eps(xt, torch.from_numpy(ts), cond=model.encode_raw(xt),
                                labels=torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)

    # Resume from the save at step 2: the log loses step 3, then runs on.
    copy = str(tmp_path / "copy")
    shutil.copytree(out, copy)
    for d in (out, copy):
        train_vqvae.main(VQVAE_ARGS + ["--max-steps", "2", "--output-dir", d])
    with open(log) as f:
        lines = f.read().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "step 1", "step 2", "# saved", "step 3", "step 4", "# saved"]
    assert _steps(log) == [1, 2, 3, 4]
    assert len(glob.glob(os.path.join(out, "run_info_*.json"))) >= 1
    with open(sorted(glob.glob(os.path.join(out, "run_info_*.json")))[-1]) as f:
        assert json.load(f)["args"]["ema_rate"] == "0.99,0.9"
    for name in ("model.npz", "model_ema_0.99.npz", "model_ema_0.9.npz"):
        a, b = _arrays(os.path.join(out, name)), _arrays(os.path.join(copy, name))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
    resumed = torch.load(os.path.join(out, "opt.pt"), weights_only=True)
    assert resumed["count"] == 4


def test_train_diffusion_cli_microbatches_and_jax_loads(tmp_path):
    out = str(tmp_path / "diff")
    train_diffusion.main(["--device", "cpu", "--base-channels", "2", "--batch-size", "3",
                          "--microbatch", "2", "--max-steps", "2", "--save-interval", "2",
                          "--dropout", "0.1", "--grad-clip", "1.0", "--lr-final", "1e-5",
                          "--lr-anneal-steps", "10", "--output-dir", out, "tones"])
    assert _steps(os.path.join(out, "train_log.txt")) == [1, 2]
    jax_model, variables = JaxModelBase.load(os.path.join(out, "model.npz"))
    assert type(jax_model).__name__ == "DiffusionModel" and jax_model.dropout == 0.1
    assert "buffers" not in variables
    model = DiffusionModel.load(os.path.join(out, "model.npz"), device="cpu")
    assert torch.load(os.path.join(out, "opt.pt"), weights_only=True)["count"] == 2
    assert any(p.abs().sum() > 0 for n, p in model.named_parameters() if "conv_out" in n)


def test_pretrained_path_takes_a_jax_saved_diffusion_model(tmp_path):
    """--pretrained-path of a VQ-VAE run from a DiffusionModel the JAX
    package saved: the predictor's weights are copied, the rest is fresh."""
    src = DiffusionModel(pred_name="unet", base_channels=2, num_labels=3)
    with torch.no_grad():
        for p in src.parameters():
            p.normal_()
    tree = traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in params_to_jax(src).items()})
    path = str(tmp_path / "pre.npz")
    JaxDiffusionModel(pred_name="unet", base_channels=2, num_labels=3).save(path, tree)
    args = VQVAETrainLoop.arg_parser().parse_args(
        VQVAE_ARGS + ["--pretrained-path", path, "--output-dir", str(tmp_path / "run")])
    loop = VQVAETrainLoop(args)
    got = loop.model.predictor.state_dict()
    for k, v in src.predictor.state_dict().items():
        if not k.startswith("cond_proj"):  # the VQ-VAE's predictor takes a cond sequence
            assert torch.equal(got[k], v), k
    assert not loop.resume and loop.total_steps == 0


@pytest.mark.parametrize("files,error,match", [
    # An npz run's optimizer state is read (tests/test_torch_checkpoint_extras.py);
    # one that is not flax msgpack raises before anything is written.
    (["opt.npz"], ValueError, "msgpack"),
    (["model.orbax/", "opt.orbax/", "train_log.txt"], RuntimeError, "model.orbax"),
    (["opt.orbax.new/"], RuntimeError, "opt.orbax"),
])
def test_train_cli_refuses_a_jax_run_directory(tmp_path, files, error, match):
    """A JAX Orbax run's directory is refused, and an unreadable npz run's
    optimizer state raises, before anything in the directory is touched:
    its log keeps its bytes."""
    out = tmp_path / "jax_run"
    out.mkdir()
    log = b"step 1: loss=0.50000\n"
    for name in files:
        if name.endswith("/"):
            (out / name).mkdir()
        else:
            (out / name).write_bytes(log if name == "train_log.txt" else b"msgpack")
    before = sorted(os.listdir(out))
    with pytest.raises(error, match=match):
        train_vqvae.main(VQVAE_ARGS + ["--output-dir", str(out)])
    assert sorted(os.listdir(out)) == before
    if "train_log.txt" in files:
        assert (out / "train_log.txt").read_bytes() == log


@pytest.mark.parametrize("flag", [
    ["--tensor-parallel", "2"], ["--fsdp", "--tensor-parallel", "2"],
    ["--checkpoint-format", "orbax"],
])
def test_train_clis_refuse_flags_not_ported(flag, capsys, tmp_path):
    """Orbax is not ported (an argparse error); --tensor-parallel 2 is, and
    is refused without the launcher (a world of one) with the JAX
    package's ValueError, with or without --fsdp."""
    for cli in (train_vqvae, train_diffusion):
        argv = ["--device", "cpu", *flag, "--output-dir", str(tmp_path), "tones"]
        if "--checkpoint-format" in flag:
            with pytest.raises(SystemExit) as err:
                cli.main(argv)
            assert err.value.code == 2
            message = capsys.readouterr().err.splitlines()[-1]
            assert "--checkpoint-format" in message and "invalid choice" in message, message
        else:
            with pytest.raises(ValueError, match="--tensor-parallel 2 needs a launched world "
                                                 "that 2 divides .* got a world of 1"):
                cli.main(argv)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("directory,batch", [("tones:2", 2), ("chirps:1", 3)])
def test_data_loader_matches_jax(directory, batch):
    """Two epochs: the same batches in the same order."""
    loader, labels = create_data_loader(directory, batch, seed=5)
    jax_loader, jax_labels = jax_create_data_loader(directory, batch, seed=5)
    assert labels == jax_labels and len(loader) == len(jax_loader)
    for _ in range(2):
        for got, want in zip(loader, jax_loader, strict=True):
            for k in ("label", "samples"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_train_vqvae_cli_trains_on_a_wav_directory(tmp_path):
    """A LibriSpeech-style directory (two speakers, 4.5 s files: three
    windows each) trains, and the JAX package loads the model, with one
    label per speaker."""
    rng = np.random.RandomState(3)
    for spk in ("p1", "p2"):
        os.makedirs(tmp_path / "ds" / spk / "c1")
        for utt in ("a", "b"):
            with wave.open(str(tmp_path / "ds" / spk / "c1" / f"{utt}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((0.2 * rng.randn(72000) * 32767).astype("<i2").tobytes())
    out = str(tmp_path / "run")
    train_vqvae.main(["--device", "cpu", "--base-channels", "2", "--batch-size", "2",
                      "--max-steps", "2", "--save-interval", "2", "--class-cond",
                      "--output-dir", out, str(tmp_path / "ds")])
    assert _steps(os.path.join(out, "train_log.txt")) == [1, 2]
    assert os.path.exists(tmp_path / "ds" / "index.json")
    assert os.path.exists(tmp_path / "ds" / ".window_cache" / "arena.f32")
    jax_model, variables = JaxModelBase.load(os.path.join(out, "model.npz"))
    assert type(jax_model).__name__ == "VQVAE" and jax_model.num_labels == 2
    assert variables["params"]["vq"]["dictionary"].shape == (512, 32)


def test_log_format_and_tracker_match_jax(tmp_path):
    """Both loggers write the same bytes, each package reads the other's,
    and both resume scans agree, the JAX package's asynchronous-save
    markers included; the trackers agree."""
    ours, theirs = str(tmp_path / "ours.txt"), str(tmp_path / "theirs.txt")
    port, jax_log = Logger(ours), JaxLogger(theirs)
    for lg in (port, jax_log):
        lg.log(1, loss=0.5, q0=1.25)
        lg.log(2, loss=0.25, codebook_used=512.0)
        lg.mark_save()
        lg.log(3, loss=0.125)
        lg.close()
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert list(read_log(ours)) == [(1, {"loss": 0.5, "q0": 1.25}),
                                     (2, {"loss": 0.25, "codebook_used": 512.0}),
                                     (3, {"loss": 0.125})]
    assert _scan_resume_point(ours) == jax_scan(ours)
    assert jax_scan(ours)[0] == 2

    jax_log = JaxLogger(theirs, resume=True)
    jax_log.log(1, loss=1.0)
    jax_log.mark_saving(1)
    jax_log.log(2, loss=2.0)
    jax_log.mark_save()
    jax_log.log(3, loss=3.0)
    jax_log.close()
    assert _scan_resume_point(theirs) == jax_scan(theirs)
    resumed = Logger(theirs, resume=True)
    assert resumed.start_step == 3
    resumed.log(1, loss=4.0)
    resumed.close()
    assert [s for s, _ in read_log(theirs)] == [1, 2, 3, 4]

    rng = np.random.RandomState(0)
    tracker, jax_tracker = LossTracker(avg_size=5), JaxLossTracker(avg_size=5)
    for _ in range(4):
        ts, losses = rng.rand(6).astype(np.float32), rng.rand(6).astype(np.float32)
        ts[0] = 1.0
        tracker.add(torch.from_numpy(ts), torch.from_numpy(losses))
        jax_tracker.add(ts, losses)
    assert tracker.log_dict() == jax_tracker.log_dict()
