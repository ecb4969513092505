"""The port's other train CLIs on the CPU: ``train_vqvae_add``,
``train_vqvae_uncond``, ``train_classifier`` (fresh and warm-started from a
diffusion model) and ``train_enc_pred`` each train, save ``model.npz`` and
EMA files that the JAX package loads (the same leaves and shapes as its
own init of the saved kwargs), and resume from their save with the log
truncated to it; add-classes moves only the new speakers' label rows; the
refusals (uncond with more speakers than the pretrained model, the
label-surgery loops without --pretrained-path, ``train_enc_pred`` without
--vq-vae-path). Also ``train_vqvae`` with the WaveGrad predictor and
encoder.

Models are the full topology at base 2-4; no JAX function is compiled.
"""

import os
import wave

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from vq_voice_swap_tpu.model_base import ModelBase as JaxModelBase
from vq_voice_swap_tpu.observe import read_log
from vq_voice_swap_torch import (sample_diffusion, sample_vqvae, train_classifier,
                                 train_diffusion, train_enc_pred, train_vqvae, train_vqvae_add,
                                 train_vqvae_uncond)
from vq_voice_swap_torch.classifier_model import ClassifierModel, EncoderPredictorModel
from vq_voice_swap_torch.convert import params_to_jax
from vq_voice_swap_torch.diffusion_model import DiffusionModel
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


COMMON = ["--device", "cpu", "--batch-size", "2", "--save-interval", "2",
          "--ema-rate", "0.9"]


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files if k != "__meta__"}


def _lines(out):
    with open(os.path.join(out, "train_log.txt")) as f:
        return [ln.split(":")[0] for ln in f.read().splitlines()]


def _run_and_resume(cli, argv, out):
    """Three steps (saved at step 2), then a rerun of one step from that
    save: the log loses the first run's step 3 and gains the rerun's."""
    cli.main(argv + ["--max-steps", "3", "--output-dir", out])
    assert _lines(out) == ["step 1", "step 2", "# saved", "step 3"]
    cli.main(argv + ["--max-steps", "1", "--output-dir", out])
    assert _lines(out) == ["step 1", "step 2", "# saved", "step 3"]
    assert [s for s, _ in read_log(os.path.join(out, "train_log.txt"))] == [1, 2, 3]
    assert torch.load(os.path.join(out, "opt.pt"), weights_only=True)["count"] == 2
    for name in ("model.npz", "model_ema_0.9.npz"):
        assert os.path.exists(os.path.join(out, name))


def _assert_jax_loads(path, class_name):
    """The JAX package loads the file as class_name, with the leaves and
    shapes of its own init of the saved kwargs."""
    model, variables = JaxModelBase.load(path)
    assert type(model).__name__ == class_name
    want = jax.eval_shape(lambda: model.init_variables(jax.random.key(0)))
    shapes = {"/".join(k): tuple(v.shape) for k, v in traverse_util.flatten_dict(want).items()}
    got = {"/".join(k): tuple(v.shape)
           for k, v in traverse_util.flatten_dict(variables).items()}
    assert got == shapes
    return model


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A 3-speaker VQ-VAE from one train_vqvae step at base 2, and a
    3-speaker unet DiffusionModel and a 2-speaker VQ-VAE, seeded."""
    root = tmp_path_factory.mktemp("pretrained")
    out = str(root / "vqvae")
    train_vqvae.main(["--device", "cpu", "--base-channels", "2", "--batch-size", "2",
                      "--max-steps", "1", "--save-interval", "1", "--class-cond",
                      "--output-dir", out, "tones"])
    paths = {"vqvae": os.path.join(out, "model.npz")}
    for name, model in (
        ("diffusion", DiffusionModel(pred_name="unet", base_channels=4, num_labels=3)),
        ("vqvae2", VQVAE(pred_name="unet", base_channels=2, num_labels=2)),
    ):
        paths[name] = str(root / f"{name}.npz")
        model.save(paths[name])
    return paths


def test_train_vqvae_add_cli_moves_only_the_new_label_rows(pretrained, tmp_path):
    out = str(tmp_path / "add")
    _run_and_resume(train_vqvae_add, COMMON + [
        "--class-cond", "--pretrained-path", pretrained["vqvae"], "tones"], out)
    model = _assert_jax_loads(os.path.join(out, "model.npz"), "VQVAE")
    assert model.num_labels == 6
    before, after = _arrays(pretrained["vqvae"]), _arrays(os.path.join(out, "model.npz"))
    assert before.keys() == after.keys()
    table = "params/predictor/class_embed/embedding"
    for k in before:
        if k == table:
            assert np.array_equal(after[k][:3], before[k]) and not np.allclose(after[k][3:], 0)
        elif k.startswith("params/"):
            assert np.array_equal(after[k], before[k]), k
    ema = _arrays(os.path.join(out, "model_ema_0.9.npz"))
    assert all(np.array_equal(ema[k], before[k]) for k in before
               if k.startswith("params/") and k != table)


def test_train_vqvae_uncond_cli(pretrained, tmp_path):
    out = str(tmp_path / "uncond")
    _run_and_resume(train_vqvae_uncond, COMMON + [
        "--class-cond", "--no-class-prob", "0.5", "--no-vq-prob", "0.5",
        "--pretrained-path", pretrained["vqvae"], "tones"], out)
    assert _assert_jax_loads(os.path.join(out, "model.npz"), "VQVAE").num_labels == 4
    before = _arrays(pretrained["vqvae"])["params/predictor/class_embed/embedding"]
    after = _arrays(os.path.join(out, "model.npz"))["params/predictor/class_embed/embedding"]
    assert after.shape == (4, before.shape[1]) and not np.array_equal(after[1:], before)


def test_train_classifier_cli(pretrained, tmp_path, capsys):
    out = str(tmp_path / "classifier")
    _run_and_resume(train_classifier, COMMON + [
        "--base-channels", "4", "--curriculum-steps", "2", "tones"], out)
    model = _assert_jax_loads(os.path.join(out, "model.npz"), "ClassifierModel")
    assert model.num_labels == 3
    loaded = ClassifierModel.load(os.path.join(out, "model.npz"), device="cpu")
    assert not any(p.requires_grad for p in loaded.parameters())

    warm = str(tmp_path / "warm")
    capsys.readouterr()
    train_classifier.main(COMMON + ["--base-channels", "4", "--max-steps", "1",
                                    "--pretrained-path", pretrained["diffusion"],
                                    "--output-dir", warm, "tones"])
    n = ClassifierModel(num_labels=3, base_channels=4).load_from_predictor(
        DiffusionModel.load(pretrained["diffusion"], device="cpu").predictor)
    assert f"loaded {n} pre-trained parameters" in capsys.readouterr().out


def test_train_enc_pred_cli(pretrained, tmp_path):
    out = str(tmp_path / "enc_pred")
    _run_and_resume(train_enc_pred, COMMON + [
        "--base-channels", "2", "--vq-vae-path", pretrained["vqvae"], "tones"], out)
    model = _assert_jax_loads(os.path.join(out, "model.npz"), "EncoderPredictorModel")
    vq_vae = VQVAE.load(pretrained["vqvae"], device="cpu")
    assert model.num_latents == vq_vae.dictionary_size
    assert model.downsample_rate == vq_vae.encoder.downsample_rate
    EncoderPredictorModel.load(os.path.join(out, "model.npz"), device="cpu")


def _write_wav(path, seconds=2, rate=16000):
    t = np.arange(seconds * rate) / rate
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((0.3 * np.sin(2 * np.pi * 220 * t) * (2**15 - 1)).astype("<i2").tobytes())


def test_train_vqvae_cli_with_wavegrad(tmp_path):
    """train_vqvae and train_diffusion with --predictor/--encoder wavegrad,
    then their checkpoints through sample_vqvae and sample_diffusion."""
    out = str(tmp_path / "wavegrad")
    train_vqvae.main(["--device", "cpu", "--predictor", "wavegrad", "--encoder", "wavegrad",
                      "--base-channels", "2", "--batch-size", "2", "--max-steps", "2",
                      "--save-interval", "2", "--class-cond", "--output-dir", out, "tones"])
    assert _lines(out) == ["step 1", "step 2", "# saved"]
    model = VQVAE.load(os.path.join(out, "model.npz"), device="cpu")
    assert model.pred_name == model.enc_name == "wavegrad" and model.downsample_rate == 64
    flat = params_to_jax(model)
    assert "params/predictor/u_block_4/film_3/label_emb/embedding" in flat
    assert "params/encoder/d_block_4/extra_conv_0_c/conv/kernel" in flat
    jax_model, variables = JaxModelBase.load(os.path.join(out, "model.npz"))
    assert jax_model.pred_name == "wavegrad"
    with pytest.raises(ValueError, match="fuse_levels"):
        DiffusionModel.load(os.path.join(out, "model.npz"), device="cpu", fuse_levels=2)
    src, swapped = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    _write_wav(src)
    sample_vqvae.main(["--device", "cpu", "--label", "2", "--input-file", src, "--seconds",
                       "2", "--sample-steps", "2", "--sampler", "dpmpp",
                       os.path.join(out, "model.npz"), swapped])
    with wave.open(swapped, "rb") as w:
        assert w.getnframes() == 32000

    diffusion = str(tmp_path / "wavegrad_diffusion")
    train_diffusion.main(["--device", "cpu", "--predictor", "wavegrad", "--base-channels", "2",
                          "--batch-size", "2", "--max-steps", "1", "--save-interval", "1",
                          "--output-dir", diffusion, "tones"])
    samples = str(tmp_path / "samples")
    sample_diffusion.main(["--device", "cpu", "--checkpoint-path",
                           os.path.join(diffusion, "model.npz"), "--sample-steps", "2",
                           "--num-samples", "1", "--sample-path", samples])
    assert os.listdir(samples) == ["sample_000000.wav"]


def test_refusals(pretrained, tmp_path):
    with pytest.raises(ValueError, match="knows 2; grow the label space"):
        train_vqvae_uncond.main(COMMON + ["--class-cond", "--pretrained-path",
                                          pretrained["vqvae2"], "--output-dir",
                                          str(tmp_path / "u"), "tones"])
    for cli in (train_vqvae_add, train_vqvae_uncond):
        with pytest.raises(ValueError, match="--pretrained-path"):
            cli.main(COMMON + ["--class-cond", "--output-dir", str(tmp_path / "a"), "tones"])
        with pytest.raises(ValueError, match="--class-cond"):
            cli.main(COMMON + ["--pretrained-path", pretrained["vqvae"], "--output-dir",
                               str(tmp_path / "b"), "tones"])
    with pytest.raises(SystemExit):
        train_enc_pred.main(COMMON + ["--output-dir", str(tmp_path / "c"), "tones"])
    classifier = str(tmp_path / "classifier.npz")
    ClassifierModel(num_labels=3, base_channels=2).save(classifier)
    with pytest.raises(ValueError, match="unsupported pretrained model"):
        train_classifier.main(COMMON + ["--base-channels", "2", "--pretrained-path",
                                        classifier, "--output-dir", str(tmp_path / "d"),
                                        "tones"])


@pytest.mark.parametrize("cli,flags", [
    (train_vqvae_add, ["--class-cond", "--pretrained-path"]),
    (train_vqvae_uncond, ["--class-cond", "--pretrained-path"]),
    (train_classifier, []),
    (train_enc_pred, ["--vq-vae-path"]),
])
def test_train_clis_run_on_cuda_unless_asked(cli, flags, pretrained, tmp_path, monkeypatch):
    """Without --device the CLIs take CUDA, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = flags + [pretrained["vqvae"]] if flags else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv + ["--output-dir", str(tmp_path / "e"), "tones"])
