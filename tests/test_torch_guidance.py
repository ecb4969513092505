"""Guided sampling in the PyTorch port against the JAX package: the
classifier and the encoder predictor (logits, losses and their guidance
gradients), the three samplers with a cond_fn, ``VQVAE.decode`` with
encoder-predictor guidance and ``decode_uncond_guidance``, and the three
guided CLIs on the CPU.

Models are small (base 4-8 channels, three-level stacks for the guidance
networks; the VQ-VAE is the swap slice's test topology at base 4). The port
builds them with seeded numpy weights and saves them; the JAX package loads
the same ``.npz``, so no JAX init runs. The two packages draw different
random numbers, so the port gets the JAX samplers' x_T and noise.
Tolerances: 1e-4 for one forward pass (convolution sums in another order),
1e-4 of the largest gradient for a guidance gradient, 1e-5 for the
samplers on a toy predictor (float32 sampler math) and 1e-3 for three
decode steps through the UNet (as the swap slice's decode test).
"""

import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch_port_util import randomize_params

from vq_voice_swap_tpu.classifier_model import ClassifierModel as JaxClassifierModel
from vq_voice_swap_tpu.classifier_model import EncoderPredictorModel as JaxEncPredModel
from vq_voice_swap_tpu.diffusion import Diffusion as JaxDiffusion
from vq_voice_swap_tpu.diffusion import make_schedule as jax_schedule
from vq_voice_swap_tpu.vq_vae import VQVAE as JaxVQVAE
from vq_voice_swap_torch import sample_diffusion, sample_vqvae, sample_vqvae_uncond
from vq_voice_swap_torch.classifier_model import ClassifierModel, EncoderPredictorModel
from vq_voice_swap_torch.convert import params_from_jax, params_to_jax
from vq_voice_swap_torch.diffusion import Diffusion, make_schedule
from vq_voice_swap_torch.diffusion_model import DiffusionModel
from vq_voice_swap_torch.vq_vae import VQVAE

CLASSIFIER = dict(num_labels=5, base_channels=8, channel_mult=(1, 2, 16), depth_mult=1)
ENC_PRED = dict(base_channels=4, downsample_rate=320, num_latents=16, bottleneck_dim=8,
                channel_mult=(1, 2, 2), depth_mult=1)
VQVAE_KWARGS = dict(pred_name="unet", base_channels=4, enc_name="conv-mfcc-ulaw",
                    dictionary_size=16, num_labels=3)
SAMPLES = 2560  # a multiple of the VQ-VAE's rate (lcm of 256 and 320)


def _seed_params(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded numpy weights for every parameter (buffers keep their values)."""
    flat = params_to_jax(module)
    tree = traverse_util.unflatten_dict(
        {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}, sep="/")
    tree = traverse_util.flatten_dict(randomize_params(tree, seed), sep="/")
    module.load_state_dict(params_from_jax({f"params/{k}": v for k, v in tree.items()}),
                           strict=False)
    return module.eval()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Paths of seeded checkpoints saved by the port: a classifier, an
    encoder predictor, a VQ-VAE and an unconditional diffusion model."""
    root = tmp_path_factory.mktemp("guidance")
    paths = {}
    for name, model, seed in (
        ("classifier", ClassifierModel(**CLASSIFIER), 1),
        ("enc_pred", EncoderPredictorModel(**ENC_PRED), 2),
        ("vqvae", VQVAE(**VQVAE_KWARGS), 3),
        ("uncond", DiffusionModel(pred_name="unet", base_channels=4), 4),
    ):
        paths[name] = str(root / f"{name}.npz")
        _seed_params(model, seed).save(paths[name])
    return paths


def _noised(seed: int, n: int, t: int):
    rng = np.random.RandomState(seed)
    x = (0.5 * rng.randn(n, t, 1)).astype(np.float32)
    return x, np.asarray([0.3, 0.8][:n], np.float32)


def _close_grads(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------- the two networks


@pytest.mark.parametrize("cls,jax_cls,kwargs", [
    (ClassifierModel, JaxClassifierModel, CLASSIFIER),
    (EncoderPredictorModel, JaxEncPredModel, ENC_PRED),
])
def test_param_tree_is_the_jax_init_tree(cls, jax_cls, kwargs):
    """The port's parameters, named and shaped as the flax init makes them
    (traced with eval_shape, nothing computed)."""
    jmodel = jax_cls(**kwargs)
    shapes = jax.eval_shape(lambda: jmodel.init_variables(jax.random.key(0), seq_len=2560))
    want = {f"params/{k}": tuple(v.shape)
            for k, v in traverse_util.flatten_dict(shapes["params"], sep="/").items()}
    got = {k: v.shape for k, v in params_to_jax(cls(**kwargs)).items()}
    assert got == want


def test_classifier_logits_and_guidance_match_flax(ckpts):
    jmodel, jvars = JaxClassifierModel.load(ckpts["classifier"])
    port = ClassifierModel.load(ckpts["classifier"], device="cpu")
    assert not any(p.requires_grad for p in port.parameters())
    x, ts = _noised(5, 2, 256)
    labels = np.asarray([1, 4], np.int32)

    def logprob_sum(xx):  # the JAX sample_diffusion.py cond_fn, before its scale
        logp = jax.nn.log_softmax(jmodel.logits(jvars, xx, jnp.asarray(ts)), axis=-1)
        return jnp.sum(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=-1))

    want_logits, want_grad = jax.jit(lambda xx: (
        jmodel.logits(jvars, xx, jnp.asarray(ts)), 1.5 * jax.grad(logprob_sum)(xx)
    ))(jnp.asarray(x))
    with torch.no_grad():  # cond_fn takes its gradient inside the samplers' no_grad
        got = port(torch.from_numpy(x), torch.from_numpy(ts))
        got_grad = port.cond_fn(torch.from_numpy(labels).long(), 1.5)(
            torch.from_numpy(x), torch.from_numpy(ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_logits), atol=1e-4, rtol=1e-4)
    _close_grads(got_grad, want_grad)


def test_enc_pred_logits_losses_and_guidance_match_flax(ckpts):
    jmodel, jvars = JaxEncPredModel.load(ckpts["enc_pred"])
    port = EncoderPredictorModel.load(ckpts["enc_pred"], device="cpu")
    x, ts = _noised(6, 2, 1280)
    targets = np.random.RandomState(7).randint(0, 16, (2, 4)).astype(np.int32)
    jts, jtg = jnp.asarray(ts), jnp.asarray(targets)

    def total_loss(xx):  # the JAX VQVAE.decode cond_fn, before its scale
        return jnp.sum(jmodel.losses(jvars, xx, jts, jtg) * targets.shape[-1])

    want = jax.jit(lambda xx: (
        jmodel.logits(jvars, xx, jts), jmodel.losses(jvars, xx, jts, jtg),
        -0.7 * jax.grad(total_loss)(xx),
    ))(jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(ts))
        got_losses = port.losses(torch.from_numpy(x), torch.from_numpy(ts),
                                 torch.from_numpy(targets).long())
        got_grad = port.cond_fn(torch.from_numpy(targets).long(), 0.7)(
            torch.from_numpy(x), torch.from_numpy(ts))
    assert got.shape == (2, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(want[1]), atol=1e-4, rtol=1e-4)
    _close_grads(got_grad, want[2])


def test_guidance_networks_load_frozen_and_unfused(ckpts):
    model = EncoderPredictorModel.load(ckpts["enc_pred"], device="cpu")
    assert model.unet.fuse_levels == 0
    assert not any(p.requires_grad for p in model.parameters())


# ------------------------------------------------------------------ samplers


def _toy_jax(x, ts):
    return 0.8 * x * ts[:, None, None] + 0.1 * jnp.sin(3.0 * x)


def _toy_torch(x, ts):
    return 0.8 * x * ts[:, None, None] + 0.1 * torch.sin(3.0 * x)


def _cond_jax(x, ts):
    return -0.3 * x * (1.0 + ts[:, None, None]) + 0.05 * jnp.cos(2.0 * x)


def _cond_torch(x, ts):
    return -0.3 * x * (1.0 + ts[:, None, None]) + 0.05 * torch.cos(2.0 * x)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpmpp"])
def test_guided_samplers_match_jax(monkeypatch, sampler):
    """Three guided steps of each sampler with the x0 constraint; DDPM with
    the JAX sampler's own noise handed to the port."""
    steps = 3
    jd, td = JaxDiffusion(jax_schedule("exp")), Diffusion(make_schedule("exp"))
    x_T = np.random.RandomState(8).randn(3, 64, 1).astype(np.float32)
    jx, tx = jnp.asarray(x_T), torch.from_numpy(x_T)
    kw = dict(constrain=True)
    if sampler == "ddpm":
        key = jax.random.key(9)
        want = jd.ddpm_sample(jx, _toy_jax, steps, key, cond_fn=_cond_jax, **kw)
        noises = [torch.from_numpy(np.array(jax.random.normal(k, x_T.shape, jnp.float32)))
                  for k in jax.random.split(key, steps)][:-1]
        monkeypatch.setattr(torch, "randn", lambda shape, **_: noises.pop(0))
        got = td.ddpm_sample(tx, _toy_torch, steps, cond_fn=_cond_torch, **kw)
        assert not noises
    elif sampler == "ddim":
        want = jd.ddim_sample(jx, _toy_jax, steps, cond_fn=_cond_jax, **kw)
        got = td.ddim_sample(tx, _toy_torch, steps, cond_fn=_cond_torch, **kw)
    else:
        want = jd.dpmpp_sample(jx, _toy_jax, steps, cond_fn=_cond_jax, **kw)
        got = td.dpmpp_sample(tx, _toy_torch, steps, cond_fn=_cond_torch, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    unguided = getattr(td, f"{sampler}_sample")
    if sampler != "ddpm":
        # A zero gradient shifts epsilon by exactly 0: the unguided bits.
        zero = unguided(tx, _toy_torch, steps, cond_fn=lambda x, ts: torch.zeros_like(x), **kw)
        assert torch.equal(zero, unguided(tx, _toy_torch, steps, **kw))


def test_guided_ddpm_previous_matches_jax():
    """One guided ancestral step with injected noise: the mean shifted by
    sigma^2 * cond_fn(mean, t - step), folded back into epsilon."""
    jd, td = JaxDiffusion(jax_schedule("exp")), Diffusion(make_schedule("exp"))
    rng = np.random.RandomState(10)
    xt, eps, noise = (rng.randn(3, 64, 1).astype(np.float32) for _ in range(3))
    ts = np.full(3, 0.6, np.float32)
    for sigma_large in (False, True):
        want = jd.ddpm_previous(*(jnp.asarray(a) for a in (xt, ts)), jnp.float32(0.1),
                                jnp.asarray(eps), jnp.asarray(noise), sigma_large=sigma_large,
                                constrain=True, cond_fn=_cond_jax)
        got = td.ddpm_previous(*(torch.from_numpy(a) for a in (xt, ts)), 0.1,
                               torch.from_numpy(eps), torch.from_numpy(noise),
                               sigma_large=sigma_large, constrain=True, cond_fn=_cond_torch)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ----------------------------------------------------- guided VQ-VAE decode


@pytest.fixture(scope="module")
def codes():
    return np.random.RandomState(11).randint(0, 16, (2, SAMPLES // 320)).astype(np.int32)


def _jax_x_T(key, n):
    _, noise_key = jax.random.split(key)  # decode's own x_T draw
    return np.array(jax.random.normal(noise_key, (n, SAMPLES, 1), jnp.float32))


def test_decode_with_enc_pred_guidance_matches_jax(ckpts, codes):
    """Three DPM++ steps guided by the encoder predictor, whose targets are
    the VQ assignment of the codes' own embeddings."""
    jmodel, jvars = JaxVQVAE.load(ckpts["vqvae"])
    jep, jep_vars = JaxEncPredModel.load(ckpts["enc_pred"])
    key = jax.random.key(12)
    want = jax.jit(lambda v, c, r: jmodel.decode(
        v, c, r, labels=jnp.asarray([0, 2], jnp.int32), steps=3, constrain=True,
        enc_pred=(jep.module, jep_vars), enc_pred_scale=0.7, sampler="dpmpp",
    ))(jvars, jnp.asarray(codes), key)
    port = VQVAE.load(ckpts["vqvae"], device="cpu")
    enc_pred = EncoderPredictorModel.load(ckpts["enc_pred"], device="cpu")
    with torch.no_grad():
        got = port.decode(torch.from_numpy(codes).long(), labels=torch.tensor([0, 2]),
                          steps=3, constrain=True, sampler="dpmpp",
                          x_T=torch.from_numpy(_jax_x_T(key, 2)), enc_pred=enc_pred,
                          enc_pred_scale=0.7)
        unguided = port.decode(torch.from_numpy(codes).long(), labels=torch.tensor([0, 2]),
                               steps=3, constrain=True, sampler="dpmpp",
                               x_T=torch.from_numpy(_jax_x_T(key, 2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    assert (got - unguided).abs().max() > 1e-2  # the guidance moved the sample


def test_decode_uncond_guidance_matches_jax(ckpts, codes):
    """Three DDIM steps of classifier-free guidance on the 3x stacked batch
    (codes, no codes, no label)."""
    jmodel, jvars = JaxVQVAE.load(ckpts["vqvae"])
    key = jax.random.key(13)
    want = jax.jit(lambda v, c, r: jmodel.decode_uncond_guidance(
        v, c, r, labels=jnp.asarray([0, 1], jnp.int32), steps=3, constrain=True,
        label_scale=1.0, vq_scale=0.5, sampler="ddim",
    ))(jvars, jnp.asarray(codes), key)
    port = VQVAE.load(ckpts["vqvae"], device="cpu")
    with torch.no_grad():
        got = port.decode_uncond_guidance(
            torch.from_numpy(codes).long(), labels=torch.tensor([0, 1]), steps=3,
            constrain=True, label_scale=1.0, vq_scale=0.5, sampler="ddim",
            x_T=torch.from_numpy(_jax_x_T(key, 2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


# ---------------------------------------------------------------- the CLIs


def _write_wav(path, seconds=2, rate=16000):
    t = np.arange(seconds * rate)
    samples = 0.3 * np.sin(t * 0.05) + 0.01 * np.random.RandomState(2).randn(t.size)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((samples * (2**15 - 1)).astype("<i2").tobytes())


def _frames(path):
    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def test_sample_vqvae_cli_with_enc_pred(ckpts, tmp_path, capsys):
    src, out = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    _write_wav(src)
    sample_vqvae.main(["--label", "1", "--input-file", src, "--seconds", "2",
                       "--sample-steps", "2", "--sampler", "ddim", "--check-vq",
                       "--enc-pred-path", ckpts["enc_pred"], "--enc-pred-scale", "0.5",
                       "--device", "cpu", ckpts["vqvae"], out])
    assert _frames(out).shape == (32000,)
    printed = capsys.readouterr().out
    assert "loading encoder predictor" in printed and "consistent VQ codes" in printed


def test_sample_diffusion_cli_with_classifier(ckpts, tmp_path):
    out = str(tmp_path / "samples")
    argv = ["--device", "cpu", "--checkpoint-path", ckpts["uncond"], "--sampler", "dpmpp",
            "--sample-steps", "1", "--num-samples", "2", "--batch-size", "2",
            "--sample-path", out, "--classifier-path", ckpts["classifier"]]
    sample_diffusion.main(argv + ["--classifier-scale", "0"])
    unguided = [_frames(os.path.join(out, f"sample_{i:06}.wav")) for i in range(2)]
    for name in os.listdir(out):
        os.remove(os.path.join(out, name))
    sample_diffusion.main(argv + ["--classifier-scale", "20", "--target-class", "4"])
    guided = [_frames(os.path.join(out, f"sample_{i:06}.wav")) for i in range(2)]
    assert all(g.shape == (sample_diffusion.SAMPLE_LEN,) for g in guided)
    assert any(not np.array_equal(g, u) for g, u in zip(guided, unguided))
    with pytest.raises(SystemExit, match="out of range for a 5-class"):
        sample_diffusion.main(argv + ["--target-class", "5"])


def test_sample_vqvae_uncond_cli(ckpts, tmp_path, capsys):
    src, out = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    _write_wav(src)
    argv = ["--input-file", src, "--seconds", "2", "--sample-steps", "2",
            "--guide-vq-scale", "0.5", "--schedule", "quadratic", "--sampler", "dpmpp",
            "--device", "cpu", ckpts["vqvae"], out]
    sample_vqvae_uncond.main(["--label", "1", "--check-vq", *argv])
    assert _frames(out).shape == (32000,)
    assert "consistent VQ codes" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="out of range"):
        sample_vqvae_uncond.main(["--label", "2", *argv])
