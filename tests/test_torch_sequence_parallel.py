"""Sequence parallelism in the PyTorch port (``parallel/sequence.py`` and
``long_audio_convert.py``) on the CPU, with one world of 4 gloo ranks
spawned from the test (``tests/torch_parallel_worker.py``'s ``seq_suite``,
a module fixture, so one spawn), interior ranks having both neighbours.
Widths are JAX's test widths (``tests/test_sequence_parallel.py``): base
4, ``channel_mult=(1, 2)``, T = 256 (the WaveGrad modules at base 2 and
T = 2048, so each rank's 512 samples keep their widest halo, 16, at the
T / 32 levels). Inputs are seeded numpy; every port output is gathered
whole and held against the JAX package on the CPU:

- the blocks against JAX's ``seq_sharded_*`` on the 8-device mesh within
  1e-5: conv at dilations 1-8, GroupNorm, pooling and upsampling;
  ``halo_exchange``'s input gradient against JAX's on a 4-device mesh
  (the same shards); GroupNorm with FiLM and GELU through the split
  backward (reduce, all-reduce, dx) against the VJP of JAX's
  ``reference_group_norm`` with the FiLM and GELU after it;
- a large-mean GroupNorm against a float64 two-pass reference (flax's
  one-pass variance loses it; the port's two-pass does not);
- the UNet and WaveGrad encoders and predictors against the port's own
  unsharded modules within 1e-5, and against the JAX package's on the
  same weights within 2e-5 (the WaveGrad predictor 5e-5, see
  SWAP_WAVEGRAD); the DDPM, DDIM and DPM++ samplers (3 steps, x0
  constraint) and the VQ-VAE conversion against the JAX samplers and
  modules on the same x_T and the same DDPM noise (the port's seeded
  draws, reproduced here) within 5e-5; each of these of the larger of 1
  and the output's largest magnitude;
- one train step: the loss within 1e-5 relative and every gradient within
  5e-5 abs / 5e-4 rel of JAX's unsharded ones, and the parameters after
  it the one-process AdamW step from those gradients, bit for bit;
- ``long_audio_convert`` at world 4 against world 1 (5e-5), and world 1
  against the one-device ``VQVAE.encode``/``decode``; the refusals: the
  MFCC encoder's TypeError, an over-wide halo's ValueError, the fused
  predictor and the --tensor-parallel/--fsdp/--fuse-levels flags.
"""

import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_worker as worker
from test_torch_train import _jax_variables, _seed_weights, _torch_grads
from test_torch_wavegrad import seed_wavegrad
from torch_parallel_worker import run_group, seq_module, tiny_vqvae
from vq_voice_swap_tpu.diffusion import Diffusion as JaxDiffusion
from vq_voice_swap_tpu.diffusion import make_schedule as jax_make_schedule
from vq_voice_swap_tpu.models.unet import UNetEncoder as JaxUNetEncoder
from vq_voice_swap_tpu.models.unet import UNetPredictor as JaxUNetPredictor
from vq_voice_swap_tpu.models.wavegrad import WaveGradEncoder as JaxWaveGradEncoder
from vq_voice_swap_tpu.models.wavegrad import WaveGradPredictor as JaxWaveGradPredictor
from vq_voice_swap_tpu.ops.fused_norm import reference_group_norm
from vq_voice_swap_tpu.parallel import sequence as jsq
from vq_voice_swap_tpu.vq import vq_forward as jax_vq_forward
from vq_voice_swap_torch import long_audio_convert
from vq_voice_swap_torch.diffusion.process import _step_time
from vq_voice_swap_torch.model_base import ModelBase
from vq_voice_swap_torch.ops.group_norm import group_norm
from vq_voice_swap_torch.parallel.sequence import (create_seq_mesh, halo_exchange,
                                                   seq_parallel_unet_predictor,
                                                   seq_parallel_vqvae_convert)
from vq_voice_swap_torch.train import build_optimizer
from vq_voice_swap_torch.vq_vae import VQVAE

RANKS = 4
T = 256
T_WAVEGRAD = 2048
GROUPS = 4
HALO = (2, 3)
STEPS = 3
SEED = 5
CLIP = 300  # samples of the CLI's WAV: 296 at world 4 (a multiple of 2 x 4 ranks)
KEPT = CLIP // 8 * 8  # the world-1 run reads these 296 alone
SWAP = 2e-5  # forwards
# The WaveGrad predictor's, against the JAX package: its unsharded port is
# 1.3e-5 of the output scale from JAX at these weights, the sharded run
# 1e-5 more from the unsharded one (edge convolutions summed in another
# order), 2.25e-5 in all.
SWAP_WAVEGRAD = 5e-5
SAMPLE = 5e-5  # samplers and conversion


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _seeded(kind, seed):
    model = seq_module(kind)
    (seed_wavegrad if kind.startswith("wavegrad") else _seed_weights)(model, seed)
    return model


def _model_inputs(rng):
    """Audio-like x (0.5 tanh of normal noise), normal cond."""
    audio = lambda t: (0.5 * np.tanh(rng.randn(2, t, 1))).astype(np.float32)  # noqa: E731
    cond = lambda t, c: rng.randn(2, t, c).astype(np.float32)  # noqa: E731
    ts = np.array([0.3, 0.8], np.float32)
    labels = np.array([1, 2], np.int64)
    return {
        "unet_encoder": dict(x=audio(T)),
        "unet": dict(x=audio(T), ts=ts, cond=cond(T // 2, 8), labels=labels),
        "wavegrad": dict(x=audio(T_WAVEGRAD), ts=ts, cond=cond(T_WAVEGRAD // 64, 8),
                         labels=labels),
        "wavegrad_encoder": dict(x=audio(T_WAVEGRAD)),
    }


def _write_wav(path, samples, rate=16000):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((samples * (2**15 - 1)).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(spec, the models it was built from): every input of the spawned
    world, seeded."""
    rng = np.random.RandomState(0)
    f32 = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa: E731
    blocks = dict(
        conv_x=f32(2, 4, T), conv_w=f32(8, 4, 3), conv_b=f32(8), dilations=[1, 2, 4, 8],
        gn_x=f32(2, 8, T), gn_large_x=(300.0 + 0.01 * rng.randn(1, 8, T)).astype(np.float32),
        gn_scale=(0.5 + rng.rand(8)).astype(np.float32), gn_bias=f32(8), groups=GROUPS,
        bwd_x=f32(2, 8, T), bwd_dy=f32(2, 8, T), ca=0.3 * f32(2, 8), cb=0.3 * f32(2, 8),
        pool_x=f32(1, 4, T), halo_x=f32(2, 3, T), halo=list(HALO),
        halo_w=f32(RANKS, 2, 3, T // RANKS + sum(HALO)),
    )
    models = {kind: _seeded(kind, i) for i, kind in
              enumerate(("unet_encoder", "unet", "wavegrad", "wavegrad_encoder"))}
    inputs = _model_inputs(rng)
    sampler_model = _seeded("unet_plain", 7)
    train_model = _seeded("unet_labels", 8)
    vqvae = tiny_vqvae()
    _seed_weights(vqvae, 9)
    with torch.no_grad():  # codes spread around the encoder's outputs
        enc = vqvae.encode_raw(torch.from_numpy(0.3 * f32(1, T, 1)))
        vqvae.vq.dictionary.copy_(enc.mean(dim=(0, 1)) + vqvae.vq.dictionary * enc.std())
    root = tmp_path_factory.mktemp("cli")
    ckpt = str(root / "model.npz")
    vqvae.save(ckpt)
    pcm = 0.3 * np.sin(np.arange(CLIP) * 0.05) + 0.01 * rng.randn(CLIP)
    _write_wav(str(root / "in.wav"), pcm)
    _write_wav(str(root / "in1.wav"), pcm[:KEPT])
    cli = ["--checkpoint-path", ckpt, "--label", "1", "--steps", "2", "--seed", "3"]
    spec = dict(
        blocks=blocks,
        models={k: (_state(models[k]), inputs[k]) for k in models},
        samplers=dict(state=_state(sampler_model), x_T=f32(1, T, 1), seed=SEED, steps=STEPS),
        convert=dict(state=_state(vqvae), x=0.3 * f32(1, T, 1), labels=np.array([1]),
                     seed=SEED, steps=STEPS),
        train=dict(state=_state(train_model), x=0.3 * f32(2, T, 1),
                   labels=np.array([1, 2], np.int64), seed=SEED),
        cli=cli + ["--input", str(root / "in.wav"), "--output", str(root / "out4.wav")],
    )
    built = dict(models=models, inputs=inputs, sampler=sampler_model, train=train_model,
                 vqvae=vqvae, cli=cli, root=root)
    return spec, built


@pytest.fixture(scope="module")
def ranks(setup):
    """Each rank's results of the one spawned world of RANKS ranks."""
    return run_group(RANKS, "seq_suite", setup[0], timeout=240.0)


@pytest.fixture(scope="module")
def got(ranks):
    return ranks[0]


# ------------------------------------------------------------------ blocks


def _sharded(mesh, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, jsq.SEQ_AXIS, None)))


def _ntc(x):  # the port's [N, C, T] as JAX's [N, T, C]
    return np.ascontiguousarray(np.swapaxes(x, 1, 2))


@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
def test_conv_matches_jax(setup, got, dilation):
    b = setup[0]["blocks"]
    mesh = jsq.create_seq_mesh()
    want = jsq.seq_sharded_conv1d(mesh, _sharded(mesh, _ntc(b["conv_x"])),
                                  jnp.asarray(b["conv_w"].transpose(2, 1, 0)),
                                  jnp.asarray(b["conv_b"]), dilation=dilation)
    np.testing.assert_allclose(_ntc(got["conv"][dilation]), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_group_norm_matches_jax(setup, got):
    b = setup[0]["blocks"]
    mesh = jsq.create_seq_mesh()
    want = jsq.seq_sharded_group_norm(mesh, _sharded(mesh, _ntc(b["gn_x"])),
                                      jnp.asarray(b["gn_scale"]), jnp.asarray(b["gn_bias"]),
                                      GROUPS)
    np.testing.assert_allclose(_ntc(got["gn"]), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_group_norm_large_mean_against_float64(setup, got):
    """300 + 0.01 noise: each shard's two-pass statistics merged by Chan's
    rule keep the variance that a one-pass E[x^2] - mean^2 cancels away.
    The output is within one float32 step of the mean at 300, in units of
    the group's std (3.05e-3), of the float64 result, and each normalised
    group's variance is var / (var + eps) within 1%."""
    b = setup[0]["blocks"]
    x = b["gn_large_x"].astype(np.float64)
    n, c, t = x.shape
    g = x.reshape(n, GROUPS, -1)
    mean = g.mean(-1, keepdims=True)
    var = ((g - mean) ** 2).mean(-1, keepdims=True)
    want = ((g - mean) / np.sqrt(var + 1e-5)).reshape(n, c, t)
    want = want * b["gn_scale"][:, None] + b["gn_bias"][:, None]
    assert np.isfinite(got["gn_large"]).all()
    step = float(np.spacing(np.float32(300.0))) / np.sqrt(var).min()
    np.testing.assert_allclose(got["gn_large"], want, atol=step, rtol=0)
    normed = (got["gn_large"] - b["gn_bias"][:, None]) / b["gn_scale"][:, None]
    np.testing.assert_allclose(normed.reshape(n, GROUPS, -1).var(-1),
                               (var / (var + 1e-5))[..., 0], rtol=1e-2)


def test_group_norm_split_backward_matches_jax(setup, got):
    """GroupNorm, FiLM h*(ca+1)+cb and GELU through the sharded forward and
    the split backward: dx and the summed affine and FiLM gradients."""
    b = setup[0]["blocks"]

    def fn(x, scale, bias, ca, cb):
        h = reference_group_norm(x, scale, bias, GROUPS, 1e-5, False)
        return jax.nn.gelu(h * (ca[:, None] + 1.0) + cb[:, None], approximate=False)

    args = [jnp.asarray(v) for v in (_ntc(b["bwd_x"]), b["gn_scale"], b["gn_bias"], b["ca"],
                                     b["cb"])]
    _, vjp = jax.vjp(fn, *args)
    dx, *leaves = vjp(jnp.asarray(_ntc(b["bwd_dy"])))
    np.testing.assert_allclose(_ntc(got["gn_bwd"]["dx"]), np.asarray(dx), atol=1e-5, rtol=1e-5)
    want = np.concatenate([np.asarray(v).reshape(-1) for v in leaves])
    np.testing.assert_allclose(got["gn_bwd"]["leaves"], want, atol=1e-5, rtol=1e-5)


def test_pool_and_upsample_match_jax(setup, got):
    x = setup[0]["blocks"]["pool_x"]
    mesh = jsq.create_seq_mesh()
    pooled = jsq.seq_sharded_avg_pool(mesh, _sharded(mesh, _ntc(x)), 2)
    up = jsq.seq_sharded_upsample(mesh, _sharded(mesh, _ntc(x)), 2)
    np.testing.assert_allclose(_ntc(got["pool"]), np.asarray(pooled), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_ntc(got["upsample"]), np.asarray(up), atol=1e-5, rtol=1e-5)


def test_halo_exchange_gradient_matches_jax(setup, got):
    """The gradient of sum(halo(x) * w) with respect to x: each halo's
    gradient sent back onto its sender's edge, on 4 JAX devices (the same
    shards as the 4 ranks)."""
    b = setup[0]["blocks"]
    mesh = jsq.create_seq_mesh(RANKS)
    left, right = HALO
    spec = P(None, jsq.SEQ_AXIS, None)
    w = np.concatenate([_ntc(v) for v in b["halo_w"]], axis=1)

    def loss(x):
        f = shard_map(lambda xl, wl: jsq.halo_exchange(xl, left, right) * wl, mesh=mesh,
                      in_specs=(spec, spec), out_specs=spec)
        return jnp.sum(f(x, jnp.asarray(w)))

    want = jax.jit(jax.grad(loss))(_sharded(mesh, _ntc(b["halo_x"])))
    np.testing.assert_allclose(_ntc(got["halo_grad"]), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_over_wide_halo_raises(got):
    assert "exceeds local block" in got["wide_halo"]
    with pytest.raises(ValueError, match="exceeds local block 4"):
        halo_exchange(torch.zeros(1, 1, 4), 5, 0, create_seq_mesh())


# ------------------------------------------------------------------ models


def _assert_scaled_close(got, want, tol):
    """Within ``tol`` of the larger of 1 and the largest magnitude of want
    (the seeded WaveGrad's outputs reach 3, and float32 rounding grows
    with them through its 30-odd convolutions: the unsharded port is
    within 1.3e-5 of that scale of the JAX package there)."""
    want = np.asarray(want)
    err = np.abs(got.astype(np.float64) - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, err


def _jax_module(kind):
    unet = dict(base_channels=4, channel_mult=(1, 2), depth_mult=1, middle_dilations=(2,))
    return {
        "unet_encoder": lambda: JaxUNetEncoder(base_channels=4, channel_mult=(1, 2),
                                               depth_mult=1, out_channels=8,
                                               out_dilations=(2,)),
        "unet": lambda: JaxUNetPredictor(cond_channels=8, num_labels=3, **unet),
        "unet_plain": lambda: JaxUNetPredictor(**unet),
        "unet_labels": lambda: JaxUNetPredictor(num_labels=3, **unet),
        "wavegrad": lambda: JaxWaveGradPredictor(base_channels=2, cond_mult=4, num_labels=3),
        "wavegrad_encoder": lambda: JaxWaveGradEncoder(base_channels=2, cond_mult=4),
    }[kind]()


@pytest.mark.parametrize("kind", ["unet_encoder", "unet", "wavegrad", "wavegrad_encoder"])
def test_model_matches_unsharded_jax(setup, got, kind):
    built = setup[1]
    variables = _jax_variables(built["models"][kind])
    args = {k: jnp.asarray(v) for k, v in built["inputs"][kind].items()}
    module = _jax_module(kind)
    want = jax.jit(lambda v, a: module.apply(v, **a))(variables, args)
    assert got["models"][kind].shape == want.shape
    _assert_scaled_close(got["models"][kind], want, SWAP_WAVEGRAD if kind == "wavegrad" else SWAP)


@pytest.mark.parametrize("kind", ["unet_encoder", "unet", "wavegrad", "wavegrad_encoder"])
def test_model_matches_the_unsharded_port(setup, got, kind):
    """The same ops on one device: only the convolutions' summation order
    at the shard edges (VALID on a padded shard) and the merged
    statistics differ."""
    built = setup[1]
    with torch.no_grad():
        want = built["models"][kind](**{k: torch.from_numpy(v)
                                       for k, v in built["inputs"][kind].items()})
    _assert_scaled_close(got["models"][kind], want.numpy(), 1e-5)


def _jax_pred(kind, model, **kw):
    module, variables = _jax_module(kind), _jax_variables(model)
    return jax.jit(lambda x, ts: module.apply(variables, x, ts, **kw))


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpmpp"])
def test_sampler_matches_unsharded_jax(setup, got, sampler):
    """3 steps with the x0 constraint from the same x_T; DDPM on the port's
    seeded per-step draws (the whole sequence's, as one device draws)."""
    spec, built = setup
    x_T = jnp.asarray(spec["samplers"]["x_T"])
    pred = _jax_pred("unet_plain", built["sampler"])
    diffusion = JaxDiffusion(jax_make_schedule("exp"))
    if sampler == "ddim":
        want = diffusion.ddim_sample(x_T, pred, steps=STEPS, constrain=True)
    elif sampler == "dpmpp":
        want = diffusion.dpmpp_sample(x_T, pred, steps=STEPS, constrain=True)
    else:
        gen = torch.Generator().manual_seed(SEED)
        x = x_T
        for i in range(STEPS):
            t, dt = _step_time(i, STEPS, None)
            ts = jnp.full((1,), t, jnp.float32)
            noise = (np.zeros(x_T.shape, np.float32) if i == STEPS - 1 else
                     torch.randn(x_T.shape, generator=gen).numpy())
            x = diffusion.ddpm_previous(x, ts, dt, pred(x, ts), jnp.asarray(noise),
                                        constrain=True)
        want = x
    _assert_scaled_close(got["samplers"][sampler], want, SAMPLE)


def test_convert_matches_unsharded_jax(setup, got):
    """Encode, VQ and a 3-step DPM++ decode of the shallow VQ-VAE, x_T the
    port's seeded draw."""
    spec, built = setup
    params = _jax_variables(built["vqvae"])["params"]
    enc_mod = JaxUNetEncoder(base_channels=4, out_channels=16, channel_mult=(1, 2),
                             depth_mult=1)
    pred_mod = JaxUNetPredictor(base_channels=4, middle_dilations=(4,), cond_channels=16,
                                num_labels=3, channel_mult=(1, 2), depth_mult=1)
    x = jnp.asarray(spec["convert"]["x"])
    enc = enc_mod.apply({"params": params["encoder"]}, x)
    cond = jax_vq_forward(params["vq"]["dictionary"], enc)["embedded"]
    labels = jnp.asarray(spec["convert"]["labels"])
    pred = jax.jit(lambda xs, ts: pred_mod.apply({"params": params["predictor"]}, xs, ts,
                                                 cond=cond, labels=labels))
    x_T = torch.randn((1, T, 1), generator=torch.Generator().manual_seed(SEED)).numpy()
    want = JaxDiffusion(jax_make_schedule("exp")).dpmpp_sample(
        jnp.asarray(x_T), pred, steps=STEPS, constrain=True)
    _assert_scaled_close(got["convert"], want, SAMPLE)


# ---------------------------------------------------------------- training


@pytest.fixture(scope="module")
def jax_train(setup):
    """JAX's unsharded loss, per-element losses and gradients at the
    port's draws (ts, then the noise, from the seeded generator)."""
    spec, built = setup
    tr = spec["train"]
    x = tr["x"]
    gen = torch.Generator().manual_seed(SEED)
    ts = torch.rand((2,), generator=gen).numpy()
    noise = torch.randn(x.shape, generator=gen).numpy()
    module = _jax_module("unet_labels")
    diffusion = JaxDiffusion(jax_make_schedule("exp"))
    labels = jnp.asarray(tr["labels"])

    def loss(p):
        xt = diffusion.sample_q(jnp.asarray(x), jnp.asarray(ts), jnp.asarray(noise))
        pred = module.apply({"params": p}, xt, jnp.asarray(ts), labels=labels)
        losses = jnp.mean(jnp.square(jnp.asarray(noise) - pred), axis=(1, 2))
        return jnp.mean(losses), losses

    params = _jax_variables(built["train"])["params"]
    (value, losses), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return float(value), np.asarray(losses), _torch_grads(grads)


def test_train_step_loss_matches_jax(got, jax_train):
    np.testing.assert_allclose(got["train"]["loss"], jax_train[0], rtol=1e-5)
    np.testing.assert_allclose(got["train"]["losses"], jax_train[1], rtol=1e-5)


def test_train_step_grads_match_jax(got, jax_train):
    want = jax_train[2]
    assert sorted(got["train"]["grads"]) == sorted(want)
    for name, g in got["train"]["grads"].items():
        np.testing.assert_allclose(g, want[name].numpy(), atol=5e-5, rtol=5e-4, err_msg=name)


def test_train_step_takes_one_adamw_step_on_every_rank(setup, ranks):
    """Every rank's parameters after the step are the one-process AdamW
    step's from the summed gradients, bit for bit."""
    model = seq_module("unet_labels")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in setup[0]["train"]["state"].items()})
    opt = build_optimizer(model, lr=1e-3)
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(ranks[0]["train"]["grads"][n])
    opt.step()
    for r, res in enumerate(ranks):
        for n, p in model.named_parameters():
            np.testing.assert_array_equal(res["train"]["params"][n], p.detach().numpy(),
                                          err_msg=f"rank {r} {n}")


# --------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def cli_world1(setup):
    built = setup[1]
    saved = ModelBase.__dict__["from_manifest"]
    ModelBase.from_manifest = classmethod(worker.tiny_from_manifest)
    try:
        out = long_audio_convert.main(built["cli"] + [
            "--input", str(built["root"] / "in1.wav"), "--output", str(built["root"] / "out1.wav"),
            "--device", "cpu"])
    finally:
        ModelBase.from_manifest = saved
    return out


def test_cli_world4_matches_world1(setup, ranks, cli_world1):
    assert cli_world1.shape == (KEPT,)
    for res in ranks:
        np.testing.assert_allclose(res["cli"], cli_world1, atol=SAMPLE * max(
            1.0, np.abs(cli_world1).max()), rtol=0)
    for name in ("out1.wav", "out4.wav"):
        with wave.open(str(setup[1]["root"] / name), "rb") as w:
            assert w.getnframes() == KEPT


def test_cli_world1_is_the_one_device_conversion(setup, cli_world1):
    """At one rank the CLI converts as VQVAE.encode + decode (DDPM, the x0
    constraint) with the same generator."""
    built = setup[1]
    with wave.open(os.path.join(built["root"], "in1.wav"), "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 2**15
    x = torch.from_numpy(pcm)[None, :, None]
    model = built["vqvae"]
    with torch.no_grad():
        want = model.decode(model.encode(x), labels=torch.tensor([1]), steps=2, constrain=True,
                            generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(cli_world1, want.reshape(-1).numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("flag", [["--tensor-parallel", "2"], ["--fsdp"], ["--fuse-levels", "2"]])
def test_cli_refuses_other_parallelism_and_fusion(setup, flag):
    with pytest.raises(ValueError, match="refused on the sequence-parallel path"):
        long_audio_convert.main(setup[1]["cli"] + ["--input", "in.wav", "--output", "x.wav",
                                                    "--device", "cpu", *flag])


def test_mfcc_encoder_and_fused_predictor_are_refused():
    model = VQVAE(pred_name="unet", base_channels=4, enc_name="conv-mfcc-ulaw",
                  dictionary_size=8, num_labels=3)
    mesh = create_seq_mesh()
    with pytest.raises(TypeError, match="UNet- and WaveGrad-family encoders"):
        seq_parallel_vqvae_convert(mesh, model, torch.zeros(1, 2560, 1))
    fused = worker.tiny_diffusion(fuse_levels=1).predictor
    with pytest.raises(ValueError, match="runs unfused"):
        seq_parallel_unet_predictor(mesh, fused, torch.zeros(1, 64, 1), torch.zeros(1))


def test_world_of_one_is_the_unsharded_group_norm():
    """At one rank the sharded GroupNorm is the one-device one, gradients
    included (no collective)."""
    from vq_voice_swap_torch.parallel.sequence import seq_sharded_group_norm

    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 8, 32).astype(np.float32))
    leaves = [torch.from_numpy(v.astype(np.float32)) for v in
              (1 + 0.1 * rng.randn(8), rng.randn(8), 0.3 * rng.randn(2, 8), rng.randn(2, 8))]
    outs = []
    for sharded in (True, False):
        xx = x.clone().requires_grad_()
        ll = [v.clone().requires_grad_() for v in leaves]
        args = (xx, ll[0], ll[1], GROUPS, 1e-5, True, (ll[2], ll[3]))
        y = seq_sharded_group_norm(create_seq_mesh(), *args) if sharded else group_norm(*args)
        (y * torch.linspace(-1, 1, 32)).sum().backward()
        outs.append([y.detach(), xx.grad] + [v.grad for v in ll])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_collectives_counted(got):
    c = got["collectives"]
    assert c["halo"] > 0 and c["group_norm"] > 0 and c["group_norm backward"] > 0
    assert c["halo backward"] > 0 and c["train step"] == 1 and c["row mean"] > 0

