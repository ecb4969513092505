"""The port's unconditional-sampling slice against the JAX package: named
time warps, the three samplers with warps, a JAX-saved DiffusionModel
sampled through the fused predictor (``fuse_levels=2``), and the
``python -m vq_voice_swap_torch.sample_diffusion`` CLI on the CPU.

The two packages draw different random numbers, so the tests hand the
port the JAX samplers' own x_T and noise. Tolerances: 1e-5 for the
samplers on a toy predictor (float32 sampler math), 1e-3 for three DDPM
steps through the UNet (convolution sums in another order, amplified by
the first step's 1/sqrt(alpha)).
"""

import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import randomize_params

from vq_voice_swap_tpu.diffusion import Diffusion as JaxDiffusion
from vq_voice_swap_tpu.diffusion import make_schedule as jax_schedule
from vq_voice_swap_tpu.diffusion import make_warp as jax_make_warp
from vq_voice_swap_tpu.diffusion_model import DiffusionModel as JaxModel
from vq_voice_swap_torch import sample_diffusion
from vq_voice_swap_torch.diffusion import Diffusion, make_schedule, make_warp
from vq_voice_swap_torch.diffusion_model import DiffusionModel

TOL = dict(atol=1e-5, rtol=1e-5)
# 8 positions at the deepest of the 9 levels: with fewer, GroupNorm there
# normalises a handful of values and amplifies rounding without bound.
SLICE_LEN = 2048


# -------------------------------------------------------------------- warps


@pytest.mark.parametrize("name", [None, "", "linear", "identity"])
def test_identity_warps(name):
    assert make_warp(name) is None and jax_make_warp(name) is None


@pytest.mark.parametrize("name", ["quadratic", "sqrt", "pow:1.5", "pow:2", "pow:0.25"])
def test_warps_match_jax(name):
    t = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    got = make_warp(name)(torch.from_numpy(t))
    assert got.dtype == torch.float32
    want = np.asarray(jax_make_warp(name)(jnp.asarray(t)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["cubic", "pow:", "pow:1.2.3", "pow:-1", "lambda t: t"])
def test_unknown_warp_raises_as_in_jax(name):
    with pytest.raises(ValueError) as got:
        make_warp(name)
    with pytest.raises(ValueError) as want:
        jax_make_warp(name)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- samplers


def _toy_jax(x, ts):
    return 0.8 * x * ts[:, None, None] + 0.1 * jnp.sin(3.0 * x)


def _toy_torch(x, ts):
    return 0.8 * x * ts[:, None, None] + 0.1 * torch.sin(3.0 * x)


def _jax_step_noise(key, steps, shape):
    """The noise the JAX ancestral sampler draws at each step from ``key``."""
    return [np.array(jax.random.normal(k, shape, jnp.float32))
            for k in jax.random.split(key, steps)]


def _inject(monkeypatch, noises):
    """Hand the port's samplers ``noises`` in order, in place of torch.randn."""
    queue = [torch.from_numpy(n) for n in noises]
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: queue.pop(0).to(kw["device"]))
    return queue


@pytest.mark.parametrize("warp", ["quadratic", "pow:1.5"])
@pytest.mark.parametrize("constrain", [False, True])
@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpmpp"])
def test_warped_samplers_match_jax(monkeypatch, sampler, constrain, warp):
    steps = 5
    jd, td = JaxDiffusion(jax_schedule("exp")), Diffusion(make_schedule("exp"))
    x_T = np.random.RandomState(3).randn(3, 64, 1).astype(np.float32)
    jw, tw = jax_make_warp(warp), make_warp(warp)
    if sampler == "ddpm":
        key = jax.random.key(4)
        want = jd.ddpm_sample(jnp.asarray(x_T), _toy_jax, steps, key,
                              constrain=constrain, warp=jw)
        left = _inject(monkeypatch, _jax_step_noise(key, steps, x_T.shape)[:-1])
        got = td.ddpm_sample(torch.from_numpy(x_T), _toy_torch, steps,
                             constrain=constrain, warp=tw)
        assert not left  # one draw per step but the last
    elif sampler == "ddim":
        want = jd.ddim_sample(jnp.asarray(x_T), _toy_jax, steps, constrain=constrain,
                              warp=jw)
        got = td.ddim_sample(torch.from_numpy(x_T), _toy_torch, steps,
                             constrain=constrain, warp=tw)
    else:
        want = jd.dpmpp_sample(jnp.asarray(x_T), _toy_jax, steps, constrain=constrain,
                               warp=jw)
        got = td.dpmpp_sample(torch.from_numpy(x_T), _toy_torch, steps,
                              constrain=constrain, warp=tw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_warp_changes_the_sample():
    td = Diffusion(make_schedule("exp"))
    x_T = torch.from_numpy(np.random.RandomState(5).randn(2, 32, 1).astype(np.float32))
    plain = td.dpmpp_sample(x_T, _toy_torch, 4)
    warped = td.dpmpp_sample(x_T, _toy_torch, 4, warp=make_warp("quadratic"))
    assert not torch.allclose(plain, warped)


# -------------------------------------------------------- the slice, and CLI


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """A tiny unconditional unet DiffusionModel (9 levels at 4 channels) with
    randomised weights, and the .npz that the JAX package saved."""
    model = JaxModel(pred_name="unet", base_channels=4)
    variables = model.init_variables(jax.random.key(0), seq_len=SLICE_LEN)
    variables = {"params": randomize_params(variables["params"], 21)}
    path = str(tmp_path_factory.mktemp("ckpt") / "model.npz")
    model.save(path, variables)
    return model, variables, path


def test_slice_ddpm_through_the_fused_predictor(jax_model, monkeypatch):
    """Three quadratic-warped DDPM steps with the x0 constraint (which
    bounds the first step's 1/sqrt(alpha) amplification, as in the swap
    slice's decode test): the JAX model (unfused) against the port loaded
    with fuse_levels=2, from the JAX x_T and noise."""
    model, variables, path = jax_model
    x_T = np.random.RandomState(8).randn(2, SLICE_LEN, 1).astype(np.float32)
    key = jax.random.key(9)
    want = jax.jit(lambda v, x, r: model.diffusion.ddpm_sample(
        x, lambda xs, ts: model.predict_eps(v, xs, ts), 3, r, constrain=True,
        warp=jax_make_warp("quadratic"),
    ))(variables, jnp.asarray(x_T), key)

    port = DiffusionModel.load(path, device="cpu", fuse_levels=2)
    assert port.predictor.routes.count("plain") < len(port.predictor.routes)
    _inject(monkeypatch, _jax_step_noise(key, 3, x_T.shape)[:-1])
    with torch.no_grad():
        got = port.diffusion.ddpm_sample(torch.from_numpy(x_T), port.predict_eps, 3,
                                         constrain=True, warp=make_warp("quadratic"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_fuse_levels_is_never_saved(jax_model, tmp_path):
    port = DiffusionModel.load(jax_model[2], device="cpu", fuse_levels=2)
    assert port.predictor.fuse_levels == 2
    path = str(tmp_path / "resaved.npz")
    port.save(path)
    with np.load(path) as data:
        kwargs = json.loads(str(data["__meta__"]))["kwargs"]
    assert kwargs == jax_model[0].save_kwargs() and "fuse_levels" not in kwargs


def _frames(path):
    with wave.open(path, "rb") as w:
        assert w.getframerate() == 16000
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def test_cli_writes_and_resumes(jax_model, tmp_path):
    out = str(tmp_path / "samples")
    argv = ["--device", "cpu", "--checkpoint-path", jax_model[2], "--fuse-levels", "2",
            "--num-samples", "3", "--batch-size", "2", "--sample-steps", "2",
            "--schedule", "quadratic", "--sample-path", out]
    sample_diffusion.main(argv)
    names = sorted(os.listdir(out))
    assert names == [f"sample_{i:06}.wav" for i in range(3)]
    first = {n: _frames(os.path.join(out, n)) for n in names}
    for frames in first.values():
        assert frames.shape == (sample_diffusion.SAMPLE_LEN,) and frames.any()
    assert not np.array_equal(first[names[0]], first[names[1]])

    stamps = {n: os.stat(os.path.join(out, n)).st_mtime_ns for n in names[:2]}
    os.remove(os.path.join(out, names[2]))
    sample_diffusion.main(argv)  # batch 0 is complete and skipped; batch 1 redone
    assert sorted(os.listdir(out)) == names
    assert {n: os.stat(os.path.join(out, n)).st_mtime_ns for n in names[:2]} == stamps
    np.testing.assert_array_equal(_frames(os.path.join(out, names[2])), first[names[2]])


def test_cli_single_sample_and_checks(jax_model, tmp_path, monkeypatch):
    path = str(tmp_path / "one.wav")
    sample_diffusion.main(["--device", "cpu", "--checkpoint-path", jax_model[2],
                           "--sample-steps", "1", "--sampler", "dpmpp", "--sample-path", path])
    assert _frames(path).shape == (sample_diffusion.SAMPLE_LEN,)
    with pytest.raises(SystemExit, match="class-conditional"):
        sample_diffusion.main(["--device", "cpu", "--checkpoint-path", jax_model[2],
                               "--target-class", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_diffusion.main(["--checkpoint-path", jax_model[2]])
