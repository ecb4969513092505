"""The PyTorch port's diffusion process (vq_voice_swap_torch/diffusion)
against the JAX package's. Noise is made with numpy and handed to both;
the deterministic samplers run end to end with a toy predictor. Float32
throughout; tolerance 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_voice_swap_tpu.diffusion import Diffusion as JaxDiffusion
from vq_voice_swap_tpu.diffusion import make_schedule as jax_schedule
from vq_voice_swap_torch.diffusion import Diffusion, make_schedule

TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(name):
    return JaxDiffusion(jax_schedule(name)), Diffusion(make_schedule(name))


def _toy_jax(x, ts):
    return 0.8 * x * ts[:, None, None] + 0.1 * jnp.sin(3.0 * x)


def _toy_torch(x, ts):
    return 0.8 * x * ts[:, None, None] + 0.1 * torch.sin(3.0 * x)


def _data(seed=0, shape=(3, 64, 1)):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("name", ["exp", "cos"])
def test_forward_and_conversions(name):
    jd, td = _pair(name)
    x0, eps, _ = _data()
    ts = np.asarray([0.05, 0.5, 0.95], np.float32)
    xt = np.array(jd.sample_q(jnp.asarray(x0), jnp.asarray(ts), jnp.asarray(eps)))
    got = td.sample_q(*(torch.from_numpy(a) for a in (x0, ts, eps))).numpy()
    np.testing.assert_allclose(got, xt, **TOL)
    j_x0 = np.asarray(jd.eps_to_x0(jnp.asarray(xt), jnp.asarray(ts), jnp.asarray(eps)))
    t_x0 = td.eps_to_x0(*(torch.from_numpy(a) for a in (xt, ts, eps))).numpy()
    np.testing.assert_allclose(t_x0, j_x0, atol=1e-4, rtol=1e-4)
    j_eps = np.asarray(jd.x0_to_eps(jnp.asarray(xt), jnp.asarray(ts), jnp.asarray(x0)))
    t_eps = td.x0_to_eps(*(torch.from_numpy(a) for a in (xt, ts, x0))).numpy()
    np.testing.assert_allclose(t_eps, j_eps, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("constrain", [False, True])
@pytest.mark.parametrize("sigma_large", [False, True])
def test_ddpm_previous_with_injected_noise(constrain, sigma_large):
    jd, td = _pair("exp")
    xt, eps, noise = _data(1)
    ts = np.full(3, 0.6, np.float32)
    want = jd.ddpm_previous(
        jnp.asarray(xt), jnp.asarray(ts), jnp.asarray(0.1, jnp.float32),
        jnp.asarray(eps), jnp.asarray(noise), sigma_large=sigma_large,
        constrain=constrain,
    )
    got = td.ddpm_previous(
        torch.from_numpy(xt), torch.from_numpy(ts), 0.1, torch.from_numpy(eps),
        torch.from_numpy(noise), sigma_large=sigma_large, constrain=constrain,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("eta", [0.0, 0.7])
@pytest.mark.parametrize("constrain", [False, True])
def test_ddim_previous(eta, constrain):
    jd, td = _pair("exp")
    xt, eps, noise = _data(2)
    ts = np.full(3, 0.4, np.float32)
    want = jd.ddim_previous(
        jnp.asarray(xt), jnp.asarray(ts), jnp.asarray(0.2, jnp.float32),
        jnp.asarray(eps), jnp.asarray(noise), eta=eta, constrain=constrain,
    )
    got = td.ddim_previous(
        torch.from_numpy(xt), torch.from_numpy(ts), 0.2, torch.from_numpy(eps),
        torch.from_numpy(noise), eta=eta, constrain=constrain,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
@pytest.mark.parametrize("constrain", [False, True])
@pytest.mark.parametrize("steps", [2, 3, 7])
def test_deterministic_samplers_end_to_end(sampler, constrain, steps):
    """(A single step jumps from alpha = 1e-5 straight to x0, scaling
    float32 rounding by rsqrt(1e-5) = 316, so it is not pinned at 1e-5.)"""
    jd, td = _pair("exp")
    x_T = _data(3)[0]
    if sampler == "ddim":
        want = jd.ddim_sample(jnp.asarray(x_T), _toy_jax, steps, constrain=constrain)
        got = td.ddim_sample(torch.from_numpy(x_T), _toy_torch, steps,
                             constrain=constrain)
    else:
        want = jd.dpmpp_sample(jnp.asarray(x_T), _toy_jax, steps, constrain=constrain)
        got = td.dpmpp_sample(torch.from_numpy(x_T), _toy_torch, steps,
                              constrain=constrain)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ddpm_sample_final_step_is_noise_free():
    """With one step the ancestral sampler draws no noise: the result is
    the same for any generator, and equals the JAX sampler's."""
    import jax

    jd, td = _pair("exp")
    x_T = _data(4)[0]
    want = jd.ddpm_sample(jnp.asarray(x_T), _toy_jax, 1, jax.random.key(0))
    for seed in (0, 1):
        got = td.ddpm_sample(torch.from_numpy(x_T), _toy_torch, 1,
                             generator=torch.Generator().manual_seed(seed))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ddpm_sample_uses_generator():
    _, td = _pair("exp")
    x_T = torch.from_numpy(_data(5)[0])
    a, b, c = (
        td.ddpm_sample(x_T, _toy_torch, 4, generator=torch.Generator().manual_seed(s))
        for s in (0, 0, 1)
    )
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_ddpm_losses_with_given_noise():
    jd, td = _pair("cos")
    x, noise, _ = _data(6)
    ts = np.asarray([0.1, 0.5, 0.9], np.float32)
    want = jd.ddpm_losses(jnp.asarray(x), _toy_jax, ts=jnp.asarray(ts),
                          noise=jnp.asarray(noise))
    got = td.ddpm_losses(torch.from_numpy(x), _toy_torch, ts=torch.from_numpy(ts),
                         noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_diffusion_model_losses(tmp_path):
    """DiffusionModel.losses through a JAX-saved checkpoint, with the noise
    the JAX model draws from its key handed to the port."""
    import jax
    from torch_port_util import randomize_params

    from vq_voice_swap_tpu.diffusion_model import DiffusionModel as JaxModel
    from vq_voice_swap_torch.diffusion_model import DiffusionModel

    model = JaxModel(pred_name="unet", base_channels=2, num_labels=2)
    variables = model.init_variables(jax.random.key(0), seq_len=256)
    variables = {"params": randomize_params(variables["params"], 9)}
    path = str(tmp_path / "model.npz")
    model.save(path, variables)

    x = np.random.RandomState(7).randn(2, 256, 1).astype(np.float32)
    ts = np.asarray([0.3, 0.7], np.float32)
    labels = np.asarray([0, 1], np.int32)
    key = jax.random.key(1)
    want, _ = jax.jit(lambda v, r: model.losses(
        v, r, jnp.asarray(x), labels=jnp.asarray(labels), ts=jnp.asarray(ts)
    ))(variables, key)
    loss_key, _ = jax.random.split(key)
    _, noise_key = jax.random.split(loss_key)  # ddpm_losses' own draw
    noise = np.array(jax.random.normal(noise_key, x.shape, jnp.float32))

    port = DiffusionModel.load(path, device="cpu")
    with torch.no_grad():
        got, got_ts = port.losses(
            torch.from_numpy(x), labels=torch.from_numpy(labels).long(),
            ts=torch.from_numpy(ts), noise=torch.from_numpy(noise),
        )
    np.testing.assert_array_equal(got_ts.numpy(), ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
