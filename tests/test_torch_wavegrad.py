"""The port's WaveGrad family (``models/wavegrad.py``) against the JAX
package's flax modules on the CPU: the checkpoint keys against flax's
``eval_shape`` init, the predictor (conditional and labelled,
unconditional, unconditional and labelled) and the encoder forward, a
WaveGrad VQ-VAE's encode and 3-step DPM++ decode, a class-conditional
WaveGrad diffusion loss with every gradient, the flax-mirroring init, the
checkpoint in both directions, and the registry's refusals.

Weights are seeded in the port and exported with ``params_to_jax``, so no
flax init is jitted outside the init test. Tolerances: one forward within
1e-5 (float32 convolution sums in another order; flax's LayerNorm takes a
one-pass variance, the port Welford's); the decode within 1e-3 after
3 steps; the loss within 1e-5 relative and each gradient leaf within 2e-4
of its largest entry (``test_torch_train.py``'s rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vq_voice_swap_tpu.diffusion_model import DiffusionModel as JaxDiffusionModel
from vq_voice_swap_tpu.model_base import ModelBase as JaxModelBase
from vq_voice_swap_tpu.models.wavegrad import WaveGradEncoder as JaxWaveGradEncoder
from vq_voice_swap_tpu.models.wavegrad import WaveGradPredictor as JaxWaveGradPredictor
from vq_voice_swap_tpu.vq_vae import VQVAE as JaxVQVAE
from vq_voice_swap_torch.convert import params_from_jax, params_to_jax
from vq_voice_swap_torch.diffusion_model import DiffusionModel
from vq_voice_swap_torch.model_base import ModelBase
from vq_voice_swap_torch.models import make_predictor
from vq_voice_swap_torch.models.init import init_like_flax
from vq_voice_swap_torch.models.wavegrad import WaveGradEncoder, WaveGradPredictor
from vq_voice_swap_torch.vq_vae import VQVAE

BASE, COND_MULT, LABELS, CODES = 4, 4, 3, 16
T = 1024
GRAD_TOL = 2e-4


def seed_wavegrad(model: torch.nn.Module, seed: int) -> None:
    """Every layer live: weights ~ N(0, 1/fan_in), LayerNorm scales near 1,
    small biases and shifts."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if name.endswith("dictionary"):
                p.copy_(noise)
            elif p.ndim >= 2:
                p.copy_(noise / np.sqrt(p[0].numel()))
            elif "norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)


def _params(model: torch.nn.Module):
    """The port's weights as a flax params tree."""
    flat = {k: v for k, v in params_to_jax(model).items() if k.startswith("params/")}
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")[1:]): jnp.asarray(v) for k, v in flat.items()})


def _variables(model: torch.nn.Module):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in params_to_jax(model).items()})


def _flax_shapes(module, *args):
    tree = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))
    return {"/".join(k): tuple(v.shape) for k, v in traverse_util.flatten_dict(tree).items()}


def _inputs(n: int, t: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    x = (0.5 * np.tanh(rng.randn(n, t, 1))).astype(np.float32)
    cond = rng.randn(n, t // 64, BASE * COND_MULT).astype(np.float32)
    ts = rng.uniform(0.05, 0.95, n).astype(np.float32)
    return x, cond, ts


# --------------------------------------------------------------- modules


@pytest.mark.parametrize("which", ["predictor", "unconditional predictor", "encoder"])
def test_checkpoint_keys_match_flax(which):
    """The port's params_to_jax keys and shapes are flax's init's, and map
    back onto the module by params_from_jax."""
    x, cond, ts = (jnp.zeros(a.shape, a.dtype) for a in _inputs(1, 128))
    if which == "encoder":
        model = WaveGradEncoder(BASE, COND_MULT)
        want = _flax_shapes(JaxWaveGradEncoder(BASE, COND_MULT), x)
    elif which == "predictor":
        model = WaveGradPredictor(BASE, COND_MULT, num_labels=LABELS)
        want = _flax_shapes(JaxWaveGradPredictor(BASE, COND_MULT, num_labels=LABELS),
                            x, ts, cond, jnp.zeros((1,), jnp.int32))
    else:
        model = WaveGradPredictor(BASE, COND_MULT)
        want = _flax_shapes(JaxWaveGradPredictor(BASE, COND_MULT), x, ts)
    flat = params_to_jax(model)
    assert {k: v.shape for k, v in flat.items()} == want
    assert any("/norm_3/scale" in k for k in want) == (which != "encoder")
    assert any("/extra_conv_0_a/conv/kernel" in k for k in want) == (which == "encoder")
    state = params_from_jax(flat)
    assert sorted(state) == sorted(model.state_dict())
    model.load_state_dict(state)


@pytest.mark.parametrize("cond,labels", [(True, True), (False, False), (False, True)])
def test_predictor_matches_flax(cond, labels):
    num_labels = LABELS if labels else None
    model = WaveGradPredictor(BASE, COND_MULT, num_labels=num_labels)
    seed_wavegrad(model, 1)
    jax_model = JaxWaveGradPredictor(BASE, COND_MULT, num_labels=num_labels)
    x, c, ts = _inputs(2, T, seed=2)
    lab = np.array([0, 2], np.int32) if labels else None
    c = c if cond else None
    want = jax.jit(lambda p: jax_model.apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(ts),
        None if c is None else jnp.asarray(c), None if lab is None else jnp.asarray(lab)))(
        _params(model))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ts),
                    None if c is None else torch.from_numpy(c),
                    None if lab is None else torch.from_numpy(lab).long())
    assert got.shape == (2, T, 1) and got.dtype == torch.float32
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_encoder_matches_flax():
    model = WaveGradEncoder(BASE, COND_MULT)
    seed_wavegrad(model, 3)
    x, _, _ = _inputs(2, T, seed=4)
    want = jax.jit(lambda p: JaxWaveGradEncoder(BASE, COND_MULT).apply(
        {"params": p}, jnp.asarray(x)))(_params(model))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, T // 64, BASE * COND_MULT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_bf16_predictor_keeps_float32_norm_statistics():
    """In bf16 the LayerNorm statistics and output are float32 arithmetic
    cast once: the bf16 forward stays near the float32 one."""
    model = WaveGradPredictor(BASE, COND_MULT, num_labels=LABELS)
    seed_wavegrad(model, 5)
    x, c, ts = (torch.from_numpy(a) for a in _inputs(2, 512, seed=6))
    lab = torch.tensor([1, 2])
    with torch.no_grad():
        want = model(x, ts, c, lab)
        model.dtype = torch.bfloat16
        got = model(x, ts, c, lab)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 0.05 * want.abs().max().item()


@pytest.mark.parametrize("kwargs,message", [
    (dict(fuse_levels=2), "fuse_levels"),
    (dict(dropout=0.1), "dropout"),
    (dict(cond_channels=6), "multiple of base_channels"),
])
def test_make_predictor_refuses_what_wavegrad_lacks(kwargs, message):
    with pytest.raises(ValueError, match=message):
        make_predictor("wavegrad", base_channels=BASE, **kwargs)


# ---------------------------------------------------------------- models


def _wavegrad_vqvae(seed: int):
    kwargs = dict(pred_name="wavegrad", base_channels=BASE, enc_name="wavegrad",
                  cond_mult=COND_MULT, dictionary_size=CODES, num_labels=LABELS)
    model = VQVAE(**kwargs)
    seed_wavegrad(model, seed)
    x, _, _ = _inputs(2, T, seed=7)
    with torch.no_grad():
        enc = model.encode_raw(torch.from_numpy(x))
        model.vq.dictionary.copy_(enc.mean(dim=(0, 1)) + model.vq.dictionary * enc.std())
    return model, JaxVQVAE(**kwargs), x


def test_vqvae_encode_and_dpmpp_decode_match_jax():
    """Encode to the same codes; 3-step DPM++ from the JAX x_T within 1e-3."""
    model, jax_model, x = _wavegrad_vqvae(8)
    assert model.downsample_rate == 64
    variables = _variables(model)
    labels = jnp.asarray([0, 2], jnp.int32)
    key = jax.random.key(3)
    codes, want = jax.jit(lambda v, a, lab, r: (
        jax_model.encode(v, a),
        jax_model.decode(v, jax_model.encode(v, a), r, labels=lab, steps=3,
                         sampler="dpmpp", constrain=True)))(variables, jnp.asarray(x), labels, key)
    _, noise_key = jax.random.split(key)  # decode's own x_T draw
    x_T = jax.random.normal(noise_key, (2, T, 1), jnp.float32)
    with torch.no_grad():
        got_codes = model.encode(torch.from_numpy(x))
        got = model.decode(got_codes, labels=torch.tensor([0, 2]), steps=3, constrain=True,
                           sampler="dpmpp", x_T=torch.from_numpy(np.array(x_T)))
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(codes))
    assert len(np.unique(np.asarray(codes))) > 1
    assert got.shape == (2, T, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_diffusion_losses_and_gradients_match_jax():
    """A class-conditional WaveGrad DiffusionModel's training losses and
    every parameter's gradient, on the JAX draws."""
    kwargs = dict(pred_name="wavegrad", base_channels=BASE, num_labels=LABELS)
    model, jax_model = DiffusionModel(**kwargs), JaxDiffusionModel(**kwargs)
    seed_wavegrad(model, 9)
    x, _, _ = _inputs(3, 512, seed=10)
    labels = np.array([0, 2, 1], np.int32)
    key = jax.random.key(11)

    def loss(p):
        losses, ts = jax_model.losses({"params": p}, key, jnp.asarray(x),
                                      labels=jnp.asarray(labels), train=True)
        return jnp.mean(losses), (losses, ts)

    (_, (want_losses, want_ts)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        _params(model))
    loss_rng, _ = jax.random.split(key)
    t_key, loss_rng = jax.random.split(loss_rng)
    _, n_key = jax.random.split(loss_rng)
    ts = torch.from_numpy(np.array(jax.random.uniform(t_key, (3,))))
    noise = torch.from_numpy(np.array(jax.random.normal(n_key, x.shape)))
    losses, got_ts = model.losses(torch.from_numpy(x), labels=torch.from_numpy(labels).long(),
                                  ts=ts, noise=noise, train=True)
    losses.mean().backward()
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(want_ts))
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(want_losses), rtol=1e-5)
    want = params_from_jax({f"params/{k}": np.asarray(v) for k, v in
                            traverse_util.flatten_dict(grads, sep="/").items()})
    assert sorted(want) == sorted(n for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        err = (p.grad - want[name]).abs().max().item()
        assert err <= GRAD_TOL * want[name].abs().max().item() + 1e-7, (name, err)
    assert model.predictor.u_block[0].film["1"].label_emb.weight.grad.abs().max() > 0


def test_init_mirrors_flax():
    """A fresh WaveGrad VQ-VAE against flax's init of the same structure:
    the same leaves, zero exactly where flax's are (the label embeddings,
    the predictor's out_conv, the biases), LayerNorm scales one, each FiLM
    out_conv at 0.1 of lecun-normal, and each leaf of 1000 or more entries
    with a standard deviation within 10% of flax's."""
    kwargs = dict(pred_name="wavegrad", base_channels=16, enc_name="wavegrad", cond_mult=4,
                  dictionary_size=CODES, num_labels=LABELS)
    model = VQVAE(**kwargs)
    init_like_flax(model, torch.Generator().manual_seed(0))
    variables = JaxVQVAE(**kwargs).init_variables(jax.random.key(0))
    want = params_from_jax({"/".join(k): np.asarray(v)
                            for k, v in traverse_util.flatten_dict(variables).items()})
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    checked = 0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if not w.is_floating_point():
            continue
        if not w.any():
            assert not g.any(), name
            continue
        if name.endswith("norm.weight") or "norm." in name:
            assert torch.equal(g, w), name
        if w.numel() >= 1000:
            ratio = g.std().item() / w.std().item()
            assert abs(ratio - 1.0) < 0.1, (name, ratio)
            checked += 1
    assert checked >= 20
    film = model.predictor.u_block[0].film["1"]
    assert not film.label_emb.weight.any()
    assert not model.predictor.out_conv.conv.weight.any()
    std = film.out_conv.conv.weight.std().item() * np.sqrt(film.out_conv.conv.weight[0].numel())
    assert 0.08 < std < 0.12


def test_checkpoints_load_in_either_package(tmp_path):
    """A WaveGrad VQ-VAE saved by the port loads in the JAX package, and
    one saved by the JAX package loads in the port, leaf for leaf."""
    model, jax_model, _ = _wavegrad_vqvae(12)
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    model.save(port_path)
    loaded, variables = JaxModelBase.load(port_path)
    assert type(loaded).__name__ == "VQVAE" and loaded.predictor.num_labels == LABELS
    flat = traverse_util.flatten_dict(variables, sep="/")
    want = params_to_jax(model)
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(flat[k]), v, err_msg=k)
    loaded.save(jax_path, variables)
    back = ModelBase.load(jax_path, device="cpu")
    assert type(back) is VQVAE and back.pred_name == "wavegrad" and back.enc_name == "wavegrad"
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
