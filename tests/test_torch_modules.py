"""The PyTorch port's layers, UNet and MFCC encoder against flax ``apply``
on the same randomized parameters (vq_voice_swap_torch/models).

Tolerance atol/rtol 2e-4: the two frameworks sum convolutions in different
orders, and the error grows through the residual stack.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import load_into, nct, ntc, randomize_params

from vq_voice_swap_tpu.models import layers as jl
from vq_voice_swap_tpu.models.mfcc_encoder import ConvMFCCEncoder as JaxMFCC
from vq_voice_swap_tpu.models.unet import UNetEncoder as JaxEncoder
from vq_voice_swap_tpu.models.unet import UNetPredictor as JaxPredictor
from vq_voice_swap_torch.convert import params_to_jax, torch_key
from vq_voice_swap_torch.models import layers as tl
from vq_voice_swap_torch.models.mfcc_encoder import ConvMFCCEncoder
from vq_voice_swap_torch.models.registry import make_encoder, make_predictor
from vq_voice_swap_torch.models.unet import UNetEncoder, UNetPredictor

TOL = dict(atol=2e-4, rtol=2e-4)


def _init(module, seed, *args, **kwargs):
    params = jax.jit(lambda r: module.init(r, *args, **kwargs))(
        jax.random.key(0)
    )["params"]
    return randomize_params(params, seed)


def test_params_from_jax_naming_rule():
    assert torch_key("params/predictor/down_blocks_3/norm_in/norm/scale") == (
        "predictor.down_blocks.3.norm_in.norm.weight"
    )
    assert torch_key("params/encoder/res_3_1/conv/kernel") == (
        "encoder.res_3.1.conv.weight"
    )
    assert torch_key("buffers/vq/usage_count") == "vq.usage_count"


def test_params_to_jax_inverts_params_from_jax():
    model = UNetPredictor(4, channel_mult=(1, 2), middle_dilations=(2,),
                          cond_channels=8, num_labels=3)
    flat = params_to_jax(model)
    assert flat["params/down_blocks_0/conv_in/conv/kernel"].shape == (3, 4, 4)
    assert flat["params/time_embed_extra/kernel"].shape == (16, 16)
    assert "params/class_embed/embedding" in flat
    assert "params/out_norm/norm/scale" in flat
    fresh = UNetPredictor(4, channel_mult=(1, 2), middle_dilations=(2,),
                          cond_channels=8, num_labels=3)
    load_into(fresh, {k[len("params/"):]: v for k, v in flat.items()})
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k


def test_time_embedding():
    ts = np.asarray([0.0, 0.3, 1.0], np.float32)
    module = jl.TimeEmbedding(16)
    params = _init(module, 1, jnp.asarray(ts))
    want = module.apply({"params": params}, jnp.asarray(ts))
    port = load_into(tl.TimeEmbedding(16), params)
    got = port(torch.from_numpy(ts), torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t,out_len", [(8, 8), (5, 17), (7, 2560), (200, 64000)])
def test_nearest_resize_1d(t, out_len):
    x = np.random.RandomState(t).randn(2, t, 3).astype(np.float32)
    want = np.asarray(jl.nearest_resize_1d(jnp.asarray(x), out_len))
    np.testing.assert_array_equal(ntc(tl.nearest_resize_1d(nct(x), out_len)), want)


def test_pool_and_upsample():
    x = np.random.RandomState(0).randn(2, 12, 3).astype(np.float32)
    np.testing.assert_allclose(
        ntc(tl.avg_pool_1d(nct(x), 2)),
        np.asarray(jl.avg_pool_1d(jnp.asarray(x), 2)), atol=1e-7,
    )
    np.testing.assert_array_equal(
        ntc(tl.nearest_upsample_1d(nct(x), 2)),
        np.asarray(jl.nearest_upsample_1d(jnp.asarray(x), 2)),
    )


@pytest.mark.parametrize(
    "in_ch,kwargs",
    [
        (8, dict(out_channels=16, use_emb=True)),
        (16, dict(use_emb=True, scale_factor=0.5)),
        (16, dict(use_emb=True, scale_factor=2.0)),
        (8, dict(dilation=4)),
    ],
)
def test_resblock(in_ch, kwargs):
    rng = np.random.RandomState(in_ch)
    x = rng.randn(2, 64, in_ch).astype(np.float32)
    emb = rng.randn(2, 32).astype(np.float32) if kwargs.get("use_emb") else None
    module = jl.ResBlock(**kwargs)
    args = (jnp.asarray(x),) + ((jnp.asarray(emb),) if emb is not None else (None,))
    params = _init(module, 2, *args)
    want = np.asarray(module.apply({"params": params}, *args))
    port = load_into(
        tl.ResBlock(
            in_ch, kwargs.get("out_channels"), 32 if emb is not None else None,
            kwargs.get("scale_factor", 1.0), kwargs.get("dilation", 2),
        ),
        params,
    )
    got = port(nct(x), None if emb is None else torch.from_numpy(emb))
    np.testing.assert_allclose(ntc(got), want, **TOL)


def _predictor_inputs():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 512, 1).astype(np.float32)
    ts = np.asarray([0.2, 0.9], np.float32)
    cond = rng.randn(2, 6, 16).astype(np.float32)
    labels = np.asarray([0, 2], np.int32)
    return x, ts, cond, labels


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_unet_predictor(dtype):
    """A reduced topology (3 levels); the full one runs in the VQ-VAE
    slice test. bf16 is held at bf16's own tolerance."""
    x, ts, cond, labels = _predictor_inputs()
    kw = dict(channel_mult=(1, 2, 4), middle_dilations=(2, 4), cond_channels=16,
              num_labels=3)
    module = JaxPredictor(4, dtype=jnp.dtype(dtype) if dtype else None, **kw)
    args = (jnp.asarray(x), jnp.asarray(ts), jnp.asarray(cond), jnp.asarray(labels))
    params = _init(JaxPredictor(4, **kw), 4, *args)
    want = np.asarray(jax.jit(module.apply)({"params": params}, *args))
    port = load_into(
        UNetPredictor(4, dtype=getattr(torch, dtype) if dtype else None, **kw),
        params,
    )
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (x, ts, cond)),
                   torch.from_numpy(labels).long())
    assert got.dtype == torch.float32
    tol = TOL if dtype is None else dict(atol=0.1 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_unet_encoder():
    x = np.random.RandomState(5).randn(2, 64, 1).astype(np.float32)
    kw = dict(channel_mult=(1, 2), out_dilations=(2,), out_channels=16)
    module = JaxEncoder(4, **kw)
    params = _init(module, 5, jnp.asarray(x))
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    port = load_into(UNetEncoder(4, **kw), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize(
    "kwargs", [dict(), dict(version=2), dict(input_ulaw=False)],
    ids=["conv-mfcc-ulaw", "conv-mfcc-ulaw-v2", "conv-mfcc-linear"],
)
def test_conv_mfcc_encoder(kwargs):
    x = (0.3 * np.random.RandomState(6).randn(2, 2560, 1)).astype(np.float32)
    module = JaxMFCC(2, out_channels=16, **kwargs)
    params = _init(module, 6, jnp.asarray(x))
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    port = load_into(ConvMFCCEncoder(2, out_channels=16, **kwargs), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 8, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_registry_names_and_wavegrad():
    assert isinstance(make_encoder("unet128-dilated", base_channels=2), UNetEncoder)
    assert make_encoder("conv-mfcc-linear", base_channels=2).input_ulaw is False
    with pytest.raises(NotImplementedError):
        make_encoder("wavegrad")
    with pytest.raises(NotImplementedError):
        make_predictor("wavegrad")
