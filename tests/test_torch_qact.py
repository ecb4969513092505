"""The port's int8-activation serving path (vq_voice_swap_torch/ops/qact.py
and ``act_int8_min_t`` in the UNet family) against the JAX package's
``ops/qact.py`` and its int8 models, on the same numpy-seeded inputs and
weights.

Tolerances: ``quantize``'s codes and scale, and the quantized weights,
bit-equal; concat, pooling and upsampling exact; ``conv1d_int8`` within
1e-6 of the output's largest magnitude (an exact int32 sum, then the same
float32 epilogue); ``qact_group_norm`` 1e-5 (the port's statistics are
two-pass, JAX's E[x^2] - mean^2); a ResBlock's output codes: at most 0.1%
differ, none by more than one step (a code at a .5 boundary flips on a
one-ulp difference upstream).

The UNets are held to the JAX int8 forward by the quantization's own
error: a code that flips in one block moves the next GroupNorm's
statistics by a fraction of a step, which flips more codes downstream, so
once any code flips the outputs differ by a share of a step, not by a
float rounding: the conditional predictor's do (its stem's codes flip on
the float convolutions' rounding), the others' match to ~1e-6. So in
float32 the port's output must lie closer (L2) to JAX's int8 output than
the float forward does, and correlate above 0.999 with it; in bfloat16
above 0.98, the bar the JAX package holds its own int8 forward to against
its bfloat16 one.
"""

import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch_port_util import load_into, nct, ntc, randomize_params

from vq_voice_swap_tpu.diffusion_model import DiffusionModel as JaxDiffusionModel
from vq_voice_swap_tpu.models import layers as jl
from vq_voice_swap_tpu.models.unet import UNetEncoder as JaxEncoder
from vq_voice_swap_tpu.models.unet import UNetPredictor as JaxPredictor
from vq_voice_swap_tpu.ops import qact as jq
from vq_voice_swap_torch import sample_diffusion, sample_vqvae, sample_vqvae_uncond
from vq_voice_swap_torch.convert import params_to_jax
from vq_voice_swap_torch.data import ChunkWriter, read_audio_input
from vq_voice_swap_torch.diffusion import make_warp
from vq_voice_swap_torch.diffusion_model import DiffusionModel
from vq_voice_swap_torch.models import layers as tl
from vq_voice_swap_torch.models.registry import make_encoder, make_predictor
from vq_voice_swap_torch.models.unet import UNetEncoder, UNetPredictor, _concat
from vq_voice_swap_torch.ops import group_norm as gn
from vq_voice_swap_torch.ops import qact
from vq_voice_swap_torch.parallel.sequence import create_seq_mesh, sequence_parallel
from vq_voice_swap_torch.vq_vae import VQVAE


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run has several workers a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_codes(qa) -> np.ndarray:
    """A JAX QAct's codes as [N, C, T]."""
    return np.transpose(np.asarray(qa.q), (0, 2, 1))


def _port_qact(qa) -> qact.QAct:
    """A JAX QAct as the port's."""
    return qact.QAct(torch.from_numpy(np.ascontiguousarray(_jax_codes(qa))),
                     torch.from_numpy(np.array(qa.scale)))


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.RandomState(7)
    if kind == "zero":
        return np.zeros((2, 16, 9), np.float32)
    if kind == "ties":  # amax 127: scale 1, so every value sits on a .5 boundary
        x = np.arange(-12.5, 12.5, 1.0, dtype=np.float32).reshape(1, 25, 1)
        return np.concatenate([x, np.full((1, 1, 1), 127.0, np.float32)], axis=1)
    return (3.0 * rng.randn(2, 37, 16)).astype(np.float32)


# ------------------------------------------------------------- primitives


@pytest.mark.parametrize("kind,dtype", [("randn", "float32"), ("randn", "bfloat16"),
                                        ("zero", "float32"), ("ties", "float32")])
def test_quantize_codes_and_scale_bit_equal(kind, dtype):
    x = _inputs(kind)
    want = jq.quantize(jnp.asarray(x, jnp.dtype(dtype)))
    got = qact.quantize(nct(x).to(getattr(torch, dtype)))
    assert got.q.dtype == torch.int8 and got.scale.shape == ()
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.q.numpy(), _jax_codes(want))
    assert got.scale.numpy().tobytes() == np.asarray(want.scale, np.float32).tobytes()


def test_concat_pool_and_upsample_exact():
    rng = np.random.RandomState(1)
    a = jq.quantize(jnp.asarray(rng.randn(2, 32, 4).astype(np.float32)))
    b = jq.quantize(jnp.asarray(50 * rng.randn(2, 32, 6).astype(np.float32)))
    pa, pb = _port_qact(a), _port_qact(b)
    cat = qact.qact_concat(pa, pb)
    want = jq.qact_concat(a, b)
    np.testing.assert_array_equal(cat.q.numpy(), _jax_codes(want))
    np.testing.assert_array_equal(cat.scale.numpy(), np.asarray(want.scale))
    for got, want in ((qact.qact_avg_pool(cat, 2), jq.qact_avg_pool(want, 2)),
                      (qact.qact_upsample(pa, 2), jq.qact_upsample(a, 2))):
        np.testing.assert_array_equal(got.q.numpy(), _jax_codes(want))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(ntc(qact.dequantize(cat)), np.asarray(jq.dequantize(
        jq.qact_concat(a, b))))


def _jax_kq(kernel, scale=None):
    """The codes JAX's conv1d_int8 makes of its kernel (ops/qact.py:174-182)."""
    kf = kernel.astype(jnp.float32)
    if scale is not None:
        kf = kf * scale[None, :, None]
    w_amax = jnp.maximum(jnp.max(jnp.abs(kf), axis=(0, 1)), 1e-12)
    return np.asarray(jnp.clip(jnp.round(kf / (w_amax / 127.0)), -127, 127).astype(jnp.int8))


CONV_CASES = [(3, 1), (3, 2), (3, 32), (1, 1)]


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
@pytest.mark.parametrize("taps,dilation", CONV_CASES)
def test_conv1d_int8(taps, dilation, per_channel, bias):
    rng = np.random.RandomState(taps * 100 + dilation)
    cin, cout, t = 10, 12, 100
    x = rng.randn(2, t, cin).astype(np.float32)
    if per_channel:
        x[..., cin // 2:] *= 40.0
        qa = jq.qact_concat(jq.quantize(jnp.asarray(x[..., :cin // 2])),
                            jq.quantize(jnp.asarray(x[..., cin // 2:])))
    else:
        qa = jq.quantize(jnp.asarray(x))
    kernel = (0.3 * rng.randn(taps, cin, cout)).astype(np.float32)
    b = (0.1 * rng.randn(cout)).astype(np.float32) if bias else None
    want = np.asarray(jq.conv1d_int8(qa, jnp.asarray(kernel), None if b is None else
                                     jnp.asarray(b), dilation=dilation))

    pa = _port_qact(qa)
    weight = torch.from_numpy(np.ascontiguousarray(np.transpose(kernel, (2, 1, 0))))
    kq, _ = qact.quantize_weight(weight, pa.scale if per_channel else None)
    want_kq = _jax_kq(jnp.asarray(kernel), jnp.asarray(qa.scale) if per_channel else None)
    np.testing.assert_array_equal(kq.permute(2, 1, 0).numpy(), want_kq)
    got = qact.conv1d_int8(pa, weight, None if b is None else torch.from_numpy(b),
                           dilation=dilation)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(ntc(got), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_conv1d_int8_keeps_its_weight_until_the_weight_changes():
    conv = torch.nn.Conv1d(8, 4, 3, padding=1)
    qa = qact.quantize(torch.randn(1, 8, 20, generator=torch.Generator().manual_seed(0)))
    first = qact.int8_weight(conv, conv.weight)
    assert qact.int8_weight(conv, conv.weight) is first
    with torch.no_grad():
        conv.weight.mul_(2.0)  # an in-place write, as load_state_dict does
    second = qact.int8_weight(conv, conv.weight)
    assert second is not first and torch.equal(second[0], first[0])
    assert torch.equal(second[1], 2 * first[1])
    want = qact.conv1d_int8(qa, conv.weight, conv.bias, dilation=1)
    torch.testing.assert_close(tl.conv1d(qa, conv), want, rtol=0, atol=0)


@pytest.mark.parametrize("use_gelu", [True, False])
def test_qact_group_norm(use_gelu):
    rng = np.random.RandomState(6)
    qa = jq.quantize(jnp.asarray((2.0 * rng.randn(2, 64, 8) + 0.5).astype(np.float32)))
    scale = np.linspace(0.5, 1.5, 8, dtype=np.float32)
    bias = np.linspace(-0.2, 0.2, 8, dtype=np.float32)
    want = np.asarray(jq.qact_group_norm(qa, jnp.asarray(scale), jnp.asarray(bias), 4, 1e-5,
                                         use_gelu))
    got = qact.qact_group_norm(_port_qact(qa), torch.from_numpy(scale), torch.from_numpy(bias),
                               4, 1e-5, use_gelu)
    np.testing.assert_allclose(ntc(got), want, rtol=0, atol=1e-5)


def _int8_stats_case(kind: str):
    """(codes, scale, groups) of one int8 statistics case, seeded."""
    rng = np.random.RandomState(12)
    x = torch.from_numpy((2.0 * rng.randn(2, 16, 48) + 0.5).astype(np.float32))
    if kind == "per_channel":  # a channel concat of two scales ~9x apart
        qa = qact.qact_concat(qact.quantize(x[:, :8].contiguous()),
                              qact.quantize(9.0 * x[:, 8:].contiguous()))
        return qa.q, qa.scale, 4
    if kind == "mean_100x_spread":
        qa = qact.quantize(x[:, :, :40] / 2.0 + 100.0)
        return qa.q, qa.scale, 4
    qa = qact.quantize(x)
    q = qa.q.clone()
    if kind == "at_127":  # group 1 of sample 0 all +-127
        signs = np.where(rng.rand(4, 48) < 0.6, 127, -127).astype(np.int8)
        q[0, 4:8] = torch.from_numpy(signs)
    return q, qa.scale, 4


@pytest.mark.parametrize("kind", ["per_tensor", "per_channel", "at_127", "mean_100x_spread"])
def test_group_norm_coeffs_int8_plain_within_one_ulp_of_float64(kind):
    """The int8 statistics' plain version (exact integer sums, JAX's
    one-pass formula in float64) against float64 two-pass statistics of the
    dequantized codes: mean and var within one float32 ulp; the
    coefficients are ``fold_affine`` of them."""
    q, scale, groups = _int8_stats_case(kind)
    n, c, _ = q.shape
    x = q.double() * (scale.double() if scale.ndim == 0 else scale.double()[:, None])
    xg = x.reshape(n, groups, -1)
    mean64 = xg.mean(dim=-1)
    var64 = torch.square(xg - mean64[..., None]).mean(dim=-1)
    w = torch.from_numpy(np.linspace(0.5, 1.5, c, dtype=np.float32))
    b = torch.from_numpy(np.linspace(-0.2, 0.2, c, dtype=np.float32))
    *coeffs, mean, var = gn.group_norm_coeffs_int8_plain(q, scale, groups, w, b, 1e-5, True)
    assert mean.dtype == var.dtype == torch.float32
    for got, want in ((mean, mean64), (var, var64)):
        ulp = np.spacing(np.abs(want.float().numpy()))
        assert np.all(np.abs(got.double().numpy() - want.numpy()) <= ulp), (kind, got, want)
    for got, want in zip(coeffs, gn.fold_affine(mean, var, w, b, 1e-5)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_group_norm_coeffs_int8_takes_the_plain_version_on_cpu(per_channel):
    q, scale, groups = _int8_stats_case("per_channel" if per_channel else "per_tensor")
    w = torch.from_numpy(np.linspace(0.5, 1.5, q.shape[1], dtype=np.float32))
    b = torch.zeros(q.shape[1])
    launches = gn.group_norm_coeffs_int8.launches
    got = gn.group_norm_coeffs_int8(q, scale, groups, w, b, 1e-5, stats=True)
    want = gn.group_norm_coeffs_int8_plain(q, scale, groups, w, b, 1e-5, True)
    assert len(got) == 5 and all(torch.equal(g, p) for g, p in zip(got, want))
    assert len(gn.group_norm_coeffs_int8(q, scale, groups, w, b, 1e-5)) == 3
    assert gn.group_norm_coeffs_int8.launches == launches


# ------------------------------------------------------------- ResBlock


def _seeded_tree(port: torch.nn.Module, seed: int):
    """Seeded numpy weights (``randomize_params``) loaded into the port's
    module; returns the flax params tree of the same values."""
    flat = {k[len("params/"):]: v for k, v in params_to_jax(port).items()}
    tree = randomize_params(traverse_util.unflatten_dict(flat, sep="/"), seed)
    load_into(port, tree)
    return tree


@pytest.mark.parametrize("in_ch,kwargs,quantized_input", [
    (8, dict(out_channels=12, use_emb=True, scale_factor=0.5), False),
    (8, dict(out_channels=12, use_emb=True), True),
    (8, dict(scale_factor=2.0), True),
], ids=["down_float_input", "proj_int8_input", "up_int8_input"])
def test_resblock_int8_codes(in_ch, kwargs, quantized_input):
    rng = np.random.RandomState(in_ch + len(kwargs))
    x = rng.randn(2, 64, in_ch).astype(np.float32)
    emb = rng.randn(2, 16).astype(np.float32) if kwargs.get("use_emb") else None
    port = tl.ResBlock(in_ch, kwargs.get("out_channels"), 16 if emb is not None else None,
                       kwargs.get("scale_factor", 1.0), act_int8_min_t=1)
    params = _seeded_tree(port, 3)
    jax_x = jq.quantize(jnp.asarray(x)) if quantized_input else jnp.asarray(x)
    block = jl.ResBlock(**kwargs, act_int8_min_t=1)
    want = jax.jit(lambda v, x, e: block.apply(v, x, e))(
        {"params": params}, jax_x, None if emb is None else jnp.asarray(emb))
    port_x = _port_qact(jax_x) if quantized_input else nct(x)
    with torch.no_grad():
        got = port(port_x, None if emb is None else torch.from_numpy(emb))
    assert isinstance(got, qact.QAct)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
    diff = np.abs(got.q.numpy().astype(int) - _jax_codes(want).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


# ------------------------------------------- the fused quantize entry points


def _codes_input(x: torch.Tensor, per_channel: bool, dtype) -> qact.QAct:
    """x quantized per tensor, or its channel halves apart and concatenated
    (a per-channel scale, as the up path's concat makes one)."""
    if per_channel:
        c = x.shape[1] // 2
        qa = qact.qact_concat(qact.quantize(x[:, :c].contiguous()),
                              qact.quantize(9.0 * x[:, c:].contiguous()))
    else:
        qa = qact.quantize(x)
    return qact.QAct(qa.q, qa.scale, dtype)


def _same_codes(got: qact.QAct, want: qact.QAct) -> None:
    assert got.dtype == want.dtype
    assert got.scale.numpy().tobytes() == want.scale.numpy().tobytes()
    np.testing.assert_array_equal(got.q.numpy(), want.q.numpy())


@pytest.mark.parametrize("use_gelu", [True, False], ids=["gelu", "no_gelu"])
@pytest.mark.parametrize("source", ["float", "int8", "int8_per_channel"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantize_group_norm_is_apply_then_quantize(dtype, source, use_gelu):
    """The GroupNorm-prologue quantize (its plain version on the CPU) has
    the codes and scale of the apply (float, or int8 mode) then quantize."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy((3.0 * rng.randn(2, 8, 40) + 0.5).astype(np.float32))
    w = torch.from_numpy(np.linspace(0.5, 1.5, 8, dtype=np.float32))
    b = torch.from_numpy(np.linspace(-0.2, 0.2, 8, dtype=np.float32))
    film = tuple(torch.from_numpy((0.5 * rng.randn(2, 8)).astype(np.float32)).to(dtype)
                 for _ in "ab")
    if source == "float":
        xin = x.to(dtype)
        coeffs = gn.group_norm_coeffs(xin, 4, w, b, 1e-5, film)
        want = qact.quantize(gn.group_norm_apply(xin, *coeffs, use_gelu))
    else:
        xin = _codes_input(x, source.endswith("per_channel"), dtype)
        coeffs = gn.group_norm_coeffs_int8(xin.q, xin.scale, 4, w, b, 1e-5)
        want = qact.quantize(gn.group_norm_apply_int8(xin.q, xin.scale, *coeffs, use_gelu,
                                                      dtype))
    _same_codes(qact.quantize_group_norm(xin, *coeffs, use_gelu), want)
    _same_codes(qact.quantize_group_norm_plain(xin, *coeffs, use_gelu), want)


@pytest.mark.parametrize("skip_kind", ["float", "int8", "int8_per_channel"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantize_residual_is_add_then_quantize(dtype, skip_kind):
    """The residual-prologue quantize has the codes and scale of the eager
    add in the dtype (an int8 skip dequantized to it first) then quantize."""
    rng = np.random.RandomState(12)
    x = torch.from_numpy((2.0 * rng.randn(2, 8, 40)).astype(np.float32))
    h = torch.from_numpy(rng.randn(2, 8, 40).astype(np.float32)).to(dtype)
    if skip_kind == "float":
        skip = x.to(dtype)
        want = qact.quantize(skip + h)
    else:
        skip = _codes_input(x, skip_kind.endswith("per_channel"), dtype)
        want = qact.quantize(qact.dequantize(skip, dtype) + h)
    _same_codes(qact.quantize_residual(skip, h), want)
    _same_codes(qact.quantize_residual_plain(skip, h), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantize_then_upsample_is_upsample_then_quantize(dtype):
    """Nearest repetition commutes with the quantize (same amax, codes
    elementwise), so the up path quantizes norm_in's output before the
    upsample, here and after the GroupNorm prologue."""
    rng = np.random.RandomState(13)
    x = torch.from_numpy((3.0 * rng.randn(2, 8, 33)).astype(np.float32)).to(dtype)
    _same_codes(qact.qact_upsample(qact.quantize(x), 2),
                qact.quantize(tl.nearest_upsample_1d(x, 2)))
    w, b = torch.ones(8), torch.zeros(8)
    coeffs = gn.group_norm_coeffs(x, 4, w, b, 1e-5)
    _same_codes(qact.qact_upsample(qact.quantize_group_norm(x, *coeffs, True), 2),
                qact.quantize(tl.nearest_upsample_1d(gn.group_norm_apply(x, *coeffs, True),
                                                     2)))


def _unfused_block(block: tl.ResBlock, x, emb):
    """The int8 ResBlock as it was composed before the fused quantizes:
    every GroupNorm applied and every sum written, then quantized."""
    def mq(h):
        return tl.maybe_quantize(h, block.act_int8_min_t)

    h = block.conv_in(mq(block._resize(block.norm_in(x))))
    film = None if emb is None else tuple(
        tl.linear(tl.gelu(emb), block.cond_proj).chunk(2, dim=-1))
    h = block.conv_out(mq(block.norm_mid(h, film)))
    return mq(block._skip(x) + h)


@pytest.mark.parametrize("kwargs,quantized_input,min_t", [
    (dict(out_channels=12, emb=True), True, 1),
    (dict(out_channels=12, emb=True), False, 1),
    (dict(scale_factor=2.0, emb=True), True, 1),
    (dict(scale_factor=2.0), False, 80),
    (dict(scale_factor=0.5, emb=True), True, 1),
    (dict(scale_factor=0.5), True, 40),
], ids=["proj_int8", "proj_float", "up_int8", "up_float_to_int8", "down_int8",
        "down_int8_to_float"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_resblock_int8_routes_are_the_unfused_composition(dtype, kwargs, quantized_input,
                                                          min_t):
    """The ResBlock's fused int8 routes give the unfused composition's
    output bit for bit, at every site (and where the output stays float)."""
    rng = np.random.RandomState(14)
    block = tl.ResBlock(8, kwargs.get("out_channels"), 16 if kwargs.get("emb") else None,
                        kwargs.get("scale_factor", 1.0), act_int8_min_t=min_t)
    _seeded_tree(block, 5)
    x = torch.from_numpy(rng.randn(2, 8, 64).astype(np.float32)).to(dtype)
    emb = torch.from_numpy(rng.randn(2, 16).astype(np.float32)).to(dtype) \
        if kwargs.get("emb") else None
    if quantized_input:
        x = qact.quantize(x)
    with torch.no_grad():
        got, want = block(x, emb), _unfused_block(block, x, emb)
    assert isinstance(got, qact.QAct) == isinstance(want, qact.QAct)
    if isinstance(want, qact.QAct):
        _same_codes(got, want)
    else:
        assert torch.equal(got, want)


def test_fused_quantize_refusals():
    h = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="one dtype"):
        qact.quantize_residual(h.to(torch.bfloat16), h)
    with pytest.raises(ValueError, match="one dtype"):
        qact.quantize_residual(torch.zeros(1, 4, 9), h)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qact.quantize_residual(h.double(), h.double())
    with pytest.raises(ValueError, match="mean must be float32"):
        qact.quantize_group_norm(h, torch.zeros(1, 3), torch.zeros(1, 4), torch.zeros(1, 4),
                                 False)


# ----------------------------------------------------------------- UNets

PRED_KW = dict(channel_mult=(1, 2, 4), middle_dilations=(2,), depth_mult=1)


def _close_to_jax_int8(got, want, port_float, dtype) -> None:
    """The port's int8 output against JAX's (see the module docstring)."""
    got, want = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    corr = np.corrcoef(got, want)[0, 1]
    if dtype is not None:
        assert corr > 0.98, corr
        return
    quant_err = np.linalg.norm(want - port_float.ravel())
    assert np.linalg.norm(got - want) < quant_err, (np.linalg.norm(got - want), quant_err)
    assert corr > 0.999, corr


@pytest.mark.parametrize("cond_kind,dtype", [("labels", None), ("cond", None),
                                             ("labels", "bfloat16")])
def test_unet_predictor_int8_matches_jax(cond_kind, dtype):
    rng = np.random.RandomState(11)
    x = rng.randn(2, 256, 1).astype(np.float32)
    ts = np.asarray([0.3, 0.7], np.float32)
    module_kw = dict(num_labels=3) if cond_kind == "labels" else dict(cond_channels=6)
    call = (dict(labels=np.asarray([0, 2], np.int32)) if cond_kind == "labels" else
            dict(cond=rng.randn(2, 64, 6).astype(np.float32)))
    jax_call = {k: jnp.asarray(v) for k, v in call.items()}
    tdtype = getattr(torch, dtype) if dtype else None
    port = UNetPredictor(8, **PRED_KW, **module_kw, dtype=tdtype, act_int8_min_t=64)
    params = _seeded_tree(port, 14)
    quant = JaxPredictor(8, **PRED_KW, **module_kw, dtype=jnp.dtype(dtype) if dtype else None,
                         act_int8_min_t=64)
    want = np.asarray(jax.jit(lambda v: quant.apply(v, jnp.asarray(x), jnp.asarray(ts),
                                                    **jax_call))({"params": params}))
    torch_call = {k: torch.from_numpy(v) for k, v in call.items()}
    if "labels" in torch_call:
        torch_call["labels"] = torch_call["labels"].long()
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(ts), **torch_call).numpy()
        port.act_int8_min_t = 0
        for b in port.modules():
            if isinstance(b, tl.ResBlock):
                b.act_int8_min_t = 0
        port_float = port(torch.from_numpy(x), torch.from_numpy(ts), **torch_call).numpy()
    _close_to_jax_int8(got, want, port_float, dtype)


def test_unet_encoder_int8_matches_jax():
    x = np.random.RandomState(15).randn(2, 64, 1).astype(np.float32)
    kw = dict(channel_mult=(1, 2), depth_mult=1, out_channels=16, out_dilations=(2,))
    port = UNetEncoder(8, **kw, act_int8_min_t=32)
    params = _seeded_tree(port, 17)
    quant = JaxEncoder(8, **kw, act_int8_min_t=32)
    want = np.asarray(jax.jit(lambda v: quant.apply(v, jnp.asarray(x)))({"params": params}))
    float_port = UNetEncoder(8, **kw)
    load_into(float_port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        port_float = float_port(torch.from_numpy(x)).numpy()
    _close_to_jax_int8(got, want, port_float, None)


# ------------------------------------------------------------- refusals


def test_int8_refusals():
    model = UNetPredictor(4, channel_mult=(1, 2), depth_mult=1, act_int8_min_t=16)
    x, ts = torch.zeros(1, 32, 1), torch.zeros(1)
    with pytest.raises(ValueError, match="serving-only"):
        model(x, ts)  # grad enabled
    with torch.no_grad():
        with pytest.raises(ValueError, match="serving-only"):
            model(x, ts, dropout=tl.Dropout(0.1))
        with pytest.raises(ValueError, match="sequence parallelism"):
            with sequence_parallel(create_seq_mesh()):
                model(x, ts)
        assert model(x, ts).shape == (1, 32, 1)
        block = tl.ResBlock(4, act_int8_min_t=1)
        with pytest.raises(ValueError, match="serving-only"):
            block(torch.zeros(1, 4, 8), dropout=tl.Dropout(0.1))
    with pytest.raises(ValueError, match="unet"):
        make_predictor("wavegrad", base_channels=8, act_int8_min_t=16)
    with pytest.raises(ValueError, match="unet"):
        make_encoder("conv-mfcc-ulaw", base_channels=8, act_int8_min_t=16)
    assert make_encoder("unet128", base_channels=4, act_int8_min_t=16).act_int8_min_t == 16
    with pytest.raises(ValueError, match="fuse_levels"):
        make_predictor("unet", base_channels=4, fuse_levels=2, act_int8_min_t=16)
    q = qact.quantize(torch.ones(1, 4, 8))
    with pytest.raises(ValueError, match="mixes int8 and float"):
        _concat(q, torch.ones(1, 4, 8))
    with pytest.raises(ValueError, match="FiLM"):
        tl.GroupNorm(4)(q, film=(torch.zeros(1, 4), torch.zeros(1, 4)))


def test_save_load_and_override(tmp_path):
    model = DiffusionModel(pred_name="unet", base_channels=4, act_int8_min_t=128)
    assert model.predictor.act_int8_min_t == 128
    path = str(tmp_path / "m.npz")
    model.save(path)
    assert DiffusionModel.load(path, device="cpu").act_int8_min_t == 128
    forced = DiffusionModel.load(path, device="cpu", act_int8_min_t=0)
    assert forced.act_int8_min_t == 0 and forced.predictor.act_int8_min_t == 0
    served = DiffusionModel.load(path, device="cpu", act_int8_min_t=256)
    assert served.predictor.act_int8_min_t == 256
    with pytest.raises(ValueError, match="fuse_levels"):
        DiffusionModel.load(path, device="cpu", fuse_levels=2)
    # The VQ-VAE's encoder stays float, as in the JAX package.
    vqvae = VQVAE(pred_name="unet", base_channels=4, enc_name="unet", act_int8_min_t=128)
    assert vqvae.predictor.act_int8_min_t == 128 and vqvae.encoder.act_int8_min_t == 0

    # A checkpoint the JAX package saves with the knob on (the port's
    # seeded weights, written by its DiffusionModel.save).
    jax_model = JaxDiffusionModel(pred_name="unet", base_channels=4, act_int8_min_t=128)
    flat = {k[len("params/"):]: v for k, v in params_to_jax(model).items()}
    jax_path = str(tmp_path / "jax.npz")
    jax_model.save(jax_path, {"params": traverse_util.unflatten_dict(flat, sep="/")})
    with np.load(jax_path) as data:
        assert json.loads(str(data["__meta__"]))["kwargs"]["act_int8_min_t"] == 128
    loaded = DiffusionModel.load(jax_path, device="cpu")
    assert loaded.act_int8_min_t == 128 and loaded.predictor.act_int8_min_t == 128
    resaved = str(tmp_path / "resaved.npz")
    loaded.save(resaved)
    with np.load(resaved) as data:
        assert json.loads(str(data["__meta__"]))["kwargs"] == jax_model.save_kwargs()


# ------------------------------------------------------------------ CLIs

MIN_T = "8000"  # the top two levels of a 2 s clip (32000, 16000)
VQVAE_KWARGS = dict(pred_name="unet", base_channels=4, enc_name="conv-mfcc-ulaw",
                    dictionary_size=16, num_labels=3)


def _seeded(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return model.eval()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("int8_ckpts")
    paths = {"vqvae": str(root / "vqvae.npz"), "uncond": str(root / "uncond.npz"),
             "in": str(root / "in.wav")}
    model = _seeded(VQVAE(**VQVAE_KWARGS), 1)
    with torch.no_grad():
        model.vq.dictionary.mul_(0.1)
    model.save(paths["vqvae"])
    _seeded(DiffusionModel(pred_name="unet", base_channels=4), 2).save(paths["uncond"])
    t = np.arange(32000) / 16000
    with wave.open(paths["in"], "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((0.3 * np.sin(2 * np.pi * 220 * t) * 32767).astype("<i2").tobytes())
    return paths


def _frames(path):
    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _pcm(samples: torch.Tensor) -> np.ndarray:
    """What the CLIs' linear ChunkWriter writes of float samples."""
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"pcm_{os.getpid()}.wav")
    with ChunkWriter(out, 16000, encoding="linear") as w:
        w.write(samples.reshape(-1).numpy())
    frames = _frames(out)
    os.remove(out)
    return frames


def _in_seq(path):
    return torch.from_numpy(read_audio_input(path, 16000, 2))[None, :, None]


def test_sample_vqvae_cli_int8(ckpts, tmp_path):
    out = str(tmp_path / "out.wav")
    sample_vqvae.main(["--label", "1", "--input-file", ckpts["in"], "--seconds", "2",
                       "--sample-steps", "2", "--sampler", "dpmpp", "--act-int8", MIN_T,
                       "--device", "cpu", ckpts["vqvae"], out])
    model = VQVAE.load(ckpts["vqvae"], device="cpu", act_int8_min_t=int(MIN_T))
    assert model.predictor.act_int8_min_t == int(MIN_T)
    in_seq = _in_seq(ckpts["in"])
    with torch.no_grad():
        want = model.decode(model.encode(in_seq), labels=torch.tensor([1]), steps=2,
                            sampler="dpmpp", constrain=True,
                            generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(_frames(out), _pcm(want[0, :, 0]))
    float_out = str(tmp_path / "float.wav")
    sample_vqvae.main(["--label", "1", "--input-file", ckpts["in"], "--seconds", "2",
                       "--sample-steps", "2", "--sampler", "dpmpp", "--device", "cpu",
                       ckpts["vqvae"], float_out])
    assert not np.array_equal(_frames(out), _frames(float_out))


def test_sample_vqvae_uncond_cli_int8(ckpts, tmp_path):
    out = str(tmp_path / "out.wav")
    sample_vqvae_uncond.main(["--label", "1", "--input-file", ckpts["in"], "--seconds", "2",
                              "--sample-steps", "2", "--sampler", "dpmpp",
                              "--guide-label-scale", "1", "--act-int8", MIN_T,
                              "--device", "cpu", ckpts["vqvae"], out])
    model = VQVAE.load(ckpts["vqvae"], device="cpu", act_int8_min_t=int(MIN_T))
    in_seq = _in_seq(ckpts["in"])
    with torch.no_grad():
        want = model.decode_uncond_guidance(
            model.encode(in_seq), labels=torch.tensor([1]), steps=2, constrain=True,
            label_scale=1.0, vq_scale=0.0, sampler="dpmpp",
            generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(_frames(out), _pcm(want[0, :, 0]))


def test_sample_diffusion_cli_int8(ckpts, tmp_path):
    out = str(tmp_path / "samples")
    argv = ["--device", "cpu", "--checkpoint-path", ckpts["uncond"], "--sampler", "dpmpp",
            "--sample-steps", "2", "--num-samples", "2", "--batch-size", "2",
            "--schedule", "quadratic", "--act-int8", "32000", "--sample-path", out]
    sample_diffusion.main(argv)
    model = DiffusionModel.load(ckpts["uncond"], device="cpu", act_int8_min_t=32000)
    gen_x, _, _ = sample_diffusion._generators(0, 0, torch.device("cpu"))
    x_T = torch.randn((2, sample_diffusion.SAMPLE_LEN, 1), generator=gen_x)
    with torch.no_grad():
        want = model.diffusion.dpmpp_sample(x_T, model.predict_eps, 2,
                                            warp=make_warp("quadratic"))
    for i in range(2):
        np.testing.assert_array_equal(_frames(os.path.join(out, f"sample_{i:06}.wav")),
                                      _pcm(want[i, :, 0]))
    with pytest.raises(ValueError, match="fuse_levels"):
        sample_diffusion.main(argv + ["--fuse-levels", "2"])
