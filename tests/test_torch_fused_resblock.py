"""The port's fused same-resolution ResBlock (vq_voice_swap_torch/ops/
fused_resblock.py) and ``UNetPredictor(fuse_levels=K)`` against the JAX
package: the TPU kernel pair in ``attic/fused_resblock.py`` run in Pallas
interpret mode, ``attic/packed_unet.py::packed_unet_predict``, and the flax
modules they replace, on the same randomised parameters.

The attic files are loaded from their paths under the module names they
had in the JAX package, so their package-relative imports resolve; no file
moves. On the CPU the port's wrapper runs its plain version, which is what
these tests hold against the references; the CUDA kernels are held against
that plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).

Tolerances: atol/rtol 2e-4 in float32 (the frameworks sum convolutions in
different orders), 5e-2 in bfloat16 (g, h1 and z are rounded to bf16 at
different points: the flax block adds skip + h in bf16, the kernels in
float32).
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_util import load_into, nct, ntc, randomize_params

from vq_voice_swap_tpu.models.layers import ResBlock as JaxResBlock
from vq_voice_swap_tpu.models.layers import adaptive_group_count
from vq_voice_swap_tpu.models.unet import UNetPredictor as JaxPredictor
from vq_voice_swap_torch.models import unet as port_unet
from vq_voice_swap_torch.models.layers import ResBlock
from vq_voice_swap_torch.models.unet import UNetPredictor
from vq_voice_swap_torch.ops import fused_resblock as frb

ATTIC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "attic")
F32_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


@pytest.fixture(scope="module")
def attic():
    """attic/fused_resblock.py and attic/packed_unet.py, loaded as
    vq_voice_swap_tpu.ops.{fused_resblock, packed_unet} for this module's
    tests and unregistered after them."""
    names = {}
    for stem in ("fused_resblock", "packed_unet"):
        name = f"vq_voice_swap_tpu.ops.{stem}"
        spec = importlib.util.spec_from_file_location(name, os.path.join(ATTIC, f"{stem}.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        names[stem] = module
    yield names
    for stem in names:
        sys.modules.pop(f"vq_voice_swap_tpu.ops.{stem}", None)


def _block_case(seed, n, t, c1, c2, cout, dilation, use_emb, dtype):
    """Random inputs and parameters for one block; returns the flax block,
    its params, the port's block and the inputs as numpy [N, T, C]."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, t, c1).astype(np.float32)
    x2 = rng.randn(n, t, c2).astype(np.float32) if c2 else None
    emb = rng.randn(n, 24).astype(np.float32) if use_emb else None
    if dtype == jnp.bfloat16:  # bf16-representable inputs for both sides
        x, x2, emb = (None if a is None else np.asarray(jnp.asarray(a, dtype), np.float32)
                      for a in (x, x2, emb))
    block = JaxResBlock(out_channels=cout, use_emb=use_emb, dilation=dilation,
                        dtype=None if dtype == jnp.float32 else dtype)
    cat = x if x2 is None else np.concatenate([x, x2], axis=-1)
    args = (jnp.asarray(cat),) + ((jnp.asarray(emb),) if use_emb else ())
    params = jax.jit(lambda r: block.init(r, *args))(jax.random.key(0))["params"]
    params = randomize_params(params, seed + 1)
    port = load_into(ResBlock(c1 + c2, cout, 24 if use_emb else None, dilation=dilation),
                     params)
    return block, params, port, x, x2, emb


def _port_args(x, x2, emb, dtype):
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return (nct(x).to(tdt), None if emb is None else torch.from_numpy(emb).to(tdt),
            None if x2 is None else nct(x2).to(tdt))


# (n, t, c1, c2, cout, dilation, film, dtype, attic tile): the cases of
# attic/test_fused_resblock.py, and a ragged T that no tile divides.
BLOCK_CASES = {
    "film_64_to_64": (2, 256, 64, 0, 64, 2, True, jnp.float32, 64),
    "skip_proj_no_film": (1, 192, 128, 0, 64, 1, False, jnp.float32, 64),
    "two_input_concat": (2, 256, 64, 64, 64, 2, True, jnp.float32, 64),
    "dilation_4_multi_tile": (2, 384, 64, 0, 64, 4, True, jnp.float32, 128),
    "bf16": (1, 256, 64, 0, 64, 2, True, jnp.bfloat16, 64),
    "ragged_t": (2, 250, 64, 0, 64, 2, True, jnp.float32, None),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_fused_resblock_plain_matches_attic_and_flax(attic, case):
    n, t, c1, c2, cout, dilation, film, dtype, tile = BLOCK_CASES[case]
    block, params, port, x, x2, emb = _block_case(
        sorted(BLOCK_CASES).index(case), n, t, c1, c2, cout, dilation, film, dtype)
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    with torch.no_grad():
        got = ntc(frb.fused_resblock(port, *_port_args(x, x2, emb, dtype)).float())
        plain = ntc(frb.fused_resblock_plain(port, *_port_args(x, x2, emb, dtype)).float())
    np.testing.assert_array_equal(got, plain)  # on the CPU the wrapper is the plain version

    cat = x if x2 is None else np.concatenate([x, x2], axis=-1)
    jargs = (jnp.asarray(cat, dtype),) + ((jnp.asarray(emb, dtype),) if film else ())
    want = np.asarray(block.apply({"params": params}, *jargs), np.float32)
    np.testing.assert_allclose(got, want, **tol)

    if tile is not None:  # the TPU kernels need a tile that divides T
        jx2 = None if x2 is None else jnp.asarray(x2, dtype)
        kernel = attic["fused_resblock"].fused_resblock(
            jnp.asarray(x, dtype), params, None if emb is None else jnp.asarray(emb, dtype),
            groups_in=adaptive_group_count(c1 + c2), groups_out=adaptive_group_count(cout),
            dilation=dilation, tile=tile, interpret=True, x2=jx2,
        )
        np.testing.assert_allclose(got, np.asarray(kernel, np.float32), **tol)


def test_fused_resblock_rejects_what_the_kernels_do_not_compute():
    block = ResBlock(12, 8, None)  # GroupNorm-1: 4 groups of 3 channels
    x = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="straddles"):
        frb.fused_resblock(block, x, None, x2=torch.zeros(1, 4, 32))
    with pytest.raises(ValueError, match="embedding"):
        frb.fused_resblock(block, torch.zeros(1, 12, 32), torch.zeros(1, 8))
    with pytest.raises(ValueError, match="same-resolution"):
        frb.fused_resblock(ResBlock(8, scale_factor=0.5), x)
    with pytest.raises(ValueError, match="same-resolution"):
        frb.fused_resblock(ResBlock(8, dilation=frb.MAX_DILATION + 1), x)
    with pytest.raises(ValueError, match="must be on"):
        frb.fused_resblock(block.to("meta"), torch.zeros(1, 12, 32))


def _tf32(v: torch.Tensor, round_half_away: bool) -> torch.Tensor:
    """Float32 cut to TF32's 10 explicit mantissa bits: rounded to nearest,
    half away from zero (the kernels' head), or truncated (the tail, whose
    low 13 bits the tensor cores ignore). As in tests/test_torch_ops.py."""
    bits = v.view(torch.int32)
    if round_half_away:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def test_fused_resblock_3xtf32_stays_within_card_tolerance(monkeypatch):
    """The float32 kernels' arithmetic, emulated on the CPU: each of the
    pair's three convolutions (conv_in, conv_out, the 1x1 skip) as
    x_lo.w_hi + x_hi.w_lo + x_hi.w_hi of TF32 heads and tails, summed in
    float32. The block's output stays within the card check's 2e-4
    (atol and rtol) of fused_resblock_plain with its convolutions in
    float64; heads alone (one TF32 product, cuDNN's TF32 mode) do not."""
    real_conv1d = F.conv1d
    modes = {}

    def conv1d(inp, weight, bias=None, **kw):
        mode = modes["mode"]
        if mode == "f64":
            return real_conv1d(inp.double(), weight.double(), bias.double(), **kw).float()
        xh, wh = _tf32(inp, True), _tf32(weight, True)
        if mode == "1xtf32":
            return real_conv1d(xh, wh, bias, **kw)
        xl, wl = _tf32(inp - xh, False), _tf32(weight - wh, False)
        return (real_conv1d(xl, wh, None, **kw) + real_conv1d(xh, wl, None, **kw)
                + real_conv1d(xh, wh, bias, **kw))

    monkeypatch.setattr(frb.F, "conv1d", conv1d)
    rng = np.random.RandomState(21)
    block = ResBlock(48, 64, 24, dilation=3)  # skip projection: all three convolutions
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.from_numpy(0.3 * rng.randn(*p.shape).astype(np.float32)))
    x = torch.from_numpy(rng.randn(2, 48, 300).astype(np.float32))
    emb = torch.from_numpy(rng.randn(2, 24).astype(np.float32))
    outs = {}
    with torch.no_grad():
        for mode in ("f64", "3xtf32", "1xtf32"):
            modes["mode"] = mode
            outs[mode] = frb.fused_resblock_plain(block, x, emb)
    want = outs["f64"]
    beyond = {m: ((outs[m] - want).abs() - 2e-4 * want.abs()).max().item()
              for m in ("3xtf32", "1xtf32")}
    assert beyond["3xtf32"] <= 2e-4 < beyond["1xtf32"], beyond


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_weight_layout_maps_back_to_conv1d(dtype):
    """The kernels' weight operand [tap, Cout, Cin'] (Cin zero-padded to a
    multiple of WEIGHT_ALIGN) holds exactly the rounded nn.Conv1d weights of
    conv_in, conv_out and the skip projection."""
    block = ResBlock(20, 40, None, dilation=2)  # Cin = 20 pads to 24
    for layer, taps in ((block.conv_in, 3), (block.conv_out, 3), (block.skip_proj, 1)):
        conv = layer.conv
        cout, cin, _ = conv.weight.shape
        w, b = frb._conv_weight(layer, dtype)
        assert w.dtype == dtype and w.is_contiguous()
        assert w.shape == (taps, cout, -(-cin // frb.WEIGHT_ALIGN) * frb.WEIGHT_ALIGN)
        assert torch.equal(w[:, :, :cin].permute(1, 2, 0), conv.weight.detach().to(dtype))
        assert not w[:, :, cin:].any()
        assert b.dtype == torch.float32
        assert torch.equal(b, conv.bias.detach().to(dtype).float())


PROBE = dict(base_channels=4, channel_mult=(1, 2, 2), depth_mult=1,
             middle_dilations=(2,), num_labels=3)


def test_fused_predictor_matches_packed_unet_and_flax(attic, monkeypatch):
    """UNetPredictor(fuse_levels=2) against packed_unet_predict(pack_levels=0,
    fuse_levels=2), with the TPU kernel pair forced on in interpret mode
    (its TPU gates patched as attic/test_fused_resblock.py does), and
    against predictor.apply; both sides route the same blocks."""
    fr = attic["fused_resblock"]
    attic_calls = []
    real = fr.fused_resblock

    def attic_fused(*a, **kw):
        attic_calls.append(kw.get("x2") is not None)
        return real(*a, **{**kw, "tile": 64, "interpret": True})

    monkeypatch.setattr(fr, "fused_resblock_supported", lambda x, d: 64 if d <= 7 else None)
    monkeypatch.setattr(fr, "fused_resblock", attic_fused)

    port_calls = []
    real_port = port_unet.fused_resblock

    def port_fused(block, x, emb, x2=None):
        port_calls.append(x2 is not None)
        return real_port(block, x, emb, x2=x2)

    monkeypatch.setattr(port_unet, "fused_resblock", port_fused)

    rng = np.random.RandomState(5)
    x = rng.randn(2, 512, 1).astype(np.float32)
    ts = np.asarray([0.3, 0.8], np.float32)
    labels = np.asarray([0, 2], np.int32)
    pred = JaxPredictor(**PROBE)
    params = jax.jit(lambda r: pred.init(r, jnp.asarray(x), jnp.asarray(ts),
                                         labels=jnp.asarray(labels)))(jax.random.key(1))
    params = randomize_params(params["params"], 11)
    want = np.asarray(pred.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts),
                                 labels=jnp.asarray(labels)))
    packed = np.asarray(attic["packed_unet"].packed_unet_predict(
        pred, params, jnp.asarray(x), jnp.asarray(ts), labels=jnp.asarray(labels),
        pack_levels=0, fuse_levels=2,
    ))

    port = load_into(UNetPredictor(**PROBE, fuse_levels=2), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(ts),
                   labels=torch.from_numpy(labels).long()).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got, packed, **F32_TOL)
    assert (len(port_calls), sum(port_calls)) == (len(attic_calls), sum(attic_calls)) == (6, 2)


def test_full_width_routing():
    """unet64 at fuse_levels=2: the 4 down and 6 up same-resolution blocks
    of the two top levels fuse, 5 of them on two inputs; the 192-channel
    up block (GroupNorm groups of 6 straddle its concat boundary at 128)
    takes the materialised concat. Nothing else fuses."""
    with torch.device("meta"):
        routes = UNetPredictor(64, fuse_levels=2).routes
        plain = UNetPredictor(64).routes
    # Down blocks come first (levels 0 and 1: 0, 1 and 3, 4), up blocks
    # last (level 1: 7th to 5th from the end, level 0: the last three).
    fused = [i for i, r in enumerate(routes) if r != "plain"]
    assert fused == [0, 1, 3, 4] + [len(routes) - k for k in (7, 6, 5, 3, 2, 1)]
    assert routes.count("fused, two inputs") == 5
    assert routes[-7] == "fused"  # 128 + 64 -> 64
    assert set(plain) == {"plain"}
