"""The PyTorch port's kernel modules (vq_voice_swap_torch/ops) against the
JAX package.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the JAX reference. The CUDA kernels themselves are
held against the plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_voice_swap_tpu.ops.fused_norm import reference_group_norm
from vq_voice_swap_tpu.ops.mfcc import MFCCConfig as JaxMFCCConfig
from vq_voice_swap_tpu.ops.mfcc import mfcc as jax_mfcc
from vq_voice_swap_tpu.ops.vq_pallas import _xla_assign, vq_assign_pallas
from vq_voice_swap_tpu.vq import embedding_distances as jax_distances
from vq_voice_swap_tpu.vq import vq_forward as jax_vq_forward
from vq_voice_swap_torch.ops import group_norm as gn
from vq_voice_swap_torch.ops import vq_assign as vqa
from vq_voice_swap_torch.ops.mfcc import MFCCConfig, mfcc
from vq_voice_swap_torch.vq import embedding_distances, vq_forward

GN_TOL = dict(atol=2e-5, rtol=2e-5)


def _nct(x):
    """[N, T, C] numpy -> contiguous [N, C, T] torch."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 2, 1))))


def _ntc(y):
    return y.transpose(1, 2).numpy()


# ---------------------------------------------------------------- GroupNorm


@pytest.mark.parametrize("use_gelu", [False, True])
@pytest.mark.parametrize("shape,groups", [((2, 64, 16), 4), ((3, 40, 32), 32)])
def test_group_norm_matches_reference(shape, groups, use_gelu):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.3 * rng.randn(shape[-1])).astype(np.float32)
    bias = (0.3 * rng.randn(shape[-1])).astype(np.float32)
    want = np.asarray(reference_group_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups, 1e-5,
        use_gelu,
    ))
    got = gn.group_norm(
        _nct(x), torch.from_numpy(scale), torch.from_numpy(bias), groups,
        1e-5, use_gelu,
    )
    np.testing.assert_allclose(_ntc(got), want, **GN_TOL)


def test_group_norm_matches_flax_groupnorm():
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(2, 64, 16), jnp.float32)
    layer = nn.GroupNorm(num_groups=4, epsilon=1e-5)
    params = {"params": {
        "scale": jnp.asarray(1.0 + 0.3 * rng.randn(16), jnp.float32),
        "bias": jnp.asarray(0.3 * rng.randn(16), jnp.float32),
    }}
    want = np.asarray(layer.apply(params, x))
    got = gn.group_norm(
        _nct(np.asarray(x)), torch.from_numpy(np.array(params["params"]["scale"])),
        torch.from_numpy(np.array(params["params"]["bias"])), 4, 1e-5, False,
    )
    np.testing.assert_allclose(_ntc(got), want, **GN_TOL)


def test_group_norm_film_fold():
    """norm_mid's FiLM h*(ca+1)+cb and the GELU after it fold into one
    apply: same as the JAX ResBlock's GroupNorm -> FiLM -> GELU chain."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 48, 32).astype(np.float32)
    scale = (1.0 + 0.3 * rng.randn(32)).astype(np.float32)
    bias = (0.3 * rng.randn(32)).astype(np.float32)
    ca = (0.5 * rng.randn(2, 32)).astype(np.float32)
    cb = (0.5 * rng.randn(2, 32)).astype(np.float32)
    h = reference_group_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 8, 1e-5, False
    )
    want = np.asarray(jax.nn.gelu(
        h * (jnp.asarray(ca)[:, None] + 1.0) + jnp.asarray(cb)[:, None],
        approximate=False,
    ))
    got = gn.group_norm(
        _nct(x), torch.from_numpy(scale), torch.from_numpy(bias), 8, 1e-5,
        True, film=(torch.from_numpy(ca), torch.from_numpy(cb)),
    )
    np.testing.assert_allclose(_ntc(got), want, **GN_TOL)


def test_group_norm_large_mean():
    """Mean 100x the spread: the one-pass E[x^2] - mean^2 variance is off
    by ~1e-3 here, the two-pass reference and the port agree to 2e-5."""
    rng = np.random.RandomState(8)
    x = (100.0 + rng.randn(1, 256, 16)).astype(np.float32)
    scale = np.ones(16, np.float32)
    bias = np.zeros(16, np.float32)
    want = np.asarray(reference_group_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 4, 1e-5, False
    ))
    got = gn.group_norm(
        _nct(x), torch.from_numpy(scale), torch.from_numpy(bias), 4, 1e-5, False
    )
    np.testing.assert_allclose(_ntc(got), want, **GN_TOL)


def test_group_norm_extreme_mean_stays_finite():
    """The JAX package's large-mean regression input (mean/std = 1e5). f32
    holds that mean only to ulp(1000) = 6e-5, i.e. 6e-3 of a std, so the
    output can only be pinned to that granularity."""
    rng = np.random.RandomState(8)
    x = (1000.0 + 0.01 * rng.randn(1, 256, 16)).astype(np.float32)
    scale = np.ones(16, np.float32)
    bias = np.zeros(16, np.float32)
    want = np.asarray(reference_group_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 4, 1e-5, False
    ))
    got = _ntc(gn.group_norm(
        _nct(x), torch.from_numpy(scale), torch.from_numpy(bias), 4, 1e-5, False
    ))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-2)


@pytest.mark.parametrize("offset", [0.0, 1000.0])
def test_merge_partials_matches_float64(offset):
    """The Chan merge that folds chunk partials (the fused ResBlock's
    GroupNorm-2 tiles), held against float64 on chunks of unequal size (a
    ragged last chunk)."""
    rng = np.random.RandomState(3)
    x = offset + rng.randn(5, 40000)
    bounds = list(range(0, 40000, 16384)) + [40000]
    parts = [x[:, a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    count = np.stack([np.full(5, p.shape[1]) for p in parts], 1)
    means = np.stack([p.mean(1) for p in parts], 1)
    m2 = np.stack([((p - p.mean(1, keepdims=True)) ** 2).sum(1) for p in parts], 1)
    mean, var = gn.merge_partials(
        *(torch.tensor(a, dtype=torch.float32) for a in (count, means, m2))
    )
    np.testing.assert_allclose(mean.numpy(), x.mean(1), rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), x.var(1), rtol=1e-5)


@pytest.mark.parametrize("bad", ["rank", "dtype", "layout", "groups", "weight",
                                 "film_shape", "film_stride", "out_shape"])
def test_group_norm_wrappers_check_inputs(bad):
    x = torch.randn(2, 8, 16)
    w, b = torch.ones(8), torch.zeros(8)
    film, out = None, None
    if bad == "rank":
        x = x[0]
    elif bad == "dtype":
        x = x.double()
    elif bad == "layout":
        x = x.transpose(1, 2)
    elif bad == "weight":
        w = torch.ones(4)
    elif bad == "film_shape":
        film = (torch.zeros(2, 4), torch.zeros(2, 4))
    elif bad == "film_stride":
        ab = torch.zeros(2, 16)
        film = (ab[:, 0::2], ab[:, 1::2])
    elif bad == "out_shape":
        out = torch.empty(3, 2, 4)
    groups = 3 if bad == "groups" else 4
    with pytest.raises(ValueError):
        gn.group_norm_coeffs(x, groups, w, b, 1e-5, film, out)
    if bad in ("rank", "dtype", "layout", "groups"):
        with pytest.raises(ValueError):
            gn.group_norm_stats(x, groups)
    if bad in ("rank", "dtype", "layout"):
        stats = torch.zeros(2, 8)
        with pytest.raises(ValueError):
            gn.group_norm_apply(x, stats, stats, stats, True)


@pytest.mark.parametrize("film", [False, True])
def test_group_norm_coeffs_then_apply_match_jax(film):
    """The statistics kernel's entry point (affine and FiLM folded in) and
    the apply kernel's, against the JAX reference GroupNorm followed by the
    ResBlock's FiLM h*(ca+1)+cb and exact GELU. FiLM comes in as the two
    halves of one [N, 2C] projection, as the ResBlock passes it."""
    rng = np.random.RandomState(9)
    x = (rng.randn(2, 40, 48) * 1.5 + 0.3).astype(np.float32)
    scale = (1.0 + 0.3 * rng.randn(48)).astype(np.float32)
    bias = (0.3 * rng.randn(48)).astype(np.float32)
    ab = (0.5 * rng.randn(2, 96)).astype(np.float32)
    h = reference_group_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 16, 1e-5, False
    )
    pair = None
    if film:
        h = h * (jnp.asarray(ab[:, :48])[:, None] + 1.0) + jnp.asarray(ab[:, 48:])[:, None]
        pair = torch.from_numpy(ab).chunk(2, dim=-1)
    want = np.asarray(jax.nn.gelu(h, approximate=False))
    xt = _nct(x)
    coeffs = gn.group_norm_coeffs(
        xt, 16, torch.from_numpy(scale), torch.from_numpy(bias), 1e-5, pair
    )
    assert all(v.shape == (2, 48) and v.dtype == torch.float32 for v in coeffs)
    got = gn.group_norm_apply(xt, *coeffs, True)
    np.testing.assert_allclose(_ntc(got), want, atol=1e-5, rtol=1e-5)


def test_group_norm_coeffs_column_slices_equal_concat():
    """Two inputs, each writing its column slice of one [3, N, Cin] buffer
    from its share of the groups, weight and bias (the fused ResBlock's
    GroupNorm-1 on a skip concat), give the coefficients of the concat."""
    rng = np.random.RandomState(10)
    x1 = torch.from_numpy(rng.randn(3, 24, 20).astype(np.float32))
    x2 = torch.from_numpy((2.0 + rng.randn(3, 40, 20)).astype(np.float32))
    w = torch.from_numpy((1.0 + 0.3 * rng.randn(64)).astype(np.float32))
    b = torch.from_numpy((0.3 * rng.randn(64)).astype(np.float32))
    out = torch.full((3, 3, 64), float("nan"))
    gn.group_norm_coeffs(x1, 3, w[:24], b[:24], 1e-5, out=out[:, :, :24])
    gn.group_norm_coeffs(x2, 5, w[24:], b[24:], 1e-5, out=out[:, :, 24:])
    want = gn.group_norm_coeffs(torch.cat([x1, x2], dim=1), 8, w, b, 1e-5)
    for got_v, want_v in zip(out, want):
        np.testing.assert_allclose(got_v.numpy(), want_v.numpy(), atol=1e-6, rtol=1e-6)


def test_group_norm_bf16_output_dtype():
    """bf16 in, float32 statistics, bf16 out."""
    rng = np.random.RandomState(4)
    x32 = _nct(rng.randn(2, 32, 16).astype(np.float32))
    w, b = torch.ones(16), torch.zeros(16)
    got = gn.group_norm(x32.bfloat16(), w, b, 4, 1e-5, True)
    assert got.dtype == torch.bfloat16
    want = gn.group_norm(x32, w, b, 4, 1e-5, True)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2)


# ----------------------------------------------------------------------- VQ


def _assert_same_codes_or_ties(dictionary, x, got, want):
    """Indices equal, or where they differ a true tie: the float64
    distances of both picks within 1e-6 relative."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.nonzero(got != want)[0]
    d64 = dictionary.astype(np.float64)
    x64 = x.astype(np.float64)
    for i in diff:
        a = np.sum((x64[i] - d64[got[i]]) ** 2)
        b = np.sum((x64[i] - d64[want[i]]) ** 2)
        assert abs(a - b) <= 1e-6 * max(abs(a), abs(b)), (i, a, b)


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_vq_assign_matches_jax(reference):
    rng = np.random.RandomState(0)
    d = rng.randn(128, 128).astype(np.float32)
    x = rng.randn(300, 128).astype(np.float32)  # not a tile multiple
    if reference == "xla":
        want_idx, want_used = _xla_assign(jnp.asarray(d), jnp.asarray(x))
    else:
        want_idx, want_used = vq_assign_pallas(
            jnp.asarray(d), jnp.asarray(x), tile=128, interpret=True
        )
    idx, used = vqa.vq_assign(torch.from_numpy(d), torch.from_numpy(x))
    assert idx.dtype == torch.int32 and used.dtype == torch.int32
    _assert_same_codes_or_ties(d, x, idx.numpy(), want_idx)
    np.testing.assert_array_equal(used.numpy(), np.asarray(want_used))


def test_vq_assign_exact_tie_takes_lowest_index():
    rng = np.random.RandomState(5)
    d = rng.randn(16, 8).astype(np.float32)
    d[11] = d[3]  # duplicate codes: every row ties between 3 and 11
    x = d[[3, 3, 11, 5]] + 0.0
    idx, used = vqa.vq_assign(torch.from_numpy(d), torch.from_numpy(x))
    assert idx.tolist() == [3, 3, 3, 5]
    assert used.nonzero().flatten().tolist() == [3, 5]


def test_vq_forward_and_distances_match_jax():
    rng = np.random.RandomState(6)
    d = rng.randn(16, 8).astype(np.float32)
    x = rng.randn(2, 5, 8).astype(np.float32)
    np.testing.assert_allclose(
        embedding_distances(torch.from_numpy(d), torch.from_numpy(x)).numpy(),
        np.asarray(jax_distances(jnp.asarray(d), jnp.asarray(x))),
        atol=1e-5, rtol=1e-5,
    )
    want = jax_vq_forward(jnp.asarray(d), jnp.asarray(x))
    got = vq_forward(torch.from_numpy(d), torch.from_numpy(x))
    np.testing.assert_array_equal(got["idxs"].numpy(), np.asarray(want["idxs"]))
    np.testing.assert_array_equal(got["used"].numpy(), np.asarray(want["used"]))
    for k in ("embedded", "passthrough"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6)


def _tf32(v: torch.Tensor, round_half_away: bool) -> torch.Tensor:
    """Float32 cut to TF32's 10 explicit mantissa bits: rounded to nearest,
    half away from zero (the kernel's head, as cvt.rna.tf32.f32 rounds), or
    truncated (the kernel's tail, whose low 13 bits the tensor cores
    ignore)."""
    bits = v.view(torch.int32)
    if round_half_away:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def test_vq_3xtf32_split_stays_within_tie_criterion():
    """The CUDA kernel's arithmetic, emulated: x.d as x_lo.d_hi + x_hi.d_lo +
    x_hi.d_hi of TF32 heads and tails, float32 accumulation. At the swap
    path's shape its picks stay within the 1e-6 relative tie criterion of
    the float64 argmin; one TF32 product (heads only) does not, which is why
    the kernel splits."""
    rng = np.random.RandomState(11)
    d = torch.from_numpy(rng.randn(512, 1024).astype(np.float32))
    x = torch.from_numpy(rng.randn(3200, 1024).astype(np.float32))
    dh, xh = _tf32(d, True), _tf32(x, True)
    dl, xl = _tf32(d - dh, False), _tf32(x - xh, False)
    # The tail carries what the head drops, to ~2^-21 of the value.
    assert ((d - dh - dl).abs() <= 2.0 ** -20 * d.abs()).all()
    norms = torch.sum(d * d, dim=-1)
    d64, x64 = d.double(), x.double()
    dist64 = ((d64 * d64).sum(-1)[None] - 2.0 * (x64 @ d64.t())
              + (x64 * x64).sum(-1)[:, None])
    best = dist64.min(dim=-1).values

    def worst_gap(dots):
        pick = torch.argmin(norms[None] - 2.0 * dots, dim=-1)
        return ((dist64.gather(1, pick[:, None])[:, 0] - best) / best).max().item()

    assert worst_gap(xl @ dh.t() + xh @ dl.t() + xh @ dh.t()) <= 1e-6
    assert worst_gap(xh @ dh.t()) > 1e-6


@pytest.mark.parametrize("bad", ["shape", "dtype", "layout", "block_codes"])
def test_vq_assign_checks_inputs(bad):
    d = torch.randn(16, 8)
    x = torch.randn(10, 8)
    block_codes = None
    if bad == "shape":
        x = torch.randn(10, 7)
    elif bad == "dtype":
        x = x.double()
    elif bad == "layout":
        x = torch.randn(8, 10).t()
    else:
        block_codes = 48
    with pytest.raises(ValueError):
        vqa.vq_assign(d, x, block_codes)


# --------------------------------------------------------------------- MFCC


@pytest.mark.parametrize("version", [1, 2])
def test_mfcc_matches_jax_and_golden(version):
    import os

    g = np.load(os.path.join(os.path.dirname(__file__), "golden", "mfcc_golden.npz"))
    kw = (dict(n_fft=320, hop_length=160, n_mels=40, log_mels=True, normalized=False)
          if version == 1 else
          dict(n_fft=400, hop_length=160, n_mels=80, log_mels=False, normalized=True))
    got = mfcc(torch.from_numpy(g["wav"].astype(np.float32)), MFCCConfig(**kw)).numpy()
    want = np.asarray(jax_mfcc(jnp.asarray(g["wav"], jnp.float32), JaxMFCCConfig(**kw)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, g[f"mfcc_v{version}"], rtol=1e-4, atol=1e-4)
