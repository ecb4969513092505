"""The GroupNorm backward of the PyTorch port (vq_voice_swap_torch/ops/
group_norm.py) on the CPU: ``group_norm_backward_plain`` and
``group_norm_param_grads`` against torch autograd of the plain forward and
against ``jax.vjp`` of the JAX package's ``reference_group_norm`` followed
by the FiLM and GELU of its ResBlock, ``GroupNormFunction``'s wiring of
the gradients and of the group statistics its forward saves, the
backward's route (``bwd_route``) at the models' shapes, and the fused
ResBlock's refusal to run under grad. The CUDA kernels are held against
the plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).

Inputs are made with numpy from a seed; [2, 12, 37] in 4 groups (3
channels a group, an odd T). Float32 throughout unless a test says
otherwise; tolerance 1e-5, the rounding of sums over 111 values in two
orders.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_voice_swap_tpu.ops.fused_norm import reference_group_norm
from vq_voice_swap_torch.classifier_model import ClassifierModel, EncoderPredictorModel
from vq_voice_swap_torch.diffusion_model import DiffusionModel
from vq_voice_swap_torch.models import layers
from vq_voice_swap_torch.models.layers import ResBlock
from vq_voice_swap_torch.ops import fused_resblock as frb
from vq_voice_swap_torch.ops import group_norm as gn

SHAPE, GROUPS, EPS = (2, 12, 37), 4, 1e-5
TOL = dict(atol=1e-5, rtol=1e-5)
FLAGS = [(False, False), (False, True), (True, False), (True, True)]


def _case(seed, film):
    """(x, weight, bias, FiLM pair or None, dy) as float32 numpy arrays."""
    n, c, t = SHAPE
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(n, c, t) + 0.5, 1.0 + 0.3 * rng.randn(c), 0.2 * rng.randn(c),
            0.4 * rng.randn(n, c), 0.4 * rng.randn(n, c), rng.randn(n, c, t)]
    x, w, b, ca, cb, dy = (a.astype(np.float32) for a in arrs)
    return x, w, b, (ca, cb) if film else None, dy


def _torch(arrs, requires_grad=False):
    return [None if a is None else torch.tensor(a, requires_grad=requires_grad)
            for a in arrs]


@pytest.mark.parametrize("film,use_gelu", FLAGS)
def test_plain_backward_matches_autograd(film, use_gelu):
    x, w, b, f, dy = _case(0, film)
    tx, tw, tb = _torch((x, w, b), requires_grad=True)
    tf = None if f is None else tuple(_torch(f, requires_grad=True))
    y = gn.group_norm(tx, tw, tb, GROUPS, EPS, use_gelu, tf)
    wrt = [tx, tw, tb, *(tf or ())]
    want = torch.autograd.grad(y, wrt, torch.from_numpy(dy))

    dx, s1, s2 = gn.group_norm_backward_plain(
        torch.from_numpy(x), torch.from_numpy(dy), GROUPS, tw.detach(), tb.detach(), EPS,
        use_gelu, None if f is None else tuple(_torch(f)))
    got = [dx, *(g for g in gn.group_norm_param_grads(
        s1, s2, tw.detach(), tb.detach(), None if f is None else tuple(_torch(f)))
        if g is not None)]
    assert len(got) == len(want)
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, **TOL)
    # On the CPU the wrapper is the plain version, bit for bit.
    again = gn.group_norm_backward(
        torch.from_numpy(x), torch.from_numpy(dy), GROUPS, tw.detach(), tb.detach(), EPS,
        use_gelu, None if f is None else tuple(_torch(f)))
    for u, v in zip(again, (dx, s1, s2)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("film,use_gelu", FLAGS)
def test_plain_backward_matches_jax_vjp(film, use_gelu):
    """Against jax.vjp of reference_group_norm ([N, T, C]), then the FiLM
    h * (ca + 1) + cb and exact GELU of the JAX ResBlock."""
    x, w, b, f, dy = _case(1, film)
    ca, cb = f if film else (np.zeros_like(x[:, :, 0]),) * 2

    def forward(xx, scale, bias, a, c):
        y = reference_group_norm(xx, scale, bias, GROUPS, EPS, use_gelu and not film)
        if film:
            y = y * (a[:, None, :] + 1.0) + c[:, None, :]
            if use_gelu:
                y = jax.nn.gelu(y, approximate=False)
        return y

    ntc = np.ascontiguousarray(x.transpose(0, 2, 1))
    _, vjp = jax.vjp(forward, *(jnp.asarray(a) for a in (ntc, w, b, ca, cb)))
    jdx, jdw, jdb, jdca, jdcb = (np.asarray(g) for g in vjp(jnp.asarray(dy.transpose(0, 2, 1))))

    tf = None if f is None else tuple(_torch(f))
    tw, tb = _torch((w, b))
    dx, s1, s2 = gn.group_norm_backward_plain(
        torch.from_numpy(x), torch.from_numpy(dy), GROUPS, tw, tb, EPS, use_gelu, tf)
    dw, db, dca, dcb = gn.group_norm_param_grads(s1, s2, tw, tb, tf)
    np.testing.assert_allclose(dx.numpy(), jdx.transpose(0, 2, 1), **TOL)
    np.testing.assert_allclose(dw.numpy(), jdw, **TOL)
    np.testing.assert_allclose(db.numpy(), jdb, **TOL)
    if film:
        np.testing.assert_allclose(dca.numpy(), jdca, **TOL)
        np.testing.assert_allclose(dcb.numpy(), jdcb, **TOL)
    else:
        assert dca is None and dcb is None


@pytest.mark.parametrize("needs", ["x", "params", "all"])
def test_function_gradients_match_autograd_of_plain(needs):
    """GroupNormFunction (the card's route under grad) runs here through
    the plain kernels: its output has the forward's bits, and its gradients,
    FiLM as the two halves of one [N, 2C] projection, are autograd's of the
    plain forward; a gradient not asked for is None."""
    x, w, b, (ca, cb), dy = _case(2, True)
    proj = np.concatenate([ca, cb], axis=1)
    grad_x, grad_p = needs in ("x", "all"), needs in ("params", "all")

    def inputs():
        tx = torch.tensor(x, requires_grad=grad_x)
        tw, tb, tp = (torch.tensor(a, requires_grad=grad_p) for a in (w, b, proj))
        return tx, tw, tb, tp

    tx, tw, tb, tp = inputs()
    y = gn.GroupNormFunction.apply(tx, tw, tb, *tp.chunk(2, dim=1), GROUPS, EPS, True)
    px, pw, pb, pp = inputs()
    want_y = gn.group_norm(px, pw, pb, GROUPS, EPS, True, tuple(pp.chunk(2, dim=1)))
    assert torch.equal(y, want_y)
    assert "GroupNormFunction" in type(y.grad_fn).__name__
    assert "GroupNormFunction" not in type(want_y.grad_fn).__name__
    y.backward(torch.from_numpy(dy))
    want_y.backward(torch.from_numpy(dy))
    for got, want in ((tx, px), (tw, pw), (tb, pb), (tp, pp)):
        if want.requires_grad:
            torch.testing.assert_close(got.grad, want.grad, **TOL)
        else:
            assert got.grad is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_with_given_stats_same_bits(dtype):
    """Given the group (mean, var) it would compute, the plain backward
    returns the same bits as without them, FiLM and GELU on."""
    x, w, b, f, dy = _case(4, True)
    tx, tdy = (torch.from_numpy(a).to(dtype) for a in (x, dy))
    tw, tb = _torch((w, b))
    tf = tuple(v.to(dtype) for v in _torch(f))
    stats = gn.group_stats_plain(tx, GROUPS)
    got = gn.group_norm_backward_plain(tx, tdy, GROUPS, tw, tb, EPS, True, tf, stats)
    want = gn.group_norm_backward_plain(tx, tdy, GROUPS, tw, tb, EPS, True, tf)
    for g, v in zip(got, want):
        assert g.dtype == v.dtype and torch.equal(g, v)
    again = gn.group_norm_backward(tx, tdy, GROUPS, tw, tb, EPS, True, tf, stats)
    for g, v in zip(again, want):
        assert torch.equal(g, v)


def test_coeffs_return_group_stats():
    """``group_norm_coeffs(..., stats=True)`` adds the group (mean, var) of
    ``group_stats_plain`` after the unchanged coefficients."""
    x, w, b, f, _ = _case(5, True)
    tx, tw, tb = _torch((x, w, b))
    tf = tuple(_torch(f))
    coeffs = gn.group_norm_coeffs(tx, GROUPS, tw, tb, EPS, tf)
    mean_c, a, bb, mean, var = gn.group_norm_coeffs(tx, GROUPS, tw, tb, EPS, tf, stats=True)
    for g, v in zip((mean_c, a, bb), coeffs):
        assert torch.equal(g, v)
    for g, v in zip((mean, var), gn.group_stats_plain(tx, GROUPS)):
        assert g.shape == (SHAPE[0], GROUPS) and torch.equal(g, v)


@pytest.mark.parametrize("film", [False, True])
def test_function_saves_group_stats(film):
    """GroupNormFunction's forward saves the group (mean, var) of
    ``group_stats_plain`` (the statistics its backward takes instead of
    recomputing them); its gradients, 3 channels a group, are autograd's
    through the plain forward."""
    x, w, b, f, dy = _case(6, film)
    tx, tw, tb = _torch((x, w, b), requires_grad=True)
    tf = None if f is None else tuple(_torch(f, requires_grad=True))
    y = gn.GroupNormFunction.apply(tx, tw, tb, *(tf or (None, None)), GROUPS, EPS, True)
    mean, var = y.grad_fn.saved_tensors[-2:]
    for g, v in zip((mean, var), gn.group_stats_plain(tx.detach(), GROUPS)):
        assert torch.equal(g, v)
    wrt = [tx, tw, tb, *(tf or ())]
    got = torch.autograd.grad(y, wrt, torch.from_numpy(dy))
    px, pw, pb = _torch((x, w, b), requires_grad=True)
    pf = None if f is None else tuple(_torch(f, requires_grad=True))
    want_y = gn.group_norm(px, pw, pb, GROUPS, EPS, True, pf)
    assert torch.equal(y, want_y)
    want = torch.autograd.grad(want_y, [px, pw, pb, *(pf or ())], torch.from_numpy(dy))
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, **TOL)


def test_function_matches_jax_vjp():
    """dx of GroupNormFunction with FiLM and GELU against jax.vjp of
    reference_group_norm, then the FiLM and exact GELU of the JAX ResBlock,
    on the same numpy inputs."""
    x, w, b, (ca, cb), dy = _case(7, True)

    def forward(xx):
        y = reference_group_norm(xx, jnp.asarray(w), jnp.asarray(b), GROUPS, EPS, False)
        y = y * (jnp.asarray(ca)[:, None, :] + 1.0) + jnp.asarray(cb)[:, None, :]
        return jax.nn.gelu(y, approximate=False)

    _, vjp = jax.vjp(forward, jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1))))
    (jdx,) = vjp(jnp.asarray(dy.transpose(0, 2, 1)))
    tx = torch.tensor(x, requires_grad=True)
    tw, tb, tca, tcb = _torch((w, b, ca, cb))
    y = gn.GroupNormFunction.apply(tx, tw, tb, tca, tcb, GROUPS, EPS, True)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx).transpose(0, 2, 1), **TOL)


# The guidance networks at the JAX package's training defaults, as the
# guided CLIs load them, and the unet64 predictor of the swap and sampling
# flagships; batches 1 and 2 (the guided CLIs) and 16 (serving); 4 s at
# 16 kHz; an H100's 132 SMs.
ROUTE_MODELS = {
    "enc_pred unet32": lambda: EncoderPredictorModel(downsample_rate=320, base_channels=32,
                                                     num_latents=512),
    "classifier unet32": lambda: ClassifierModel(num_labels=251, base_channels=32),
    "unet64": lambda: DiffusionModel(pred_name="unet", base_channels=64).predictor,
}


@functools.lru_cache(maxsize=None)
def _group_norm_shapes(name):
    """Every GroupNorm's ([C, T], groups) in one 4 s forward of the model,
    traced on the meta device (shapes only, no arithmetic)."""
    seen = set()

    def record(x, weight, bias, num_groups, eps, use_gelu, film=None):
        seen.add((tuple(x.shape[1:]), num_groups))
        return x

    model = ROUTE_MODELS[name]().to("meta")
    saved, layers.group_norm = layers.group_norm, record
    try:
        with torch.no_grad():
            model(torch.empty(1, 64000, 1, device="meta"), torch.empty(1, device="meta"))
    finally:
        layers.group_norm = saved
    return sorted(seen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(ROUTE_MODELS))
def test_bwd_route_takes_the_cluster_at_4_seconds(name, dtype):
    shapes = _group_norm_shapes(name)
    assert len(shapes) > 5 and max(c * t // g for (c, t), g in shapes) >= 64000
    for (c, t), groups in shapes:
        for n in (1, 2, 16):
            x = torch.empty((n, c, t), dtype=dtype, device="meta")
            route = gn.bwd_route(x, groups, sms=132)
            span = c // groups * t
            assert route.name == "cluster", (n, c, t, groups, route)
            assert 1 <= route.blocks <= gn.BWD_CLUSTER_MAX and route.chunk % 8 == 0
            assert route.blocks * route.chunk >= span > (route.blocks - 1) * route.chunk
            assert route.chunk <= gn.BWD_BLOCK_ELEMS


def test_bwd_route_two_kernels_beyond_the_cluster():
    """A span beyond 16 blocks of BWD_BLOCK_ELEMS (a unet64's first level,
    128 channels in 32 groups, at 8 s) takes the reduce + dx route; the
    largest span that fits takes the cluster."""
    big = torch.empty((1, 128, 128000), device="meta")
    route = gn.bwd_route(big, 32, sms=132)
    assert route.name == "two_kernel"
    assert (route.blocks, route.chunk) == gn.bwd_slices(big, sms=132)
    fits = torch.empty((1, 4, gn.BWD_CLUSTER_MAX * gn.BWD_BLOCK_ELEMS // 4), device="meta")
    assert gn.bwd_route(fits, 1, sms=132) == gn.BwdRoute(
        "cluster", gn.BWD_CLUSTER_MAX, gn.BWD_BLOCK_ELEMS)


def test_backward_checks_its_inputs():
    x, w, b, _, dy = _case(3, False)
    tx, tw, tb, tdy = _torch((x, w, b, dy))
    with pytest.raises(ValueError, match="dy must be"):
        gn.group_norm_backward(tx, tdy[:, :, 1:], GROUPS, tw, tb, EPS, True)
    with pytest.raises(ValueError, match="dy must be"):
        gn.group_norm_backward(tx, tdy.double(), GROUPS, tw, tb, EPS, True)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_backward(tx, tdy.transpose(1, 2).contiguous().transpose(1, 2),
                               GROUPS, tw, tb, EPS, True)
    with pytest.raises(ValueError, match="groups"):
        gn.group_norm_backward(tx, tdy, 5, tw, tb, EPS, True)
    mean, var = gn.group_stats_plain(tx, GROUPS)
    with pytest.raises(ValueError, match="stats must be"):
        gn.group_norm_backward(tx, tdy, GROUPS, tw, tb, EPS, True, None, (mean, var[:, :2]))
    with pytest.raises(ValueError, match="stats must be"):
        gn.group_norm_backward(tx, tdy, GROUPS, tw, tb, EPS, True, None, (mean.double(), var))


def test_fused_resblock_raises_under_grad():
    """The fused pair has no backward: under grad it raises, on the CPU too,
    whether the input or only a parameter requires grad; under no_grad the
    same call runs."""
    block = ResBlock(8, 8, 16).eval()
    x, emb = torch.randn(1, 8, 40), torch.randn(1, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        frb.fused_resblock(block, x, emb)  # the parameters require grad
    block.requires_grad_(False)
    with pytest.raises(RuntimeError, match="no backward"):
        frb.fused_resblock(block, x.requires_grad_(), emb)
    frb.fused_resblock(block, x.detach(), emb)
    with torch.no_grad():
        frb.fused_resblock(block.requires_grad_(True), x, emb)
