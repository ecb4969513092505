"""The PyTorch port's hand-written kernels against their plain PyTorch
versions on a CUDA card. Every test here needs the card and skips without
one. The file imports neither JAX nor the shared test helpers, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import copy
import math
import os

import pytest
import torch
import torch.nn.functional as F

from vq_voice_swap_torch.models import layers
from vq_voice_swap_torch.models.layers import ResBlock
from vq_voice_swap_torch.ops import conv1d as c1
from vq_voice_swap_torch.ops import fused_resblock as frb
from vq_voice_swap_torch.ops import group_norm as gn
from vq_voice_swap_torch.ops import vq_assign as vqa
from vq_voice_swap_torch.ops.tickets import ticket_buffers, tickets


@pytest.fixture
def cuda_gen():
    """A seeded CUDA generator, with TF32 off for matmuls and cuDNN
    convolutions (the plain versions' reference arithmetic) during the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,groups", [((2, 64, 3000), 32), ((3, 512, 250), 32),
                                          ((1, 4, 70000), 4)])
@pytest.mark.parametrize("film", [False, True])
def test_group_norm_kernels_match_plain(cuda_gen, dtype, atol, shape, groups, film):
    n, c, _ = shape
    x = (torch.randn(shape, generator=cuda_gen, device="cuda") + 3.0).to(dtype)
    w = torch.rand(c, generator=cuda_gen, device="cuda") + 0.5
    b = torch.randn(c, generator=cuda_gen, device="cuda")
    ab = None
    if film:
        ab = tuple(torch.randn(n, c, generator=cuda_gen, device="cuda") for _ in "ab")
    launches = (gn.group_norm_stats.launches, gn.group_norm_apply.launches)
    mean, var = gn.group_norm_stats(x, groups)
    pm, pv = gn.group_stats_plain(x, groups)
    torch.testing.assert_close(mean, pm, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(var, pv, atol=1e-5, rtol=1e-4)
    folded = gn.fold_affine(pm, pv, w, b, 1e-5, ab)
    for use_gelu in (False, True):
        got = gn.group_norm_apply(x, *folded, use_gelu).float()
        want = gn.group_norm_apply_plain(x, *folded, use_gelu).float()
        scale = 1.0 if dtype == torch.float32 else want.abs().clamp(min=1.0)
        assert ((got - want).abs() / scale).max().item() <= atol
    assert gn.group_norm_stats.launches == launches[0] + 1
    assert gn.group_norm_apply.launches == launches[1] + 2


def _coeffs_case(gen, shape, dtype, film, offset=3.0):
    n, c, _ = shape
    x = (torch.randn(shape, generator=gen, device="cuda") + offset).to(dtype)
    w = torch.rand(c, generator=gen, device="cuda") + 0.5
    b = torch.randn(c, generator=gen, device="cuda")
    ab = None
    if film:  # the two halves of one bf16 [N, 2C] projection, as ResBlock passes them
        ab = torch.randn(n, 2 * c, generator=gen, device="cuda").bfloat16().chunk(2, dim=-1)
    return x, w, b, ab


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((1, 64, 64000), 32), ((2, 64, 3000), 32),
                                          ((3, 512, 250), 32), ((1, 4, 70000), 4),
                                          ((2, 6, 333), 3)])  # last: a span of 666
@pytest.mark.parametrize("film", [False, True])
def test_group_norm_coeffs_kernel_matches_plain(cuda_gen, dtype, shape, groups, film):
    """One launch from x to the folded (mean, a, b): against fold_affine of
    the plain statistics (a carries rsqrt(var), so half the variance's 1e-4),
    and the same bits from a second call."""
    x, w, b, ab = _coeffs_case(cuda_gen, shape, dtype, film)
    launches = gn.group_norm_coeffs.launches
    got = gn.group_norm_coeffs(x, groups, w, b, 1e-5, ab)
    again = gn.group_norm_coeffs(x, groups, w, b, 1e-5, ab)
    want = gn.group_norm_coeffs_plain(x, groups, w, b, 1e-5, ab)
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=1e-4)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert gn.group_norm_coeffs.launches == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((1, 64, 64000), 32), ((3, 512, 250), 32),
                                          ((2, 6, 333), 3)])
def test_group_norm_coeffs_group_stats_match_stats_kernel(cuda_gen, dtype, shape, groups):
    """The coefficient launch's group (mean, var), which GroupNormFunction
    saves for the backward, have the bits of group_norm_stats; asking for
    them leaves the coefficients' bits as they are."""
    x, w, b, ab = _coeffs_case(cuda_gen, shape, dtype, True)
    launches = gn.group_norm_coeffs.launches
    *coeffs, mean, var = gn.group_norm_coeffs(x, groups, w, b, 1e-5, ab, stats=True)
    plain = gn.group_norm_coeffs(x, groups, w, b, 1e-5, ab)
    want = gn.group_norm_stats(x, groups)
    assert gn.group_norm_coeffs.launches == launches + 2
    for g, v in zip(coeffs, plain):
        assert torch.equal(g, v)
    for g, v in zip((mean, var), want):
        assert g.shape == (shape[0], groups) and g.is_contiguous() and torch.equal(g, v)


@pytest.mark.cuda
def test_group_norm_stats_tickets_reused_across_shapes(cuda_gen):
    """Multi-slice spans on alternating shapes share the ticket counters;
    every call must leave them reset, so repeated calls give the same bits."""
    cases = [_coeffs_case(cuda_gen, (1, 64, 64000), torch.float32, True),
             _coeffs_case(cuda_gen, (1, 4, 70000), torch.bfloat16, False)]
    groups = (32, 4)
    first = [gn.group_norm_coeffs(x, g, w, b, 1e-5, ab)
             for (x, w, b, ab), g in zip(cases, groups)]
    for _ in range(3):
        for (x, w, b, ab), g, want in zip(cases, groups, first):
            got = gn.group_norm_coeffs(x, g, w, b, 1e-5, ab)
            assert all(torch.equal(u, v) for u, v in zip(got, want))
            mean, var = gn.group_norm_stats(x, g)
            pm, pv = gn.group_stats_plain(x, g)
            torch.testing.assert_close(mean, pm, atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(var, pv, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_group_norm_stats_large_mean(cuda_gen):
    """A mean 100x the spread: the two-pass statistics keep the variance."""
    x = torch.randn(2, 64, 64000, generator=cuda_gen, device="cuda") + 100.0
    mean, var = gn.group_norm_stats(x, 32)
    pm, pv = gn.group_stats_plain(x, 32)
    torch.testing.assert_close(mean, pm, atol=1e-5, rtol=1e-5)
    assert ((var - pv).abs() / pv).max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 31, 200, 3200, 3201])
def test_vq_kernel_matches_plain(cuda_gen, rows):
    """Within the tie criterion of the plain version, and the same bits
    from a second call and from either code tile (every (row, code)
    distance gets the same arithmetic in both)."""
    d = torch.randn(512, 1024, generator=cuda_gen, device="cuda")
    x = torch.randn(rows, 1024, generator=cuda_gen, device="cuda")
    launches = vqa.vq_assign.launches
    idx, used = vqa.vq_assign(d, x)
    idx2, used2 = vqa.vq_assign(d, x)
    assert vqa.vq_assign.launches == launches + 2
    assert torch.equal(idx, idx2) and torch.equal(used, used2)
    for block_codes in vqa.BLOCK_CODES:
        idx2, used2 = vqa.vq_assign(d, x, block_codes)
        assert torch.equal(idx, idx2) and torch.equal(used, used2), block_codes
    pidx, pused = vqa.vq_assign_plain(d, x)
    for i in torch.nonzero(idx != pidx).flatten().tolist():
        a = ((x[i].double() - d[idx[i]].double()) ** 2).sum()
        b = ((x[i].double() - d[pidx[i]].double()) ** 2).sum()
        assert (a - b).abs() <= 1e-6 * torch.maximum(a, b), i
    mask = torch.zeros_like(used)
    mask[idx.long()] = 1
    assert torch.equal(used, mask)
    if torch.equal(idx, pidx):
        assert torch.equal(used, pused)


@pytest.mark.cuda
@pytest.mark.parametrize("block_codes", [None, 32, 64])
def test_vq_kernel_ties_take_lowest_index(cuda_gen, block_codes):
    d = torch.randn(200, 70, generator=cuda_gen, device="cuda")  # ragged C, D
    d[150] = d[9]
    d[199] = d[9]
    x = d[[9, 150, 199, 3]].contiguous()
    idx, used = vqa.vq_assign(d, x, block_codes)
    assert idx.tolist() == [9, 9, 9, 3]
    assert torch.nonzero(used).flatten().tolist() == [3, 9]


@pytest.mark.cuda
def test_ticket_counters_are_per_stream_and_left_zero(cuda_gen):
    """The kernels that merge across blocks take their tickets from a buffer
    of the stream they run on, and every launch leaves its counters at 0."""
    x, w, b, ab = _coeffs_case(cuda_gen, (1, 64, 64000), torch.float32, True)
    d = torch.randn(512, 1024, generator=cuda_gen, device="cuda")
    rows = torch.randn(3201, 1024, generator=cuda_gen, device="cuda")
    want = (gn.group_norm_coeffs(x, 32, w, b, 1e-5, ab), vqa.vq_assign(d, rows))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = (gn.group_norm_coeffs(x, 32, w, b, 1e-5, ab), vqa.vq_assign(d, rows))
    torch.cuda.synchronize()
    main_buf = tickets(torch.cuda.current_stream(), 1)
    side_buf = tickets(side, 1)
    assert main_buf.data_ptr() != side_buf.data_ptr()
    for u, v in zip(sum(want, ()), sum(got, ())):
        assert torch.equal(u, v)
    for buf in ticket_buffers():
        assert not buf.any()


def _fused_case(gen, dtype, c1, c2, cout, t, dilation, film):
    """A ResBlock with random parameters on the card and its inputs."""
    block = ResBlock(c1 + c2, cout, 24 if film else None, dilation=dilation)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen, device="cuda"))
    block = block.cuda().eval()
    x = torch.randn(2, c1, t, generator=gen, device="cuda").to(dtype)
    x2 = torch.randn(2, c2, t, generator=gen, device="cuda").to(dtype) if c2 else None
    emb = torch.randn(2, 24, generator=gen, device="cuda").to(dtype) if film else None
    return block, x, emb, x2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("c1,c2,cout,t,dilation,film", [
    (64, 0, 64, 300, 2, True),      # identity skip, ragged last tile
    (64, 64, 64, 250, 2, True),     # two inputs, skip_proj
    (192, 0, 64, 333, 1, False),    # the 192-channel up block, no FiLM
    (32, 0, 48, 1000, 4, True),     # outputs not a multiple of 64
    (128, 0, 160, 130, 7, True),    # three output passes, widest halo
    (256, 0, 256, 700, 7, True),    # the largest shared-memory footprint
    (40, 0, 64, 300, 2, True),      # Cin not a multiple of the MMA depth
    (64, 64, 64, 1001, 3, True),    # two inputs at a ragged, odd T
])
def test_fused_resblock_matches_plain(cuda_gen, dtype, tol, c1, c2, cout, t,
                                      dilation, film):
    """The kernel pair against fused_resblock_plain on random parameters:
    |got - want| <= tol * (1 + |want|) (one bf16 rounding of h1 can flip
    and carry through GroupNorm-2 and conv_out)."""
    block, x, emb, x2 = _fused_case(cuda_gen, dtype, c1, c2, cout, t, dilation, film)
    launches = (frb.fused_resblock_stats.launches, frb.fused_resblock_apply.launches)
    with torch.no_grad():
        got = frb.fused_resblock(block, x, emb, x2).float()
        want = frb.fused_resblock_plain(block, x, emb, x2).float()
    torch.cuda.synchronize()
    assert got.shape == (2, cout, t)
    assert ((got - want).abs() - tol * want.abs()).max().item() <= tol
    assert frb.fused_resblock_stats.launches == launches[0] + 1
    assert frb.fused_resblock_apply.launches == launches[1] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_resblock_same_bits_twice(cuda_gen, dtype):
    """No atomics and a fixed summation order: two calls give the same bits,
    with a skip projection and with the identity skip."""
    for c1, c2 in ((64, 64), (64, 0)):
        block, x, emb, x2 = _fused_case(cuda_gen, dtype, c1, c2, 64, 2000, 2, True)
        with torch.no_grad():
            first = frb.fused_resblock(block, x, emb, x2)
            second = frb.fused_resblock(block, x, emb, x2)
        assert torch.equal(first, second), (c1, c2)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| / max(|want|, 1): absolute below 1, relative
    above (one bf16 rounding step is 2^-8 of |y|)."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,groups", [
    ((2, 32, 3000), 32),
    ((1, 32, 64000), 32),   # few spans: many blocks a cluster
    ((2, 64, 3000), 32),    # 2 channels a group; blocks cross channel edges
    ((4, 512, 250), 32),    # many short rows, 16 channels a group
    ((3, 20, 333), 4),      # odd T (element-wise loads), 5 channels a group
    ((1, 2, 262144), 1),    # a span beyond a cluster: the two-kernel route
])
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("use_gelu", [False, True])
def test_group_norm_backward_kernel_matches_plain(cuda_gen, dtype, tol, shape, groups, film,
                                                  use_gelu):
    """dx, S1 and S2 against group_norm_backward_plain, by the route of
    bwd_route; the same bits from a second call that computes the
    statistics itself; launches counted per route; every ticket counter
    left at 0."""
    x, w, b, ab = _coeffs_case(cuda_gen, shape, dtype, film)
    dy = torch.randn(shape, generator=cuda_gen, device="cuda").to(dtype)
    route = gn.bwd_route(x, groups)
    assert route.name == ("two_kernel" if shape == (1, 2, 262144) else "cluster")
    if shape == (1, 32, 64000):
        assert route.blocks > 8  # a non-portable cluster size
    counters = (gn.group_norm_backward, gn.group_norm_stats, gn._bwd_cluster,
                gn._bwd_two_kernel)
    launches = [f.launches for f in counters]
    stats = gn.group_norm_stats(x, groups)
    got = gn.group_norm_backward(x, dy, groups, w, b, 1e-5, use_gelu, ab, stats)
    again = gn.group_norm_backward(x, dy, groups, w, b, 1e-5, use_gelu, ab)
    want = gn.group_norm_backward_plain(x, dy, groups, w, b, 1e-5, use_gelu, ab)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[0].shape == shape
    assert _rel_err(got[0], want[0]) <= tol
    for g, v in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, v, atol=1e-4 * v.abs().max().item(), rtol=1e-4)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    per_call = 1 if route.name == "cluster" else 2  # one launch, or reduce and dx
    cluster, two = (2 * per_call, 0) if route.name == "cluster" else (0, 2 * per_call)
    assert [f.launches for f in counters] == [launches[0] + 2 * per_call, launches[1] + 2,
                                              launches[2] + cluster, launches[3] + two]
    for buf in ticket_buffers():
        assert not buf.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_group_norm_function_matches_plain_autograd(cuda_gen, dtype, tol):
    """Under grad, GroupNorm runs through GroupNormFunction: its output has
    the no-grad bits, and its gradients (x, the affine, FiLM as the halves
    of one [N, 2C] projection) are autograd's through the plain versions.
    Without grad it launches the two forward kernels and no backward."""
    shape, groups = (2, 64, 3000), 32
    x0, w0, b0, _ = _coeffs_case(cuda_gen, shape, dtype, False)
    p0 = torch.randn(shape[0], 2 * shape[1], generator=cuda_gen, device="cuda").to(dtype)
    dy = torch.randn(shape, generator=cuda_gen, device="cuda").to(dtype)
    launches = [f.launches for f in (gn.group_norm_coeffs, gn.group_norm_apply,
                                     gn.group_norm_backward)]
    with torch.no_grad():
        y0 = gn.group_norm(x0, w0, b0, groups, 1e-5, True, tuple(p0.chunk(2, dim=1)))
    assert [f.launches for f in (gn.group_norm_coeffs, gn.group_norm_apply,
                                 gn.group_norm_backward)] == [launches[0] + 1,
                                                              launches[1] + 1, launches[2]]
    kernel = [v.clone().requires_grad_() for v in (x0, w0, b0, p0)]
    plain = [v.clone().requires_grad_() for v in (x0, w0, b0, p0)]
    x, w, b, p = kernel
    y = gn.group_norm(x, w, b, groups, 1e-5, True, tuple(p.chunk(2, dim=1)))
    assert "GroupNormFunction" in type(y.grad_fn).__name__
    assert torch.equal(y, y0)
    launches = [f.launches for f in (gn.group_norm_backward, gn.group_norm_stats,
                                     gn._bwd_cluster)]
    y.backward(dy)
    # One cluster launch from the forward's saved statistics; no relaunch.
    assert [f.launches for f in (gn.group_norm_backward, gn.group_norm_stats,
                                 gn._bwd_cluster)] == [launches[0] + 1, launches[1],
                                                       launches[2] + 1]
    x, w, b, p = plain
    film = tuple(p.chunk(2, dim=1))
    coeffs = gn.group_norm_coeffs_plain(x, groups, w, b, 1e-5, film)
    gn.group_norm_apply_plain(x, *coeffs, True).backward(dy)
    for k, v in zip(kernel, plain):
        assert k.grad.dtype == v.grad.dtype
        if k.ndim == 3:
            assert _rel_err(k.grad, v.grad) <= tol
        else:
            scale = v.grad.float().abs().max().item()
            assert (k.grad.float() - v.grad.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(16, 64, 64000), (16, 128, 64000), (16, 512, 250)])
def test_group_norm_training_grads_match_plain_autograd(cuda_gen, dtype, tol, shape):
    """A training step's GroupNorm: x, the float32 affine and the FiLM pair
    (the halves of a ResBlock's cond_proj of the step's embedding, in the
    compute dtype) all require grad, with GELU, at the flagship's training
    shapes (the unet128 encoder's and unet64's first levels, two and four
    channels a group, and a deep level). Through GroupNormFunction, every
    gradient down to the projection's float32 weight and bias and the
    embedding is autograd's through the plain versions, within the
    dtype's tolerance of its largest entry."""
    n, c, _ = shape
    groups, emb_ch = 32, 256
    x0 = (torch.randn(shape, generator=cuda_gen, device="cuda") + 0.5).to(dtype)
    w0 = torch.rand(c, generator=cuda_gen, device="cuda") + 0.5
    b0 = 0.1 * torch.randn(c, generator=cuda_gen, device="cuda")
    pw0 = torch.randn(2 * c, emb_ch, generator=cuda_gen, device="cuda") / emb_ch ** 0.5
    pb0 = 0.1 * torch.randn(2 * c, generator=cuda_gen, device="cuda")
    emb0 = torch.randn(n, emb_ch, generator=cuda_gen, device="cuda").to(dtype)
    dy = torch.randn(shape, generator=cuda_gen, device="cuda").to(dtype)

    def grads(kernel: bool):
        x, w, b, pw, pb, emb = (v.clone().requires_grad_() for v in (x0, w0, b0, pw0, pb0, emb0))
        film = tuple(torch.nn.functional.linear(torch.nn.functional.gelu(emb), pw.to(dtype),
                                                pb.to(dtype)).chunk(2, dim=-1))
        if kernel:
            y = gn.group_norm(x, w, b, groups, 1e-5, True, film)
            assert "GroupNormFunction" in type(y.grad_fn).__name__
        else:
            coeffs = gn.group_norm_coeffs_plain(x, groups, w, b, 1e-5, film)
            y = gn.group_norm_apply_plain(x, *coeffs, True)
        y.backward(dy)
        return [v.grad for v in (x, w, b, pw, pb, emb)]

    launches = gn.group_norm_backward.launches
    got = grads(True)
    assert gn.group_norm_backward.launches > launches
    want = grads(False)
    assert _rel_err(got[0], want[0]) <= tol
    for g, v in zip(got, want):
        assert g.dtype == v.dtype and g.shape == v.shape
        scale = v.float().abs().max().item()
        assert scale > 0
        assert (g.float() - v.float()).abs().max().item() <= tol * scale
    for buf in ticket_buffers():
        assert not buf.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(16, 128, 64000), (2, 64, 3000)])
def test_group_norm_add_classes_regime_matches_plain_autograd(cuda_gen, dtype, tol, shape):
    """The add-classes fine-tuning regime: x and the float32 affine frozen
    (no grad), only the FiLM pair (driven by the trained label embedding)
    requiring grad, FiLM + GELU. Through GroupNormFunction, dca and dcb are
    autograd's through the plain versions within the dtype's tolerance of
    their largest entry."""
    n, c, _ = shape
    groups = 32
    x = (torch.randn(shape, generator=cuda_gen, device="cuda") + 0.5).to(dtype)
    w = torch.rand(c, generator=cuda_gen, device="cuda") + 0.5
    b = 0.1 * torch.randn(c, generator=cuda_gen, device="cuda")
    ca0, cb0 = (0.3 * torch.randn(n, c, generator=cuda_gen, device="cuda")).to(dtype), \
        (0.3 * torch.randn(n, c, generator=cuda_gen, device="cuda")).to(dtype)
    dy = torch.randn(shape, generator=cuda_gen, device="cuda").to(dtype)

    def grads(kernel: bool):
        ca, cb = ca0.clone().requires_grad_(), cb0.clone().requires_grad_()
        if kernel:
            y = gn.group_norm(x, w, b, groups, 1e-5, True, (ca, cb))
            assert "GroupNormFunction" in type(y.grad_fn).__name__
        else:
            coeffs = gn.group_norm_coeffs_plain(x, groups, w, b, 1e-5, (ca, cb))
            y = gn.group_norm_apply_plain(x, *coeffs, True)
        y.backward(dy)
        return ca.grad, cb.grad

    launches = gn.group_norm_backward.launches
    got = grads(True)
    assert gn.group_norm_backward.launches > launches
    for g, v in zip(got, grads(False)):
        assert g.dtype == v.dtype == dtype and g.shape == v.shape == (n, c)
        scale = v.float().abs().max().item()
        assert scale > 0 and (g.float() - v.float()).abs().max().item() <= tol * scale
    assert not x.requires_grad and not w.requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1000, 16000])
def test_vq_kernel_matches_plain_at_wavegrad_width(cuda_gen, rows):
    """The WaveGrad VQ-VAE's codes: 512 channels, 512 codes, 16000 rows at
    batch 16 x 4 s: within the tie criterion of the plain version, the same
    bits twice, the used mask the picked codes."""
    d = torch.randn(512, 512, generator=cuda_gen, device="cuda")
    x = torch.randn(rows, 512, generator=cuda_gen, device="cuda")
    idx, used = vqa.vq_assign(d, x)
    idx2, used2 = vqa.vq_assign(d, x)
    assert torch.equal(idx, idx2) and torch.equal(used, used2)
    pidx, _ = vqa.vq_assign_plain(d, x)
    for i in torch.nonzero(idx != pidx).flatten().tolist():
        a = ((x[i].double() - d[idx[i]].double()) ** 2).sum()
        b = ((x[i].double() - d[pidx[i]].double()) ** 2).sum()
        assert (a - b).abs() <= 1e-6 * torch.maximum(a, b), i
    mask = torch.zeros_like(used)
    mask[idx.long()] = 1
    assert torch.equal(used, mask)


def _seeded(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every layer live: weights ~ N(0, 1/fan_in), norm scales near 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.ndim >= 2:
                p.copy_(noise / p[0].numel() ** 0.5)
            elif "norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)
    return model


@pytest.mark.cuda
def test_classifier_train_step_on_the_card_matches_the_cpu(cuda_gen):
    """A classifier NLL forward and backward at base 4 (55 GroupNorms, f32,
    TF32 off) on the card, through the GroupNorm kernels, against the CPU's
    plain versions: the loss within 1e-4 relative, each gradient leaf within
    1e-3 of its largest entry plus 1e-6 of the largest gradient."""
    from vq_voice_swap_torch.classifier_model import ClassifierModel

    model = _seeded(ClassifierModel(num_labels=3, base_channels=4), 1)
    gen = torch.Generator().manual_seed(2)
    x = 0.5 * torch.tanh(torch.randn(2, 1024, 1, generator=gen))
    ts, labels = torch.tensor([0.2, 0.7]), torch.tensor([2, 0])

    def step(device):
        m = copy.deepcopy(model).to(device)
        logp = torch.nn.functional.log_softmax(m(x.to(device), ts.to(device)), dim=-1)
        loss = -torch.gather(logp, -1, labels.to(device)[:, None]).mean()
        loss.backward()
        return loss.item(), {n: p.grad.cpu() for n, p in m.named_parameters()}

    launches = gn.group_norm_backward.launches
    loss, grads = step(torch.device("cuda"))
    assert gn.group_norm_backward.launches > launches + 50
    want_loss, want = step(torch.device("cpu"))
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    top = max(g.abs().max().item() for g in want.values())
    for n, w in want.items():
        assert (grads[n] - w).abs().max().item() <= 1e-3 * w.abs().max().item() + 1e-6 * top, n


@pytest.mark.cuda
def test_wavegrad_forward_on_the_card_matches_the_cpu(cuda_gen):
    """The WaveGrad predictor (conditional, labelled) and encoder at base 4,
    f32 with TF32 off, on the card against the CPU within 1e-4."""
    from vq_voice_swap_torch.models.wavegrad import WaveGradEncoder, WaveGradPredictor

    gen = torch.Generator().manual_seed(3)
    x = 0.5 * torch.tanh(torch.randn(2, 2048, 1, generator=gen))
    cond = torch.randn(2, 32, 16, generator=gen)
    ts, labels = torch.tensor([0.3, 0.8]), torch.tensor([1, 2])
    predictor = _seeded(WaveGradPredictor(4, 4, num_labels=3), 4)
    encoder = _seeded(WaveGradEncoder(4, 4), 5)
    with torch.no_grad():
        want = (predictor(x, ts, cond, labels), encoder(x))
        predictor, encoder = predictor.cuda(), encoder.cuda()
        got = (predictor(x.cuda(), ts.cuda(), cond.cuda(), labels.cuda()), encoder(x.cuda()))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item())


@pytest.mark.cuda
def test_classifier_features_on_the_card_match_the_cpu(cuda_gen):
    """stat_generate's features and probabilities (base 4, 55 GroupNorms,
    f32, TF32 off) on the card against the CPU within 1e-4 of their largest
    entry."""
    from vq_voice_swap_torch import stat_generate
    from vq_voice_swap_torch.classifier_model import ClassifierModel

    model = _seeded(ClassifierModel(num_labels=5, base_channels=4), 6)
    gen = torch.Generator().manual_seed(7)
    x = 0.5 * torch.tanh(torch.randn(3, 64000, generator=gen))
    with torch.no_grad():
        want = stat_generate.featurize(model, x)
        launches = gn.group_norm_apply.launches
        got = stat_generate.featurize(model.cuda(), x.cuda())
    assert gn.group_norm_apply.launches == launches + 55
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * w.abs().max().item()


def _write_wav(path, samples, rate=16000):
    import wave

    import numpy as np

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(samples, -1, 1) * (2**15 - 1)).astype("<i2").tobytes())


@pytest.mark.cuda
def test_window_gather_built_here_matches_numpy(cuda_gen, tmp_path):
    """The window cache's C gather, built on this machine, against its numpy
    loop bit for bit (a 22050 Hz file among the cached ones)."""
    import numpy as np

    from vq_voice_swap_torch.data.cache import WindowCache
    from vq_voice_swap_torch.data.native import batch_gather_windows_plain

    rng = np.random.RandomState(0)
    paths = []
    for i, rate in enumerate((16000, 22050, 16000)):
        paths.append(str(tmp_path / f"{i}.wav"))
        _write_wav(paths[-1], 0.2 * rng.randn(int(rate * 4.5)), rate)
    cache = WindowCache(str(tmp_path / "cache"))
    cache.build(paths)
    refs = [(p, off) for p in paths for off in (0, 3200, 9600, 70000)]
    got = cache.read_windows(refs, 64000)
    assert got.shape == (12, 64000) and got[0].any()
    np.testing.assert_array_equal(
        got, cache.read_windows(refs, 64000, gather=batch_gather_windows_plain))


@pytest.mark.cuda
def test_stat_generate_on_the_card(cuda_gen, tmp_path):
    """stat_generate --device cuda over a tiny LibriSpeech-style directory:
    8 windows through the loader, finite statistics of the right shapes."""
    import numpy as np

    from vq_voice_swap_torch import stat_generate
    from vq_voice_swap_torch.classifier_model import ClassifierModel

    ckpt = str(tmp_path / "classifier.npz")
    _seeded(ClassifierModel(num_labels=2, base_channels=4), 8).save(ckpt)
    rng = np.random.RandomState(1)
    for spk in ("a", "b"):
        _write_wav(str(tmp_path / "ds" / spk / "1" / "u.wav"), 0.2 * rng.randn(72000))
    out = str(tmp_path / "stats.npz")
    stat_generate.main(["--checkpoint-path", ckpt, "--data-dir", str(tmp_path / "ds"),
                        "--num-samples", "6", "--batch-size", "4", "--device", "cuda", out])
    with np.load(out) as stats:
        assert stats["mean"].shape == (64,) and stats["cov"].shape == (64, 64)
        assert stats["probs"].shape == (6, 2)
        assert all(np.isfinite(stats[k]).all() for k in stats.files)


@pytest.mark.cuda
def test_kernels_captured_in_a_cuda_graph_replay_as_eager_launches(cuda_gen):
    """The GroupNorm forward and backward (GroupNormFunction: the statistics,
    apply and cluster backward kernels) and VQ assign captured in one CUDA
    graph, replayed 3 times on new inputs copied into its static ones: each
    replay's outputs are the eager launches' bits, the wrappers count the
    capture and not the replays, and every ticket counter is 0 after."""
    shape, groups = (2, 64, 3000), 32
    x0, w, b, _ = _coeffs_case(cuda_gen, shape, torch.float32, False)
    ca = torch.randn(2, 64, generator=cuda_gen, device="cuda")
    cb = torch.randn(2, 64, generator=cuda_gen, device="cuda")
    d = torch.randn(512, 1024, generator=cuda_gen, device="cuda")

    def inputs():
        return (torch.randn(shape, generator=cuda_gen, device="cuda") + 1.0,
                torch.randn(shape, generator=cuda_gen, device="cuda"),
                torch.randn(3201, 1024, generator=cuda_gen, device="cuda"))

    def run(x, dy, rows):
        x = x.detach().requires_grad_()
        y = gn.group_norm(x, w, b, groups, 1e-5, True, (ca, cb))
        (dx,) = torch.autograd.grad(y, x, dy)
        return (y.detach(), dx, *vqa.vq_assign(d, rows))

    static = inputs()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # builds this stream's ticket buffer
        run(*static)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    launches = [f.launches for f in (gn.group_norm_coeffs, gn.group_norm_apply,
                                     gn.group_norm_backward, vqa.vq_assign)]
    with torch.cuda.graph(graph, stream=stream):
        outs = run(*static)
    assert [f.launches for f in (gn.group_norm_coeffs, gn.group_norm_apply,
                                 gn.group_norm_backward, vqa.vq_assign)] == [
        n + 1 for n in launches]
    for _ in range(3):
        new = inputs()
        for s, v in zip(static, new):
            s.copy_(v)
        graph.replay()
        want = run(*new)
        for got, ref in zip(outs, want):
            assert torch.equal(got, ref)
    assert [f.launches for f in (gn.group_norm_coeffs, gn.group_norm_apply,
                                 gn.group_norm_backward, vqa.vq_assign)] == [
        n + 4 for n in launches]
    torch.cuda.synchronize()
    for buf in ticket_buffers():
        assert not buf.any()


def _vqvae_train_step(model):
    """A TrainStep of the VQ-VAE loop's loss, drawer, codebook rule (revival
    on) and one EMA, on a copy of ``model``."""
    import types

    from vq_voice_swap_torch.train import EMA, TrainStep, VQUpdateRule, VQVAETrainLoop
    from vq_voice_swap_torch.train.state import build_optimizer
    from vq_voice_swap_torch.vq import VQLossConfig

    m = copy.deepcopy(model)
    stub = types.SimpleNamespace(
        model=m, args=types.SimpleNamespace(class_cond=True, jitter=0.1),
        vq_loss_config=lambda: VQLossConfig())
    opt = build_optimizer(m, lr=1e-3, lr_final=1e-4, lr_anneal_steps=8, grad_clip=1.0)
    return TrainStep(m, VQVAETrainLoop.build_loss_fn(stub), opt, [EMA(m, 0.9)],
                     microbatches=2, vq_rule=VQUpdateRule(dead_rate=2, revive=True),
                     drawer=VQVAETrainLoop.build_drawer(stub))


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms (cuDNN's, and sorted index
    accumulation in place of atomics) during the test."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    yield
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    torch.backends.cudnn.deterministic = saved[2]


@pytest.mark.cuda
def test_graphed_train_step_is_the_eager_step_bit_for_bit(cuda_gen, deterministic):
    """Four VQ-VAE train steps (base 4, dropout, jitter, two microbatches,
    the LR anneal and the clip, codes dying and revived), the forwards and
    backward replayed from a CUDA graph, against the eager steps on the
    same generators, with deterministic algorithms: the same losses and
    codebook_used, and every parameter, EMA, usage count and AdamW moment
    the same bits; the ticket counters 0 after."""
    from vq_voice_swap_torch.train.graphs import GraphedTrainStep
    from vq_voice_swap_torch.util import step_generator
    from vq_voice_swap_torch.vq_vae import VQVAE

    model = _seeded(VQVAE(pred_name="unet", base_channels=4, enc_name="unet", num_labels=3,
                          dictionary_size=16, dead_rate=2, dropout=0.1), 6).cuda()
    batches = [{"samples": 0.5 * torch.tanh(torch.randn(4, 2048, generator=cuda_gen,
                                                         device="cuda")),
                "label": torch.tensor([0, 1, 2, 1], device="cuda")} for _ in range(4)]
    eager, graphed = _vqvae_train_step(model), _vqvae_train_step(model)
    runner = GraphedTrainStep(graphed)
    launches = gn.group_norm_coeffs.launches
    got, want = [], []
    for i, batch in enumerate(batches):
        want.append(eager(batch, step_generator(0, i, torch.device("cuda"))))
        got.append(runner(batch, step_generator(0, i, torch.device("cuda"))))
    per_forward = sum(type(m).__name__ == "ResBlock" for m in model.modules()) * 2 + 2
    # Eager: 4 steps of 2 forwards; graphed: the warm-up and the capture.
    assert gn.group_norm_coeffs.launches - launches == (8 + 2 * 3) * per_forward
    for g, w in zip(got, want):
        assert torch.equal(g["loss"], w["loss"]) and torch.equal(g["mses"], w["mses"])
        assert g["codebook_used"].item() == w["codebook_used"].item()
    assert min(w["codebook_used"].item() for w in want) < 16  # revival ran
    for a, b in ((graphed.model, eager.model), (graphed.emas[0].model, eager.emas[0].model)):
        for (k, v), (_, u) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(v, u), k
    for p, q in zip(graphed.optimizer.params, eager.optimizer.params):
        for k, v in eager.optimizer.adamw.state[q].items():
            assert torch.equal(graphed.optimizer.adamw.state[p][k], v), k
    assert graphed.optimizer.count == eager.optimizer.count == 4
    torch.cuda.synchronize()
    for buf in ticket_buffers():
        assert not buf.any()


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["full", "convs"])
def test_grad_checkpoint_on_the_card_gives_the_gradients(cuda_gen, deterministic, policy):
    """A VQ-VAE training forward and backward at base 4 with dropout, f32
    (TF32 off), through the GroupNorm kernels, with deterministic
    algorithms (atomic adds would give a conv bias before a GroupNorm, whose
    true gradient is 0, other rounding noise each run): remat against none
    within 1e-5 of each gradient leaf's largest entry plus 1e-7 of the
    largest gradient; the recompute relaunches each ResBlock's two
    GroupNorms and the backward launches stay one per GroupNorm."""
    from vq_voice_swap_torch.vq_vae import VQVAE

    model = _seeded(VQVAE(pred_name="unet", base_channels=4, enc_name="unet", num_labels=3,
                          dropout=0.1), 7).cuda()
    x = 0.5 * torch.tanh(torch.randn(2, 2048, 1, generator=cuda_gen, device="cuda"))
    blocks = sum(type(m).__name__ == "ResBlock" for m in model.modules())

    def grads(remat):
        model.set_remat(remat)
        model.zero_grad(set_to_none=True)
        launches = (gn.group_norm_coeffs.launches, gn.group_norm_backward.launches)
        out = model.losses(x, labels=torch.tensor([0, 2], device="cuda"), train=True,
                           jitter=0.1, generator=torch.Generator("cuda").manual_seed(3))
        (out["mse"] + out["vq_loss"]).backward()
        counts = (gn.group_norm_coeffs.launches - launches[0],
                  gn.group_norm_backward.launches - launches[1])
        return {n: p.grad.clone() for n, p in model.named_parameters()}, counts

    want, (fwd, bwd) = grads(None)
    got, counts = grads(policy)
    assert counts == (fwd + 2 * blocks, bwd)
    top = max(g.abs().max().item() for g in want.values())
    for n, w in want.items():
        err = (got[n] - w).abs().max().item()
        assert err <= 1e-5 * w.abs().max().item() + 1e-7 * top, (n, err)


def _vqvae_steps(mode: str, state, batch, steps: int, remat=False):
    """``steps`` VQ-VAE train steps (chunks 2 + 1, revival, the clip, one
    EMA) as one process ("plain"), or as world size 1 of the default
    process group, DP ("dp") or FSDP ("fsdp"): the losses and the final
    parameters, EMA and usage counts, whole."""
    import types

    from vq_voice_swap_torch.parallel import (GradBuffer, StepSync, full_tensor,
                                              shard_model_fsdp, shard_optimizer_like,
                                              shard_params_like)
    from vq_voice_swap_torch.train import (EMA, TrainStep, VQUpdateRule, VQVAETrainLoop,
                                           build_optimizer)
    from vq_voice_swap_torch.util import step_generator
    from vq_voice_swap_torch.vq import VQLossConfig
    from vq_voice_swap_torch.vq_vae import VQVAE

    model = VQVAE(pred_name="unet", base_channels=8, enc_name="unet", cond_mult=4,
                  dictionary_size=32, num_labels=3, dead_rate=4)
    model.load_state_dict(state)
    model.set_remat(remat)
    model = model.cuda()
    opt = build_optimizer(model, lr=1e-3, grad_clip=0.5)
    ema = EMA(model, 0.9)
    sync = None
    if mode == "fsdp":
        names = {id(p): n for n, p in model.named_parameters()}
        opt_names = [names[id(p)] for p in opt.params]
        shard_model_fsdp(model, 1)
        shard_params_like(ema.model, model)
        opt = shard_optimizer_like(opt, [model.get_parameter(n) for n in opt_names])
    if mode != "plain":
        opt.grad_buffer = GradBuffer(opt.params)
        sync = StepSync(opt.grad_buffer)
    args = types.SimpleNamespace(class_cond=True, jitter=0.1)
    stub = types.SimpleNamespace(model=model, args=args,
                                 vq_loss_config=lambda: VQLossConfig(commitment=0.25))
    step = TrainStep(model, VQVAETrainLoop.build_loss_fn(stub), opt, [ema], microbatches=1,
                     micro_remainder=1, vq_rule=VQUpdateRule(dead_rate=4, revive=True),
                     drawer=VQVAETrainLoop.build_drawer(stub), sync=sync)
    losses = [step(batch, step_generator(0, i, torch.device("cuda")))["loss"].item()
              for i in range(steps)]
    whole = {n: full_tensor(p).detach().clone() for n, p in model.named_parameters()}
    shadow = {n: full_tensor(p).detach().clone() for n, p in ema.model.named_parameters()}
    return losses, whole, shadow, model.vq.usage_count.clone()


@pytest.mark.cuda
def test_world_size_one_steps_match_the_plain_step(cuda_gen):
    """A launched run of one rank (NCCL) takes the one-process step's bits
    under deterministic algorithms; FSDP at world size 1, and FSDP with
    --grad-checkpoint full (its recompute all-gathers again), within
    float32 rounding of it."""
    import socket

    import torch.distributed as dist

    from vq_voice_swap_torch.vq_vae import VQVAE

    init = VQVAE(pred_name="unet", base_channels=8, enc_name="unet", cond_mult=4,
                 dictionary_size=32, num_labels=3, dead_rate=4)
    state = {k: v.clone() for k, v in init.state_dict().items()}
    state["vq.usage_count"] = torch.tensor([1, 2] * 16, dtype=torch.int32)
    batch = {"samples": 0.5 * torch.randn(3, 8192, generator=cuda_gen, device="cuda"),
             "label": torch.tensor([0, 1, 2], device="cuda")}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        plain = _vqvae_steps("plain", state, batch, 3)
        dp = _vqvae_steps("dp", state, batch, 3)
        fsdp = _vqvae_steps("fsdp", state, batch, 3)
        remat = _vqvae_steps("fsdp", state, batch, 3, remat="full")
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    assert dp[0] == plain[0]
    for got, want in zip(dp[1:], plain[1:]):
        if isinstance(want, dict):
            for n in want:
                assert torch.equal(got[n], want[n]), n
        else:
            assert torch.equal(got, want)
    for run in (fsdp, remat):
        torch.testing.assert_close(torch.tensor(run[0]), torch.tensor(plain[0]), rtol=1e-5,
                                   atol=0)
        assert torch.equal(run[3], plain[3])
        for got, want in zip(run[1:3], plain[1:3]):
            for n in want:
                scale = want[n].abs().max().clamp(min=1e-6)
                assert ((got[n] - want[n]).abs().max() / scale).item() <= 1e-2, n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_stats_above_2_pow_24(cuda_gen, dtype):
    """One group of 4 x 4300000 = 17.2 M elements, where a float32 count
    stops being exact: (mean, var) and the folded coefficients against the
    float64 statistics, and the apply kernel against its plain version."""
    shape = (1, 4, 4_300_000)
    x = (torch.randn(shape, generator=cuda_gen, device="cuda") + 0.5).to(dtype)
    x64 = x.double().reshape(1, 1, -1)
    mean64 = x64.mean(dim=-1)
    var64 = torch.square(x64 - mean64[..., None]).mean(dim=-1)
    mean, var = gn.group_norm_stats(x, 1)
    torch.testing.assert_close(mean.double(), mean64, atol=1e-5, rtol=0)
    torch.testing.assert_close(var.double(), var64, atol=0, rtol=1e-4)
    w = torch.rand(4, generator=cuda_gen, device="cuda") + 0.5
    b = torch.randn(4, generator=cuda_gen, device="cuda")
    folded = gn.fold_affine(mean64.float(), var64.float(), w, b, 1e-5)
    coeffs = gn.group_norm_coeffs(x, 1, w, b, 1e-5)
    for k, p in zip(coeffs, folded):
        torch.testing.assert_close(k, p, atol=1e-4, rtol=1e-4)
    got = gn.group_norm_apply(x, *coeffs, True).float()
    want = gn.group_norm_apply_plain(x, *folded, True).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert ((got - want).abs() / want.abs().clamp(min=1.0)).max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,groups", [((2, 128, 64000), 32), ((3, 20, 334), 4)])
@pytest.mark.parametrize("film", [False, True])
def test_group_norm_split_backward_matches_unsharded(cuda_gen, dtype, tol, shape, groups, film):
    """The sequence-parallel backward with its all-reduce simulated: the
    reduce kernel on each of two shards along T, their partials summed,
    then the dx kernel on each shard with the whole group's count, against
    the unsharded backward (plain), GELU on; one launch of each per shard."""
    n, c, t = shape
    x = (torch.randn(shape, generator=cuda_gen, device="cuda") + 0.5).to(dtype)
    dy = torch.randn(shape, generator=cuda_gen, device="cuda").to(dtype)
    w = 1.0 + 0.2 * torch.randn(c, generator=cuda_gen, device="cuda")
    b = 0.2 * torch.randn(c, generator=cuda_gen, device="cuda")
    ab = None
    if film:
        ab = tuple((0.5 * torch.randn(n, 2 * c, generator=cuda_gen, device="cuda")).to(dtype)
                   .chunk(2, dim=-1))
    stats = gn.group_norm_stats(x, groups)
    shards = [(u.contiguous(), v.contiguous())
              for u, v in zip(x.chunk(2, dim=-1), dy.chunk(2, dim=-1))]
    launches = (gn.group_norm_bwd_reduce.launches, gn.group_norm_bwd_dx.launches)
    parts = [gn.group_norm_bwd_reduce(u, v, groups, *stats, w, b, 1e-5, True, ab)
             for u, v in shards]
    s1, s2 = (torch.stack(p).sum(dim=0) for p in zip(*parts))
    dx = torch.cat([gn.group_norm_bwd_dx(u, v, groups, *stats, w, b, 1e-5, True, ab, s1, s2,
                                         c // groups * t) for u, v in shards], dim=-1)
    want = gn.group_norm_backward_plain(x, dy, groups, w, b, 1e-5, True, ab, stats)
    assert (dx.float() - want[0].float()).abs().max().item() <= tol * max(
        1.0, want[0].float().abs().max().item())
    for got_s, want_s in zip((s1, s2), want[1:]):
        assert ((got_s - want_s).abs().max() / want_s.abs().max()).item() <= 1e-4
    assert gn.group_norm_bwd_reduce.launches == launches[0] + 2
    assert gn.group_norm_bwd_dx.launches == launches[1] + 2


# ------------------------------------------------- the int8 serving path


def _qact():
    from vq_voice_swap_torch.ops import qact

    return qact


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kind", [((2, 64, 3000), "randn"), ((3, 5, 777), "randn"),
                                        ((1, 8, 1001), "zero"), ((1, 1, 256), "ties")])
def test_quantize_kernel_is_bit_equal_to_plain(cuda_gen, dtype, shape, kind):
    qact = _qact()
    if kind == "zero":
        x = torch.zeros(shape, device="cuda")
    elif kind == "ties":  # amax 127: scale 1, every value on a .5 boundary
        x = torch.arange(shape[-1], device="cuda", dtype=torch.float32).view(shape) - 127.5
        x[..., 0] = 127.0
    else:
        x = 3.0 * torch.randn(shape, generator=cuda_gen, device="cuda")
    x = x.to(dtype)
    launches = qact.quantize.launches
    got = qact.quantize(x)
    want = qact.quantize_plain(x)
    assert qact.quantize.launches == launches + 2
    assert got.scale.shape == () and got.scale.is_cuda and got.dtype == dtype
    assert torch.equal(got.scale, want.scale) and torch.equal(got.q, want.q)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,cin,cout,t,taps,dilation,per_channel,bias", [
    (2, 64, 64, 3000, 3, 1, False, True),
    (2, 64, 64, 3000, 3, 2, False, True),
    (1, 128, 64, 1000, 3, 2, False, False),
    (2, 128, 64, 999, 1, 1, True, True),
    (1, 8, 12, 1000, 3, 32, False, True),
    (3, 40, 70, 333, 3, 5, True, False),
    (1, 256, 128, 515, 3, 1, True, True),
    # Weights too large to stay in shared memory: each unit stages its slice.
    (2, 1024, 128, 512, 3, 2, False, False),
    (1, 1000, 64, 300, 3, 1, True, True),
    # Windows of more than 16 chunks of 16 positions (dilation 72).
    (1, 64, 64, 2048, 3, 72, False, False),
    (1, 8, 12, 1000, 3, 72, False, True),
])
def test_conv1d_int8_kernel_is_bit_equal_to_plain(cuda_gen, out_dtype, n, cin, cout, t, taps,
                                                  dilation, per_channel, bias):
    qact = _qact()
    x = torch.randn(n, cin, t, generator=cuda_gen, device="cuda")
    if per_channel:
        half = cin // 2
        qa = qact.qact_concat(qact.quantize(x[:, :half].contiguous()),
                              qact.quantize(40.0 * x[:, half:].contiguous()))
    else:
        qa = qact.quantize(x)
    qa = qact.QAct(qa.q, qa.scale, out_dtype)
    w = 0.2 * torch.randn(cout, cin, taps, generator=cuda_gen, device="cuda")
    b = 0.1 * torch.randn(cout, generator=cuda_gen, device="cuda") if bias else None
    launches = qact.conv1d_int8.launches
    got = qact.conv1d_int8(qa, w, b, dilation=dilation)
    kq, w_scale = qact.quantize_weight(w, qa.scale if per_channel else None)
    want = qact.conv1d_int8_plain(qa.q, kq, w_scale, None if per_channel else qa.scale, b, 1,
                                  dilation, out_dtype)
    torch.cuda.synchronize()
    assert qact.conv1d_int8.launches == launches + 1
    assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_conv1d_int8_refuses_what_the_kernel_does_not_take(cuda_gen):
    qact = _qact()
    qa = qact.quantize(torch.randn(1, 8, 100, generator=cuda_gen, device="cuda"))
    w = torch.randn(4, 8, 3, device="cuda")
    with pytest.raises(ValueError, match="stride"):
        qact.conv1d_int8(qa, w, None, stride=2)
    with pytest.raises(ValueError, match="shared memory"):
        qact.conv1d_int8(qa, w, None, dilation=5000)
    with pytest.raises(ValueError, match="taps"):
        qact.conv1d_int8(qa, torch.randn(4, 8, 5, device="cuda"), None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,per_channel", [
    ((2, 64, 3000), 32, False), ((2, 192, 1000), 32, True), ((3, 20, 333), 4, True),
    ((1, 4, 70001), 4, False)])
@pytest.mark.parametrize("use_gelu", [False, True])
def test_int8_group_norm_kernels_match_plain(cuda_gen, dtype, shape, groups, per_channel,
                                             use_gelu):
    qact = _qact()
    n, c, t = shape
    x = torch.randn(shape, generator=cuda_gen, device="cuda") + 0.5
    if per_channel:
        qa = qact.qact_concat(qact.quantize(x[:, :c // 2].contiguous()),
                              qact.quantize(9.0 * x[:, c // 2:].contiguous()))
    else:
        qa = qact.quantize(x)
    qa = qact.QAct(qa.q, qa.scale, dtype)
    w = torch.rand(c, generator=cuda_gen, device="cuda") + 0.5
    b = torch.randn(c, generator=cuda_gen, device="cuda")
    launches = (gn.group_norm_coeffs_int8.launches, gn.group_norm_apply_int8.launches)
    coeffs = gn.group_norm_coeffs_int8(qa.q, qa.scale, groups, w, b, 1e-5)
    want = gn.group_norm_coeffs_int8_plain(qa.q, qa.scale, groups, w, b, 1e-5)
    for k, p in zip(coeffs, want):
        torch.testing.assert_close(k, p, atol=1e-5, rtol=1e-4)
    got = gn.group_norm_apply_int8(qa.q, qa.scale, *want, use_gelu, dtype).float()
    ref = gn.group_norm_apply_plain(qact.dequantize(qa), *want, use_gelu).to(dtype).float()
    scale = 1.0 if dtype == torch.float32 else ref.abs().clamp(min=1.0)
    assert ((got - ref).abs() / scale).max().item() <= (1e-4 if dtype == torch.float32
                                                         else 2e-2)
    full = qact.qact_group_norm(qa, w, b, groups, 1e-5, use_gelu).float()
    plain = qact.qact_group_norm_plain(qa, w, b, groups, 1e-5, use_gelu).float()
    assert ((full - plain).abs() / scale).max().item() <= (1e-4 if dtype == torch.float32
                                                           else 2e-2)
    assert gn.group_norm_coeffs_int8.launches == launches[0] + 2
    assert gn.group_norm_apply_int8.launches == launches[1] + 2


def _int8_stats(q, scale, groups, w, b, slices=None):
    """The int8 statistics kernel's (mean, a, b, group mean, group var),
    its span cut into ``slices`` blocks (None: the wrapper's choice)."""
    if slices is None:
        return gn.group_norm_coeffs_int8(q, scale, groups, w, b, 1e-5, stats=True)
    n, c, _ = q.shape
    out = torch.empty((3, n, c), dtype=torch.float32, device=q.device)
    group = torch.empty((2, n, groups), dtype=torch.float32, device=q.device)
    gn._launch_stats(q, groups, out[0], out[1], out[2], out.stride(1), w, b, 1e-5, None, group,
                     scale, slices)
    return (*out, *group)


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in ulps of want rounded to float32."""
    w32 = want.float().abs()
    ulp = torch.nextafter(w32, torch.full_like(w32, float("inf"))) - w32
    return ((got.double() - want.double()).abs() / ulp.double()).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [None, 1, 7, gn.STATS_MAX_SLICES])
@pytest.mark.parametrize("shape,groups,per_channel", [
    ((2, 64, 3008), 32, False), ((2, 64, 3001), 32, False), ((2, 128, 1008), 32, True),
    ((3, 20, 333), 4, True)], ids=["per_tensor", "per_tensor_byte_loads", "per_channel",
                                   "per_channel_byte_loads"])
def test_int8_stats_kernel_matches_its_plain_version(cuda_gen, shape, groups, per_channel,
                                                     slices):
    """The int8 statistics kernel against group_norm_coeffs_int8_plain at
    several slice counts, on the 16-byte and the one-code-a-load paths:
    with one scale the group mean and var bit-equal (exact integer sums,
    the same float64 steps); with one a channel within one float32 ulp;
    a, b within 1e-6 relative (rsqrtf against torch.rsqrt)."""
    qact = _qact()
    n, c, t = shape
    x = torch.randn(shape, generator=cuda_gen, device="cuda") + 0.5
    if per_channel:
        qa = qact.qact_concat(qact.quantize(x[:, :c // 2].contiguous()),
                              qact.quantize(9.0 * x[:, c // 2:].contiguous()))
    else:
        qa = qact.quantize(x)
    w = torch.rand(c, generator=cuda_gen, device="cuda") + 0.5
    b = torch.randn(c, generator=cuda_gen, device="cuda")
    got = _int8_stats(qa.q, qa.scale, groups, w, b, slices)
    want = gn.group_norm_coeffs_int8_plain(qa.q, qa.scale, groups, w, b, 1e-5, True)
    torch.cuda.synchronize()
    for k, p in zip(got[3:], want[3:]):
        if per_channel:
            assert _ulps(k, p) <= 1.0
        else:
            assert torch.equal(k, p)
    assert torch.equal(got[0], want[0]) or per_channel
    for k, p in zip(got[:3], want[:3]):
        assert ((k - p).abs() / p.abs().clamp(min=1e-30)).max().item() <= 1e-6


@pytest.mark.cuda
def test_int8_stats_kernel_above_2_pow_24(cuda_gen):
    """One group of 4 x 4300000 = 17.2 M codes, all +-127, so that the sum
    of squares passes 2^32 (the 64-bit fold): bit-equal to the plain
    version, the same bits on a second run, and within one float32 ulp of
    float64 statistics of the dequantized codes."""
    shape = (1, 4, 4_300_000)
    q = (torch.randint(0, 2, shape, generator=cuda_gen, device="cuda") * 254 - 127).to(torch.int8)
    scale = torch.tensor(0.0123, device="cuda")
    w = torch.rand(4, generator=cuda_gen, device="cuda") + 0.5
    b = torch.randn(4, generator=cuda_gen, device="cuda")
    got = gn.group_norm_coeffs_int8(q, scale, 1, w, b, 1e-5, stats=True)
    again = gn.group_norm_coeffs_int8(q, scale, 1, w, b, 1e-5, stats=True)
    want = gn.group_norm_coeffs_int8_plain(q, scale, 1, w, b, 1e-5, True)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    x64 = q.double().reshape(1, 1, -1) * scale.double()
    mean64 = x64.mean(dim=-1)
    var64 = torch.square(x64 - mean64[..., None]).mean(dim=-1)
    assert _ulps(got[3], mean64) <= 1.0 and _ulps(got[4], var64) <= 1.0


def _fused_site(qact, site, dtype, shape, gen):
    """(fused call, the unfused card route's call, plain version, wrapper) of
    one quantize site on seeded inputs."""
    n, c, t = shape
    x = 3.0 * torch.randn(shape, generator=gen, device="cuda") + 0.5
    if site.endswith("per_channel"):
        qa = qact.qact_concat(qact.quantize(x[:, :c // 2].contiguous()),
                              qact.quantize(9.0 * x[:, c // 2:].contiguous()))
    else:
        qa = qact.quantize(x)
    qa = qact.QAct(qa.q, qa.scale, dtype)
    h = (torch.randn(shape, generator=gen, device="cuda") + 0.3).to(dtype)
    skip = (2.0 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    groups = 32 if c % 32 == 0 else 4
    w = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    b = 0.2 * torch.randn(c, generator=gen, device="cuda")
    film = tuple((0.5 * torch.randn(n, c, generator=gen, device="cuda")).to(dtype)
                 for _ in "ab")
    if site.startswith("norm_int8"):
        co = gn.group_norm_coeffs_int8(qa.q, qa.scale, groups, w, b, 1e-5)
        return (lambda: qact.quantize_group_norm(qa, *co, True),
                lambda: qact.quantize(gn.group_norm_apply_int8(qa.q, qa.scale, *co, True,
                                                               dtype)),
                lambda: qact.quantize_group_norm_plain(qa, *co, True), qact.quantize_group_norm)
    if site == "norm_float_film":
        co = gn.group_norm_coeffs(h, groups, w, b, 1e-5, film)
        return (lambda: qact.quantize_group_norm(h, *co, True),
                lambda: qact.quantize(gn.group_norm_apply(h, *co, True)),
                lambda: qact.quantize_group_norm_plain(h, *co, True), qact.quantize_group_norm)
    if site == "norm_float_no_gelu":
        co = gn.group_norm_coeffs(h, groups, w, b, 1e-5)
        return (lambda: qact.quantize_group_norm(h, *co, False),
                lambda: qact.quantize(gn.group_norm_apply(h, *co, False)),
                lambda: qact.quantize_group_norm_plain(h, *co, False), qact.quantize_group_norm)
    if site.startswith("residual_int8"):
        return (lambda: qact.quantize_residual(qa, h),
                lambda: qact.quantize(qact.dequantize(qa, dtype) + h),
                lambda: qact.quantize_residual_plain(qa, h), qact.quantize_residual)
    return (lambda: qact.quantize_residual(skip, h), lambda: qact.quantize(skip + h),
            lambda: qact.quantize_residual_plain(skip, h), qact.quantize_residual)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,site", [
    ((16, 64, 64000), "norm_int8"), ((16, 64, 64000), "norm_float_film"),
    ((16, 64, 64000), "residual_int8"), ((16, 64, 64000), "residual_float"),
    ((2, 128, 16000), "norm_int8_per_channel"), ((2, 128, 16000), "residual_int8_per_channel"),
    ((3, 20, 333), "norm_int8_per_channel"), ((3, 20, 333), "norm_float_no_gelu"),
    ((3, 20, 333), "residual_int8_per_channel"), ((1, 8, 1001), "residual_float")])
def test_fused_quantize_matches_the_unfused_route(cuda_gen, dtype, shape, site):
    """The quantize with its producer fused in against the unfused card
    route (the Triton apply or the eager add, then quantize): codes and
    scale bit for bit, two launches a call. Against its plain version
    (torch's GELU, which rounds otherwise than the kernels' erf, and
    unfused roundings): the scale within 1e-6, at most 1e-5 of the codes
    differing, by one step (the shares are printed)."""
    qact = _qact()
    fused, unfused, plain, wrapper = _fused_site(qact, site, dtype, shape, cuda_gen)
    launches = wrapper.launches
    got = fused()
    assert wrapper.launches == launches + 2
    route, want = unfused(), plain()
    torch.cuda.synchronize()
    for name, other in (("unfused route", route), ("plain", want)):
        print(f"{site} {shape} {dtype} against the {name}: codes that differ "
              f"{(got.q != other.q).float().mean().item():.3g}, scale bits equal "
              f"{torch.equal(got.scale, other.scale)}")
    assert got.dtype == dtype and got.scale.shape == () and got.q.shape == shape
    assert torch.equal(got.scale, route.scale) and torch.equal(got.q, route.q)
    torch.testing.assert_close(got.scale, want.scale, rtol=1e-6, atol=0)
    step = (got.q.int() - want.q.int()).abs()
    assert step.max().item() <= 1 and (step > 0).float().mean().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_then_upsample_is_upsample_then_quantize_on_card(cuda_gen, dtype):
    qact = _qact()
    x = torch.randn(4, 64, 8000, generator=cuda_gen, device="cuda").to(dtype)
    up = qact.qact_upsample(qact.quantize(x), 2)
    ref = qact.quantize(torch.repeat_interleave(x, 2, dim=-1))
    assert torch.equal(up.q, ref.q) and torch.equal(up.scale, ref.scale)


# ------------------------------------------------ the bf16 convolution (ops/conv1d.py)


def _conv_case(gen, n, cin, cout, taps, t):
    x = torch.randn(n, cin, t, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(cout, cin, taps, generator=gen, device="cuda") / math.sqrt(cin * taps)
    b = 0.5 * torch.randn(cout, generator=gen, device="cuda")
    return x, w, b


def _conv_kernel(x, w, b, dilation):
    """One launch of the kernel at any shape it takes, the route's rule
    aside."""
    layout, b32 = c1._prepare(w, b)
    out = torch.empty((x.shape[0], w.shape[0], x.shape[2]), dtype=torch.bfloat16,
                      device=x.device)
    assert c1._launch(x, layout, b32, out, dilation, x.device.index) == 0
    return out


def _assert_conv_close(got, x, w, b, dilation):
    """got against the float32 convolution of the same bf16 inputs (TF32
    off) plus the bf16 bias, rounded once to bf16: within one bf16 ulp of
    that value, plus four times the float32 summation bound of Cin * taps + 1
    terms (n 2^-24 of the sum of the terms' magnitudes): the kernel and
    cuDNN sum the same exact products in float32 in different orders. At
    least 99% of the elements equal the reference's bits."""
    taps = w.shape[-1]
    wb, bb = w.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    pad = (taps - 1) * dilation // 2
    ref = F.conv1d(x.float(), wb, bb, padding=pad, dilation=dilation)
    mag = F.conv1d(x.float().abs(), wb.abs(), bb.abs(), padding=pad, dilation=dilation)
    want = ref.to(torch.bfloat16)
    _, e = torch.frexp(want.float())
    ulp = torch.where(want == 0, 0.0, torch.ldexp(torch.ones_like(ref), e - 8))
    bound = ulp + 4 * (x.shape[1] * taps + 1) * 2.0 ** -24 * mag
    err = (got.float() - want.float()).abs()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool((err <= bound).all()), (err - bound).max().item()
    assert (got == want).float().mean().item() >= 0.99


def _swap_model():
    """The swap model's shapes (unet64 predictor with 1024-channel codes and
    251 labels, conv-MFCC encoder) in bf16, seeded."""
    from vq_voice_swap_torch.vq_vae import VQVAE

    gen = torch.Generator().manual_seed(21)
    model = VQVAE(64, enc_name="conv-mfcc-ulaw", pred_name="unet", num_labels=251,
                  dtype="bfloat16")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p[0].numel())
                    if p.ndim >= 2 else 0.1 * torch.randn(p.shape, generator=gen))
    return model.cuda().eval()


def _routed_calls(model, fn):
    """fn() with a hook on every Conv1d of ``model``: the (Cin, Cout, taps,
    dilation, T) of each call the rule routes to the kernel, in call
    order."""
    calls = []

    def hook(m, args):
        x = args[0]
        if isinstance(x, torch.Tensor):
            recording = torch.is_grad_enabled() and (
                x.requires_grad or m.conv.weight.requires_grad)
            if c1.routes(x.device.type, x.dtype, recording, x.shape,
                         x.is_contiguous(), m.conv):
                cout, cin, taps = m.conv.weight.shape
                calls.append((cin, cout, taps, m.conv.dilation[0], x.shape[2]))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, layers.Conv1d)]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return calls


def _predict(model, n, gen):
    x = torch.randn(n, 64000, 1, generator=gen, device="cuda")
    ts = torch.full((n,), 0.5, device="cuda")
    cond = torch.randn(n, 200, 1024, generator=gen, device="cuda")
    labels = torch.arange(n, device="cuda")
    return lambda: model.predict_eps(x, ts, cond, labels)


@pytest.mark.cuda
def test_conv1d_bf16_matches_reference_at_every_routed_shape(cuda_gen):
    """Every shape the swap model's predictor and encoder route to the
    kernel at 4 s, at batch 2, against the float32 reference."""
    model = _swap_model()
    with torch.no_grad():
        calls = _routed_calls(model, _predict(model, 1, cuda_gen))
        clip = torch.randn(1, 64000, 1, generator=cuda_gen, device="cuda")
        encoder_calls = _routed_calls(model, lambda: model.encode(clip))
    shapes = sorted(set(calls + encoder_calls))
    print(f"{len(calls)} routed predictor calls, {len(encoder_calls)} encoder calls, "
          f"{len(shapes)} shapes: {shapes}")
    assert len(calls) >= 70 and len(shapes) >= 25  # 72 and 30 with Cin up to 192
    for cin, cout, taps, dilation, t in shapes:
        x, w, b = _conv_case(cuda_gen, 2, cin, cout, taps, t)
        got = c1.conv1d_bf16(x, w, b, dilation)
        _assert_conv_close(got, x, w, b, dilation)
        del x, got
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("n,cin,cout,taps,dilation,t", [
    (3, 1, 64, 3, 1, 4000),       # Cin 1 (in_conv)
    (3, 64, 1, 3, 1, 4000),       # Cout 1 (out_conv)
    (2, 192, 64, 3, 1, 1000),     # concat widths
    (2, 192, 64, 1, 1, 1000),
    (2, 384, 128, 3, 1, 1000),
    (2, 384, 128, 1, 1, 1000),
    (2, 64, 64, 3, 32, 3000),     # a dilation of 32
    (2, 64, 96, 3, 100, 1000),    # a halo of 200 positions, wider than a tile
    (2, 48, 70, 3, 2, 200),       # T not a multiple of the 128-position tile
    (1, 64, 64, 3, 2, 64000),     # batch 1
    (2, 20, 130, 1, 1, 8),        # one chunk of T, Cin and Cout padded
    (2, 1024, 64, 1, 1, 200),     # 1 tap, a weight slice a stage
    (2, 512, 256, 3, 2, 1000),    # 3 taps, a weight slice a stage
    (2, 200, 70, 3, 1, 1000),     # ... and a last stage of 16 channels
])
def test_conv1d_bf16_kernel_matches_reference(cuda_gen, n, cin, cout, taps, dilation, t):
    x, w, b = _conv_case(cuda_gen, n, cin, cout, taps, t)
    launches = c1.conv1d_bf16.launches
    got = _conv_kernel(x, w, b, dilation)
    _assert_conv_close(got, x, w, b, dilation)
    if c1.fits(cin, cout, taps, 1, (taps - 1) * dilation // 2, dilation, 1, t):
        assert torch.equal(c1.conv1d_bf16(x, w, b, dilation), got)
        assert c1.conv1d_bf16.launches == launches + 1
    no_bias = _conv_kernel(x, w, None, dilation)
    _assert_conv_close(no_bias, x, w, torch.zeros_like(b), dilation)


@pytest.mark.cuda
def test_conv1d_bf16_same_bits_twice_and_in_a_cuda_graph(cuda_gen):
    """Two eager calls give the same bits; the calls captured in a CUDA
    graph and replayed on new inputs give the eager calls' bits."""
    m = torch.nn.Conv1d(64, 64, 3, dilation=2, padding=2).cuda()
    shape = (4, 64, 16000)
    static = torch.randn(shape, generator=cuda_gen, device="cuda").to(torch.bfloat16)

    def run(x):
        return c1.conv1d_bf16(x, m.weight, m.bias, 2, m)

    first = run(static)
    assert torch.equal(run(static), first)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run(static)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    launches = c1.conv1d_bf16.launches
    with torch.cuda.graph(graph, stream=stream):
        out = run(static)
    assert c1.conv1d_bf16.launches == launches + 1
    for _ in range(3):
        new = torch.randn(shape, generator=cuda_gen, device="cuda").to(torch.bfloat16)
        static.copy_(new)
        graph.replay()
        assert torch.equal(out, run(new))
    del graph


@pytest.mark.cuda
def test_conv1d_bf16_route_under_inference_mode(cuda_gen):
    """A layer made and run under ``torch.inference_mode`` (the eval CLIs
    load their models so) takes the kernel route, its weight made each
    call: the bits of the same layer under ``no_grad``."""
    with torch.inference_mode():
        m = layers.Conv1d(64, 64, 3, dilation=2).cuda()
        x = torch.randn(2, 64, 4000, generator=cuda_gen, device="cuda").to(torch.bfloat16)
        launches = c1.conv1d_bf16.launches
        got = m(x)
        assert c1.conv1d_bf16.launches == launches + 1
    with torch.no_grad():
        want = c1.conv1d_bf16(x.clone(), m.conv.weight.clone(), m.conv.bias.clone(), 2)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_predictor_launches_the_kernel_as_the_rule_routes(cuda_gen, monkeypatch):
    """One unet64 bf16 predictor call under no_grad launches the kernel
    once for each convolution the rule routes, and its output lies within
    bf16 noise of the same call with every convolution on cuDNN; under grad
    it launches it 0 times."""
    model = _swap_model()
    call = _predict(model, 2, cuda_gen)
    with torch.no_grad():
        routed = _routed_calls(model, call)
        launches = c1.conv1d_bf16.launches
        got = call()
        assert c1.conv1d_bf16.launches == launches + len(routed)
        with monkeypatch.context() as mp:
            mp.setattr(layers, "routes", lambda *args: False)
            cudnn = call()
            assert c1.conv1d_bf16.launches == launches + len(routed)
    rel = ((got - cudnn).norm() / cudnn.norm()).item()
    print(f"{len(routed)} routed convolutions; predictor output against cuDNN's: "
          f"relative L2 {rel:.3g}")
    assert rel < 2e-2
    model.requires_grad_(True)
    with torch.enable_grad():
        launches = c1.conv1d_bf16.launches
        out = call()
        out.float().square().mean().backward()
    assert c1.conv1d_bf16.launches == launches
