"""The PyTorch port's hand-written kernels against their plain PyTorch
versions on a CUDA card. Every test here needs the card and skips without
one. The file imports neither JAX nor the shared test helpers, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import copy
import os

import pytest
import torch

from vq_voice_swap_torch.models.layers import ResBlock
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
