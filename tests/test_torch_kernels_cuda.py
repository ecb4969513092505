"""The PyTorch port's hand-written kernels against their plain PyTorch
versions on a CUDA card. Every test here needs the card and skips without
one. The file imports neither JAX nor the shared test helpers, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

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
