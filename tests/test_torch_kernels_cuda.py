"""The PyTorch port's hand-written kernels against their plain PyTorch
versions on a CUDA card. Every test here needs the card and skips without
one. The file imports neither JAX nor the shared test helpers, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from vq_voice_swap_torch.ops import group_norm as gn
from vq_voice_swap_torch.ops import vq_assign as vqa


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 31, 3200, 3201])
def test_vq_kernel_matches_plain(cuda_gen, rows):
    d = torch.randn(512, 1024, generator=cuda_gen, device="cuda")
    x = torch.randn(rows, 1024, generator=cuda_gen, device="cuda")
    idx, used = vqa.vq_assign(d, x)
    pidx, pused = vqa.vq_assign_plain(d, x)
    for i in torch.nonzero(idx != pidx).flatten().tolist():
        a = ((x[i].double() - d[idx[i]].double()) ** 2).sum()
        b = ((x[i].double() - d[pidx[i]].double()) ** 2).sum()
        assert (a - b).abs() <= 1e-6 * torch.maximum(a, b), i
    if torch.equal(idx, pidx):
        assert torch.equal(used, pused)


@pytest.mark.cuda
def test_vq_kernel_ties_take_lowest_index(cuda_gen):
    d = torch.randn(200, 70, generator=cuda_gen, device="cuda")  # ragged C, D
    d[150] = d[9]
    d[199] = d[9]
    x = d[[9, 150, 199, 3]].contiguous()
    idx, used = vqa.vq_assign(d, x)
    assert idx.tolist() == [9, 9, 9, 3]
    assert torch.nonzero(used).flatten().tolist() == [3, 9]
