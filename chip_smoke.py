#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vq_voice_swap_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. Device: print the card's name and power limit (nvidia-smi), build the
   CUDA kernels from csrc/ (one nvcc per source, started together).
2. Kernels vs their plain PyTorch versions at the main paths' shapes, in
   full float32 (TF32 off): GroupNorm statistics (CUDA; as (mean, var) and
   as the folded (mean, a, b) with FiLM, twice for the same bits) and apply
   (Triton) at [16, 64, 64000] in f32 and bf16, [16, 512, 250] with and
   without GELU and FiLM, the CLI's [1, 64, 64000] and a large-mean input
   (f32 atol 1e-4, bf16 atol 2e-2; statistics 1e-5 / 1e-4 relative); VQ
   assignment (CUDA, 3xTF32 tensor cores) at B=1, 200, 3200 and 3201,
   C=1024, D=512, twice for the same bits, and an exact-tie case (indices
   equal up to true ties at 1e-6 relative in float64, used masks equal);
   the fused ResBlock pair (CUDA, tensor cores) at the unet64 top levels'
   shapes, two inputs, no FiLM, dilations 1 and 4, a ragged T and 256 ->
   256 channels at dilation 7, in f32 and bf16 (atol/rtol 2e-4 and 5e-2),
   twice for the same bits; its bounds printed on the tensor cores (3xTF32
   for f32) and on the f32 CUDA cores. Each kernel's device time (a
   replayed CUDA graph of its calls, kernel_ab.cuda_ms) is printed beside
   its bound, its plain version and a library call for the same work where
   one exists (none computes a ResBlock; the port's unfused ResBlock is
   timed as a labelled reference, cuDNN TF32 off and on): GroupNorm
   statistics alone in f32 and bf16, VQ at B=3200 and B=200. The
   statistics and VQ wrappers, and their library calls, are also timed
   eagerly (back-to-back calls, host dispatch included), with the host's
   time per call. Every ticket counter (ops/tickets.py) is 0 after this
   phase and after the last.
3. Main paths, each with every launch count set to 0 just before it and
   read just after. The swap: a full-width VQ-VAE (unet64 predictor,
   conv-mfcc-ulaw encoder, 512 x 1024 codebook, 251 labels) on seeded
   weights is saved in the JAX .npz format and driven through
   ``python -m vq_voice_swap_torch.sample_vqvae``'s ``main`` on a 4 s WAV,
   with DPM++ (10 steps) and DDPM (5 steps); asserts 64000 output samples
   and the launch counts (VQ once per encode, GroupNorm statistics and
   apply 131 each per predictor call). Unconditional sampling: a
   full-width unet64 DiffusionModel on seeded weights, saved as .npz,
   driven through
   ``python -m vq_voice_swap_torch.sample_diffusion``'s ``main`` in bf16
   with --fuse-levels 2, 5 quadratic-warped DDPM steps, 2 samples; asserts
   two 4 s WAVs and 10 launches of each fused kernel per step; then one
   full-width predictor call with fuse_levels=2 against fuse_levels=0, in
   f32 (TF32 off) and bf16.
4. Serving time: encode + 10-step DPM++ decode of 16 clips in f32 (TF32
   convolutions, PyTorch's default) and bf16, a torch.profiler breakdown
   of one predictor call by kernel class with its kernel launch count; a
   check that one GroupNorm is two launches with no torch op between them,
   and the launches, device time and host time of the torch ops left
   around the kernels (the fused ResBlock's GroupNorm-2 merge and fold).
   Then unconditional sampling of 16 clips with 10 quadratic-warped DPM++
   steps at fuse_levels 0 and 2 (in turns) in bf16 and f32, and a profile
   of one bf16 predictor call at each.

The line before the last is a JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from kernel_ab import cuda_ms, eager_ms, seed_weights  # noqa: E402
from vq_voice_swap_torch import sample_diffusion, sample_vqvae  # noqa: E402
from vq_voice_swap_torch.diffusion import make_warp  # noqa: E402
from vq_voice_swap_torch.diffusion_model import DiffusionModel  # noqa: E402
from vq_voice_swap_torch.models.layers import ResBlock  # noqa: E402
from vq_voice_swap_torch.ops import cuda_build  # noqa: E402
from vq_voice_swap_torch.ops import fused_resblock as frb  # noqa: E402
from vq_voice_swap_torch.ops import group_norm as gn  # noqa: E402
from vq_voice_swap_torch.ops import vq_assign as vqa  # noqa: E402
from vq_voice_swap_torch.ops.tickets import ticket_buffers  # noqa: E402
from vq_voice_swap_torch.vq_vae import VQVAE  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet), at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense tensor cores
TF32_FLOP_PER_S = 495e12  # dense tensor cores

SAMPLE_RATE = 16000
SAMPLES = 4 * SAMPLE_RATE
BATCH = 16
GN_PER_PREDICTOR = 131  # 65 ResBlocks x 2 + out_norm
MODEL_KWARGS = dict(pred_name="unet", base_channels=64, enc_name="conv-mfcc-ulaw",
                    dictionary_size=512, num_labels=251)
UNCOND_KWARGS = dict(pred_name="unet", base_channels=64)
FUSE_LEVELS = 2
FUSED_PER_PREDICTOR = 10  # unet64, fuse_levels=2: 4 down and 6 up blocks
TWO_INPUT_PER_PREDICTOR = 5  # up blocks whose skip is the second input
EMB = 256  # unet64's embedding width


def bound_ms(n_bytes: float, flops: float, flop_per_s: float = F32_FLOP_PER_S):
    """Least time for the work on the card, and which side bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 2


def out_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest output error: absolute in float32; in bf16 relative to |y|
    above 1, since one bf16 rounding step is 2^-8 of |y|."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        diff = diff / want.float().abs().clamp(min=1.0)
    return diff.max().item()


def check_group_norm(dev, gen):
    """Statistics (CUDA) and apply (Triton) kernels vs plain; returns their
    JSON entries."""
    cases = [
        # (label, shape, dtype, gelu, film, offset, atol)
        ("flagship f32", (BATCH, 64, SAMPLES), torch.float32, True, False, 0.0, 1e-4),
        ("flagship bf16", (BATCH, 64, SAMPLES), torch.bfloat16, True, False, 0.0, 2e-2),
        ("deep f32 film+gelu", (BATCH, 512, 250), torch.float32, True, True, 0.0, 1e-4),
        ("deep f32 plain", (BATCH, 512, 250), torch.float32, False, False, 0.0, 1e-4),
        ("deep bf16 film+gelu", (BATCH, 512, 250), torch.bfloat16, True, True, 0.0, 2e-2),
        ("large-mean f32", (BATCH, 64, SAMPLES), torch.float32, False, False, 100.0, 1e-4),
        ("CLI f32 film+gelu", (1, 64, SAMPLES), torch.float32, True, True, 0.0, 1e-4),
    ]
    err_stats = err_apply = 0.0
    for label, shape, dtype, use_gelu, use_film, offset, atol in cases:
        n, c, _ = shape
        groups = 32
        x = (torch.randn(shape, generator=gen, device=dev) + offset).to(dtype)
        w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
        b = 0.2 * torch.randn(c, generator=gen, device=dev)
        film = None
        if use_film:  # the halves of one [N, 2C] projection, as ResBlock passes them
            film = (0.5 * torch.randn(n, 2 * c, generator=gen, device=dev)).to(
                dtype).chunk(2, dim=-1)
        mean_k, var_k = gn.group_norm_stats(x, groups)
        mean_p, var_p = gn.group_stats_plain(x, groups)
        e_mean = (mean_k - mean_p).abs().max().item()
        e_var = ((var_k - var_p).abs() / var_p).max().item()
        folded = gn.fold_affine(mean_p, var_p, w, b, 1e-5, film)
        coeffs = gn.group_norm_coeffs(x, groups, w, b, 1e-5, film)
        again = gn.group_norm_coeffs(x, groups, w, b, 1e-5, film)
        same_bits = all(torch.equal(u, v) for u, v in zip(coeffs, again))
        e_coef = max(((k - p).abs() / p.abs().clamp(min=1.0)).max().item()
                     for k, p in zip(coeffs, folded))
        y_p = gn.group_norm_apply_plain(x, *folded, use_gelu)
        e_apply = out_err(gn.group_norm_apply(x, *folded, use_gelu), y_p)
        e_full = out_err(gn.group_norm(x, w, b, groups, 1e-5, use_gelu, film), y_p)
        torch.cuda.synchronize()
        print(f"groupnorm {label} {list(shape)}: mean err {e_mean:.3g}, "
              f"var rel err {e_var:.3g}, (mean, a, b) rel err {e_coef:.3g}, "
              f"same bits twice {same_bits}, apply err {e_apply:.3g}, "
              f"coeffs+apply err {e_full:.3g} (atol {atol})")
        assert e_mean <= 1e-5 * max(1.0, abs(offset)) and e_var <= 1e-4, label
        assert e_coef <= 1e-4 and same_bits, label
        assert e_apply <= atol and e_full <= atol, label
        if dtype == torch.float32:
            err_stats = max(err_stats, e_mean, (var_k - var_p).abs().max().item())
            err_apply = max(err_apply, e_apply)

    # Timing at the largest main-path GroupNorm, [16, 64, 64000], in f32
    # (the JSON line) and bf16; x (262 / 131 MB) does not fit in L2.
    n, c, t = BATCH, 64, SAMPLES
    groups = 32
    w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    b = 0.2 * torch.randn(c, generator=gen, device=dev)
    film = (0.5 * torch.randn(n, 2 * c, generator=gen, device=dev)).chunk(2, dim=-1)
    entries = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((n, c, t), generator=gen, device=dev).to(dtype)
        f = tuple(v.to(dtype) for v in film)
        mean_p, var_p = gn.group_stats_plain(x, groups)
        folded = gn.fold_affine(mean_p, var_p, w, b, 1e-5)
        x_bytes = x.numel() * x.element_size()
        coef_ms = cuda_ms(lambda: gn.group_norm_coeffs(x, groups, w, b, 1e-5, f), 20)
        stats_ms = cuda_ms(lambda: gn.group_norm_stats(x, groups), 20)
        coef_plain = cuda_ms(lambda: gn.group_norm_coeffs_plain(x, groups, w, b, 1e-5, f), 20)
        stats_lib = cuda_ms(
            lambda: torch.var_mean(x.view(n * groups, -1), dim=1, correction=0), 20
        )
        apply_ms = cuda_ms(lambda: gn.group_norm_apply(x, *folded, True), 20)
        apply_plain = cuda_ms(lambda: gn.group_norm_apply_plain(x, *folded, True), 20)
        full_ms = cuda_ms(lambda: gn.group_norm(x, w, b, groups, 1e-5, True, f), 20)
        full_lib = cuda_ms(lambda: F.gelu(F.group_norm(x, groups, w.to(dtype), b.to(dtype),
                                                       1e-5)), 20)
        coef_eager, coef_host = eager_ms(
            lambda: gn.group_norm_coeffs(x, groups, w, b, 1e-5, f), 20)
        lib_eager, lib_host = eager_ms(
            lambda: torch.var_mean(x.view(n * groups, -1), dim=1, correction=0), 20)
        # Statistics: x read once, FiLM read, 3 [N, C] float32 written; ~4 flops/elem.
        sb, sby = bound_ms(x_bytes + 2 * n * c * x.element_size() + 3 * 4 * n * c,
                           4 * x.numel())
        # Apply: x read + y written + 3 [N, C] vectors; ~25 flops/elem with erf.
        ab, aby = bound_ms(2 * x_bytes + 3 * 4 * n * c, 25 * x.numel())
        print(f"groupnorm timing {[n, c, t]} {str(dtype)[6:]}: statistics + FiLM fold "
              f"{coef_ms:.4f} ms, one launch ({100 * sb / coef_ms:.1f}% of its bound "
              f"{sb:.4f} by {sby}; var_mean {stats_lib:.4f}; plain {coef_plain:.4f}); "
              f"(mean, var) alone {stats_ms:.4f} ms; apply+gelu {apply_ms:.4f} ms "
              f"(plain {apply_plain:.4f}, bound {ab:.4f}); whole GroupNorm+FiLM+GELU "
              f"{full_ms:.4f} ms vs F.group_norm+F.gelu (no FiLM) {full_lib:.4f} ms")
        print(f"groupnorm eager {[n, c, t]} {str(dtype)[6:]} (back-to-back calls, host "
              f"dispatch included): statistics + FiLM fold {coef_eager:.4f} ms per call, "
              f"{coef_host:.1f} us of host; var_mean {lib_eager:.4f} ms, {lib_host:.1f} us")
        if dtype == torch.float32:
            entries = [
                dict(name="group_norm_stats", route="cuda", design="PR 3",
                     source="vq_voice_swap_torch/csrc/group_norm_stats.cu",
                     replaces="vq_voice_swap_tpu/ops/fused_norm.py:84",
                     launches=0, max_abs_err=err_stats, ms=coef_ms, plain_ms=coef_plain,
                     bound_ms=sb, bound_by=sby, library_ms=stats_lib),
                dict(name="group_norm_apply", route="triton", design="PR 1",
                     source="vq_voice_swap_torch/ops/group_norm.py",
                     replaces="vq_voice_swap_tpu/ops/fused_norm.py:191",
                     launches=0, max_abs_err=err_apply, ms=apply_ms, plain_ms=apply_plain,
                     bound_ms=ab, bound_by=aby, library_ms=None),
            ]
        del x
    return entries


def _vq_pick_gap(d, x, got, want):
    """Largest float64 distance gap between the two picks of any row, and
    the largest such gap relative to the distance (0 where they agree)."""
    d64 = d.double().cpu()
    x64 = x.double().cpu()
    gd = ((x64 - d64[got.long().cpu()]) ** 2).sum(-1)
    wd = ((x64 - d64[want.long().cpu()]) ** 2).sum(-1)
    gap = (gd - wd).abs()
    return gap.max().item(), (gap / torch.maximum(gd, wd)).max().item()


def check_vq(dev, gen):
    c, d = 1024, 512
    dictionary = torch.randn(d, c, generator=gen, device=dev)
    err = 0.0
    for b in (1, 200, BATCH * 200, BATCH * 200 + 1):
        x = torch.randn(b, c, generator=gen, device=dev)
        idx, used = vqa.vq_assign(dictionary, x)
        idx2, used2 = vqa.vq_assign(dictionary, x)
        pidx, pused = vqa.vq_assign_plain(dictionary, x)
        torch.cuda.synchronize()
        gap, rel = _vq_pick_gap(dictionary, x, idx, pidx)
        differ = int((idx != pidx).sum().item())
        mask = torch.zeros_like(used)
        mask[idx.long()] = 1
        same_bits = torch.equal(idx, idx2) and torch.equal(used, used2)
        print(f"vq B={b}: {differ} indices differ from plain, largest gap "
              f"{gap:.3g} ({rel:.3g} relative), same bits twice {same_bits}")
        assert rel <= 1e-6, "VQ indices differ beyond a true tie"
        assert torch.equal(used, mask), "VQ used mask is not the picked codes"
        assert differ or torch.equal(used, pused), "VQ used masks differ"
        assert same_bits, "VQ differs between two calls"
        err = max(err, gap)

    tied = dictionary.clone()
    tied[300] = tied[7]
    tied[511] = tied[7]
    rows = torch.tensor([7, 300, 511, 42, 7], device=dev)
    idx, used = vqa.vq_assign(tied, tied[rows].contiguous())
    pidx, pused = vqa.vq_assign_plain(tied, tied[rows].contiguous())
    print(f"vq exact ties: kernel {idx.tolist()}, plain {pidx.tolist()}")
    assert idx.tolist() == pidx.tolist() == [7, 7, 7, 42, 7]
    assert torch.equal(used, pused)

    dn = torch.sum(dictionary * dictionary, dim=-1)
    entry = None
    for b in (BATCH * 200, 200):  # the serving batch, then the CLI's batch 1
        x = torch.randn(b, c, generator=gen, device=dev)
        ms = cuda_ms(lambda: vqa.vq_assign(dictionary, x), 50)
        plain = cuda_ms(lambda: vqa.vq_assign_plain(dictionary, x), 50)
        lib = cuda_ms(
            lambda: torch.argmin(torch.addmm(dn, x, dictionary.t(), alpha=-2.0), dim=1), 50
        )
        eager, host = eager_ms(lambda: vqa.vq_assign(dictionary, x), 50)
        lib_eager, lib_host = eager_ms(
            lambda: torch.argmin(torch.addmm(dn, x, dictionary.t(), alpha=-2.0), dim=1), 50
        )
        # x and the codebook read, idx and used written; the product as the
        # kernel runs it, three TF32 products on the dense tensor cores
        # (3xTF32), the card's fastest float32-accurate route.
        bnd, by = bound_ms(4 * (b * c + d * c + b + d), 3 * 2.0 * b * c * d, TF32_FLOP_PER_S)
        cuda_core = 2.0 * b * c * d / F32_FLOP_PER_S * 1e3
        print(f"vq timing B={b} C={c} D={d}: kernel {ms:.4f} ms, one launch "
              f"({100 * bnd / ms:.1f}% of its bound {bnd:.4f} by {by}, 3xTF32; addmm+argmin "
              f"{lib:.4f}, plain {plain:.4f}; for reference, the float32 product on the "
              f"CUDA cores would take {cuda_core:.4f}); eager (back-to-back calls, host "
              f"dispatch included): kernel {eager:.4f} ms, {host:.1f} us of host; "
              f"addmm+argmin {lib_eager:.4f} ms, {lib_host:.1f} us")
        if entry is None:
            entry = dict(name="vq_assign", route="cuda", design="PR 3",
                         source="vq_voice_swap_torch/csrc/vq_assign.cu",
                         replaces="vq_voice_swap_tpu/ops/vq_pallas.py:88", launches=0,
                         max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                         bound_by=by, library_ms=lib)
    return entry


def check_tickets(after: str) -> None:
    """Every launch that took a ticket has reset it."""
    torch.cuda.synchronize()
    bufs = ticket_buffers()
    assert bufs and not any(buf.any().item() for buf in bufs), after
    print(f"ticket counters after {after}: {len(bufs)} buffers (one per stream), all 0")


def seeded_block(cin: int, cout: int, film: bool, dilation: int, seed: int, dev):
    block = ResBlock(cin, cout, EMB if film else None, dilation=dilation)
    seed_weights(block, seed)
    return block.to(dev).eval()


def pair_err(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Largest |got - want| beyond rtol: max(|got - want| - tol |want|), to
    hold against atol = tol."""
    got, want = got.float(), want.float()
    return ((got - want).abs() - tol * want.abs()).max().item()


def resblock_flops(n: int, t: int, cin: int, cout: int, skip_proj: bool):
    """(stats kernel, apply kernel) flops: conv_in (k=3) in each, conv_out
    (k=3) and the 1x1 skip projection in the apply."""
    conv_in = 2.0 * 3 * cin * cout * n * t
    return conv_in, conv_in + 2.0 * 3 * cout * cout * n * t + (
        2.0 * cin * cout * n * t if skip_proj else 0.0)


def check_fused_resblock(dev, gen):
    """The fused ResBlock pair vs its plain version; returns the JSON
    entries of its two kernels (f32 at the largest block)."""
    cases = [
        # (label, n, c1, c2, cout, t, dilation, film)
        ("64->64 FiLM d2", BATCH, 64, 0, 64, SAMPLES, 2, True),
        ("64+64->64 two inputs", BATCH, 64, 64, 64, SAMPLES, 2, True),
        ("192->64", BATCH, 192, 0, 64, SAMPLES // 2, 2, True),
        ("64->64 no FiLM d1", 4, 64, 0, 64, SAMPLES // 4, 1, False),
        ("64->64 d4", 4, 64, 0, 64, SAMPLES // 4, 4, True),
        ("128->64 ragged T", 3, 128, 0, 64, 4001, 2, True),
        # The largest shared-memory footprint: z for 256 channels, widest halo.
        ("256->256 FiLM d7", 4, 256, 0, 256, SAMPLES // 4, 7, True),
    ]
    err = 0.0
    for i, (label, n, c1, c2, cout, t, dil, film) in enumerate(cases):
        block = seeded_block(c1 + c2, cout, film, dil, 100 + i, dev)
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 5e-2)):
            x = torch.randn(n, c1, t, generator=gen, device=dev).to(dtype)
            x2 = torch.randn(n, c2, t, generator=gen, device=dev).to(dtype) if c2 else None
            emb = torch.randn(n, EMB, generator=gen, device=dev).to(dtype) if film else None
            with torch.no_grad():
                got = frb.fused_resblock(block, x, emb, x2)
                again = frb.fused_resblock(block, x, emb, x2)
                want = frb.fused_resblock_plain(block, x, emb, x2)
            torch.cuda.synchronize()
            e = pair_err(got, want, tol)
            abs_err = (got.float() - want.float()).abs().max().item()
            same_bits = torch.equal(got, again)
            print(f"fused resblock {label} [{n}, {c1}+{c2}, {t}] -> {cout} "
                  f"{str(dtype)[6:]}: max |kernel - plain| {abs_err:.3g}, beyond "
                  f"rtol {e:.3g} (atol/rtol {tol}), same bits twice {same_bits}")
            assert e <= tol, label
            assert same_bits, label
            if dtype == torch.float32:
                err = max(err, abs_err)
            del got, again, want, x, x2
    torch.cuda.empty_cache()

    # Timing at the largest main-path block, [16, 64, 64000] 64 -> 64 with
    # FiLM, dilation 2, in f32 (the JSON line) and bf16.
    n, c, t = BATCH, 64, SAMPLES
    block = seeded_block(c, c, True, 2, 99, dev)
    entries = []
    for dtype in (torch.float32, torch.bfloat16):
        size = 4 if dtype == torch.float32 else 2
        # The design's arithmetic: bf16 tensor cores, or three TF32 products
        # per float32 product (3xTF32); the bound of a float32 design on the
        # CUDA cores is printed beside it.
        f32 = dtype == torch.float32
        tc_peak = TF32_FLOP_PER_S / 3 if f32 else BF16_FLOP_PER_S
        tc_name = "3xTF32 tensor cores" if f32 else "bf16 tensor cores"
        x = torch.randn(n, c, t, generator=gen, device=dev).to(dtype)
        emb = torch.randn(n, EMB, generator=gen, device=dev).to(dtype)
        with torch.no_grad():
            xs = (x,)
            norm1 = frb._norm_in_affine(block, xs, gn.group_norm_coeffs)
            conv_in = frb._conv_weight(block.conv_in, dtype)
            conv_out = frb._conv_weight(block.conv_out, dtype)
            part = frb.fused_resblock_stats(xs, norm1, conv_in)
            norm2 = frb._norm_mid_affine(block, part, emb)
            stats_ms = cuda_ms(lambda: frb.fused_resblock_stats(xs, norm1, conv_in), 10)
            apply_ms = cuda_ms(lambda: frb.fused_resblock_apply(
                xs, norm1, conv_in, norm2, conv_out, (None, None), 2), 10)
            pair_ms = cuda_ms(lambda: frb.fused_resblock(block, x, emb), 10)
            plain_ms = cuda_ms(lambda: frb.fused_resblock_plain(block, x, emb), 10)
            unfused_ms = cuda_ms(lambda: block(x, emb), 10)
            torch.backends.cudnn.allow_tf32 = True
            unfused_tf32_ms = cuda_ms(lambda: block(x, emb), 10)
            torch.backends.cudnn.allow_tf32 = False
        x_bytes = x.numel() * size
        f_stats, f_apply = resblock_flops(n, t, c, c, False)
        stats_bytes, apply_bytes = x_bytes + part.numel() * 4, 2 * x_bytes
        sb, sby = bound_ms(stats_bytes, f_stats, tc_peak)
        ab, aby = bound_ms(apply_bytes, f_apply, tc_peak)
        sb_cc, _ = bound_ms(stats_bytes, f_stats, F32_FLOP_PER_S)
        ab_cc, _ = bound_ms(apply_bytes, f_apply, F32_FLOP_PER_S)
        # The pair with the GroupNorm-1 statistics: x read 3 times, out written.
        pair_bytes, pair_flops = 4 * x_bytes, f_stats + f_apply
        pb, pby = bound_ms(pair_bytes, pair_flops, tc_peak)
        print(f"fused resblock timing [{n}, {c}, {t}] 64->64 FiLM d2 {str(dtype)[6:]}: "
              f"stats {stats_ms:.4f} ms (bound {sb:.4f} by {sby} on the {tc_name}; "
              f"{sb_cc:.4f} on the f32 CUDA cores), apply {apply_ms:.4f} ms (bound "
              f"{ab:.4f} by {aby} on the {tc_name}; {ab_cc:.4f} on the f32 CUDA cores); "
              f"whole block {pair_ms:.4f} ms (bound {pb:.4f} by {pby}: bytes "
              f"{pair_bytes / 1e9:.3f} GB = {pair_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
              f"operations {pair_flops / 1e9:.2f} GFLOP = "
              f"{pair_flops / tc_peak * 1e3:.4f} ms; plain version {plain_ms:.4f} ms; "
              f"reference only: the port's unfused ResBlock {unfused_ms:.4f} ms, "
              f"{unfused_tf32_ms:.4f} ms with cuDNN TF32 on; library: none computes a "
              f"ResBlock)")
        if dtype == torch.float32:
            common = dict(route="cuda", design="PR 5",
                          source="vq_voice_swap_torch/csrc/fused_resblock.cu", launches=0,
                          max_abs_err=err, plain_ms=plain_ms, library_ms=None)
            entries = [
                dict(name="fused_resblock_stats", replaces="attic/fused_resblock.py:151",
                     ms=stats_ms, bound_ms=sb, bound_by=sby, **common),
                dict(name="fused_resblock_apply", replaces="attic/fused_resblock.py:175",
                     ms=apply_ms, bound_ms=ab, bound_by=aby, **common),
            ]
        del x, emb, part
    return entries


# ------------------------------------------------------------------ phase 3


def speech_like(seed: int, n: int) -> np.ndarray:
    """A 16 kHz test clip: a gliding harmonic tone with a syllable-rate
    envelope, plus noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SAMPLE_RATE
    f0 = 110 + 60 * np.sin(2 * np.pi * 0.7 * t + rng.rand() * 6)
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    tone = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 4 * t + rng.rand() * 6) ** 2
    return (0.3 * env * tone / 2 + 0.02 * rng.randn(n)).astype(np.float32)


def write_wav(path: str, samples: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes((np.clip(samples, -1, 1) * (2**15 - 1)).astype("<i2").tobytes())


# Each kernel's wrappers; the statistics kernel has two entry points.
COUNTED = (vqa.vq_assign, gn.group_norm_coeffs, gn.group_norm_stats, gn.group_norm_apply,
           frb.fused_resblock_stats, frb.fused_resblock_apply)
KERNEL_WRAPPERS = {"group_norm_stats": ("group_norm_coeffs", "group_norm_stats")}


def reset_counts():
    for fn in COUNTED:
        fn.launches = 0


def read_counts():
    return {fn.__name__: fn.launches for fn in COUNTED}


def main_path(dev, workdir: str, clips: np.ndarray):
    model = VQVAE(**MODEL_KWARGS)
    seed_weights(model, 0)
    model = model.to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    # Centre the codebook on the encoder's outputs, at their spread, so the
    # seeded encoder's frames pick many codes.
    with torch.no_grad():
        enc = model.encode_raw(torch.from_numpy(clips[:, :, None]).to(dev))
        model.vq.dictionary.copy_(
            enc.mean(dim=(0, 1)) + model.vq.dictionary * enc.std(dim=1).mean()
        )
    ckpt = os.path.join(workdir, "model.npz")
    model.save(ckpt)
    del model, enc
    print(f"main path: full-width VQ-VAE, {n_params} parameters, saved to npz")

    src = os.path.join(workdir, "in.wav")
    write_wav(src, clips[0])
    totals = {}
    for sampler, steps, extra in (("dpmpp", 10, ["--check-vq"]), ("ddpm", 5, [])):
        out = os.path.join(workdir, f"out_{sampler}.wav")
        reset_counts()
        t0 = time.perf_counter()
        sample_vqvae.main([
            "--label", "7", "--input-file", src, "--sample-steps", str(steps),
            "--sampler", sampler, "--device", "cuda", *extra, ckpt, out,
        ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        with wave.open(out, "rb") as w:
            frames = w.getnframes()
            data = np.frombuffer(w.readframes(frames), "<i2")
        encodes = 2 if extra else 1
        print(f"main path {sampler} {steps} steps: {seconds:.3f} s, "
              f"{frames} samples, peak {np.abs(data).max()}, launches {counts}")
        assert frames == SAMPLES and np.abs(data).max() > 0
        assert counts["vq_assign"] == encodes
        # Every GroupNorm is one statistics launch (coefficients) and one apply.
        assert counts["group_norm_apply"] == GN_PER_PREDICTOR * steps
        assert counts["group_norm_coeffs"] == GN_PER_PREDICTOR * steps
        assert counts["group_norm_stats"] == 0
        assert counts["fused_resblock_stats"] == counts["fused_resblock_apply"] == 0
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return ckpt, totals


def sampling_path(dev, workdir: str):
    """Unconditional sampling through the CLI with the fused blocks, then one
    full-width predictor call fused against unfused. Returns the checkpoint
    and the path's launch counts."""
    model = DiffusionModel(**UNCOND_KWARGS)
    seed_weights(model, 1)
    n_params = sum(p.numel() for p in model.parameters())
    ckpt = os.path.join(workdir, "uncond.npz")
    model.save(ckpt)
    del model
    out = os.path.join(workdir, "samples")
    steps = 5
    reset_counts()
    t0 = time.perf_counter()
    sample_diffusion.main([
        "--checkpoint-path", ckpt, "--bf16", "--fuse-levels", str(FUSE_LEVELS),
        "--sampler", "ddpm", "--schedule", "quadratic", "--sample-steps", str(steps),
        "--num-samples", "2", "--batch-size", "2", "--sample-path", out,
        "--device", "cuda",
    ])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peaks = []
    for name in ("sample_000000.wav", "sample_000001.wav"):
        with wave.open(os.path.join(out, name), "rb") as w:
            assert w.getnframes() == SAMPLES
            peaks.append(int(np.abs(np.frombuffer(w.readframes(SAMPLES), "<i2")).max()))
    print(f"sampling path: unet64 DiffusionModel, {n_params} parameters; CLI bf16 "
          f"--fuse-levels {FUSE_LEVELS}, {steps} quadratic-warped DDPM steps, 2 samples: "
          f"{seconds:.3f} s, {len(peaks)} WAVs, peaks {peaks}, launches {counts}")
    assert sorted(os.listdir(out)) == ["sample_000000.wav", "sample_000001.wav"]
    assert min(peaks) > 0
    fused = FUSED_PER_PREDICTOR * steps
    assert counts["fused_resblock_stats"] == counts["fused_resblock_apply"] == fused
    # GroupNorm-1 of each fused block runs the statistics kernel to its
    # coefficients (one launch per input); both GroupNorms of a fused block
    # leave the unfused path's apply.
    unfused_gn = (GN_PER_PREDICTOR - 2 * FUSED_PER_PREDICTOR) * steps
    assert counts["group_norm_apply"] == unfused_gn
    assert counts["group_norm_coeffs"] == unfused_gn + fused + TWO_INPUT_PER_PREDICTOR * steps
    assert counts["group_norm_stats"] == 0
    assert counts["vq_assign"] == 0

    # One full-width predictor call, fuse_levels=2 against 0, same input.
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(2, SAMPLES, 1, generator=gen, device=dev)
    ts = torch.tensor([0.3, 0.9], device=dev)
    def gaps(a, b):
        """max |a - b| / max |b| and mean |a - b| / mean |b|."""
        d = (a - b).abs()
        return (d.max() / b.abs().max()).item(), (d.mean() / b.abs().mean()).item()

    unfused = {}
    for dtype, tol in ((None, 1e-3), ("bfloat16", 5e-2)):
        outs = []
        for k in (FUSE_LEVELS, 0):
            m = DiffusionModel.load(ckpt, dtype=dtype, device=dev, fuse_levels=k)
            with torch.no_grad():
                outs.append(m.predict_eps(x, ts))
            del m
        fused_out, unfused[dtype] = outs
        assert torch.isfinite(fused_out).all()
        rel, mean_rel = gaps(fused_out, unfused[dtype])
        print(f"predictor call {dtype or 'float32'} [2, {SAMPLES}]: fuse_levels="
              f"{FUSE_LEVELS} vs 0: max |diff| / max |out| {rel:.3g}, mean |diff| / "
              f"mean |out| {mean_rel:.3g} (limit {tol} on the max)")
        assert rel <= tol, dtype
    rel, mean_rel = gaps(unfused["bfloat16"], unfused[None])
    print(f"predictor call, for scale: unfused bf16 vs unfused f32: max |diff| / "
          f"max |out| {rel:.3g}, mean |diff| / mean |out| {mean_rel:.3g}")
    torch.backends.cudnn.allow_tf32 = True
    return ckpt, counts


# ------------------------------------------------------------------ phase 4


def serving_time(dev, ckpt: str, clips: np.ndarray, smi: str):
    """Encode + 10-step DPM++ decode of BATCH clips, 3 timed runs after a
    warm one, per compute dtype; then where one predictor call's device
    time goes."""
    audio = torch.from_numpy(clips[:, :, None]).to(dev)
    labels = torch.arange(BATCH, device=dev) * 13 % MODEL_KWARGS["num_labels"]
    outs = {}
    for dtype in (None, "bfloat16"):
        name = dtype or "float32"
        model = VQVAE.load(ckpt, dtype=dtype, device=dev)

        def swap():
            with torch.no_grad():
                codes = model.encode(audio)
                return model.decode(
                    codes, labels=labels, steps=10, sampler="dpmpp", constrain=True,
                    generator=torch.Generator(device=dev).manual_seed(0),
                )

        swap()  # warm: kernel compiles and cuDNN plans
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = swap()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        assert out.shape == (BATCH, SAMPLES, 1) and torch.isfinite(out).all()
        outs[name] = out.float()
        seconds = sorted(runs)[1]
        print(f"serving {name} on {smi}: encode + 10-step DPM++ decode of "
              f"{BATCH} x 4 s clips, median {seconds:.4f} s of "
              f"{[round(r, 4) for r in runs]}, real-time factor "
              f"{BATCH * 4 / seconds:.2f}")
        profile_predictor(model, dev, name)
        del model
    gap = (outs["float32"] - outs["bfloat16"]).abs().mean().item()
    print(f"serving: mean |f32 - bf16| waveform gap {gap:.4g}")


def _kernel_class(name: str) -> str:
    if "resblock_stats_kernel" in name:
        return "fused resblock stats (CUDA)"
    if "resblock_apply_kernel" in name:
        return "fused resblock apply (CUDA)"
    if "group_norm_stats_kernel" in name:
        return "groupnorm stats + fold (CUDA)"
    if name.startswith("apply_kernel"):
        return "groupnorm apply (Triton)"
    if "vq_assign_kernel" in name:
        return "vq assign (CUDA)"
    lowered = name.lower()
    if any(k in lowered for k in ("conv", "xmma", "gemm", "cudnn", "cutlass", "wgrad")):
        return "convolution / matmul (cuDNN, cuBLAS)"
    return "other (eager elementwise, copies, resize, concat)"


def profile_predictor(model: VQVAE, dev, name: str) -> None:
    """Device time by kernel class for one predictor call at BATCH, from
    torch.profiler, and the device's busy share of the call's wall time."""
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(BATCH, SAMPLES, 1, generator=gen, device=dev)
    ts = torch.full((BATCH,), 0.5, device=dev)
    cond = torch.randn(BATCH, SAMPLES // 320, model.cond_channels,
                       generator=gen, device=dev)
    labels = torch.arange(BATCH, device=dev)
    launches = profile_call(lambda: model.predict_eps(x, ts, cond, labels), name)
    print(f"  swap predictor call {name}: {launches} kernel launches (target: < 2000)")
    group_norm_glue(model, dev, name)


def profile_call(fn, name: str) -> int:
    """Device time by kernel class for one warm call of fn (a predictor
    call at BATCH), and the device's busy share of its wall time. Returns
    the call's kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    by_class = {}
    for e in kernels:
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3
    print(f"profile {name} predictor call, batch {BATCH}: wall {wall_ms:.3f} ms, "
          f"device busy {total:.3f} ms ({100 * total / wall_ms:.1f}%), "
          f"{launches} kernel launches")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {ms:.3f} ms ({100 * ms / max(total, 1e-9):.1f}%)")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"  top kernel {e.self_device_time_total / 1e3:.3f} ms x{e.count} "
              f"{e.key[:100]}")
    return launches


def _device_kernels(prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def group_norm_glue(model: VQVAE, dev, name: str) -> None:
    """The torch ops left around the GroupNorm kernels. On the unfused path
    there are none: one GroupNorm, with or without FiLM, is exactly one
    statistics launch and one apply launch (asserted from torch.profiler).
    What is left is the fused ResBlock's GroupNorm-2 merge and affine/FiLM
    fold: its device launches and device time, counted by torch.profiler on
    one call for the largest fused block, and its host dispatch time, each
    scaled by the fused blocks of one predictor call at fuse_levels=2."""
    from torch.profiler import ProfilerActivity, profile

    from vq_voice_swap_torch.models.layers import GroupNorm

    n_norms = sum(isinstance(m, GroupNorm) for m in model.predictor.modules())
    assert n_norms == GN_PER_PREDICTOR, n_norms
    dtype = torch.bfloat16 if name == "bfloat16" else torch.float32
    n, c, groups = BATCH, 64, 32
    x = torch.randn(n, c, SAMPLES, device=dev).to(dtype)
    w, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    film = torch.randn(n, 2 * c, device=dev).to(dtype).chunk(2, dim=-1)
    for f in (None, film):
        gn.group_norm(x, w, b, groups, 1e-5, True, f)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            gn.group_norm(x, w, b, groups, 1e-5, True, f)
            torch.cuda.synchronize()
        names = sorted(_kernel_class(e.key) for e in _device_kernels(prof)
                       for _ in range(e.count))
        assert names == ["groupnorm apply (Triton)", "groupnorm stats + fold (CUDA)"], names
    print(f"  unfused GroupNorm {name}, with and without FiLM: 2 launches "
          f"(statistics + fold, apply), no torch op between them")

    block = seeded_block(c, c, True, 2, 98, dev)
    emb = torch.randn(n, EMB, device=dev).to(dtype)
    norm = block.norm_mid.norm
    with torch.no_grad():
        norm1 = frb._norm_in_affine(block, (x,), gn.group_norm_coeffs)
        part = frb.fused_resblock_stats((x,), norm1, frb._conv_weight(block.conv_in, dtype))
        f2 = frb._film(block, emb)

        def merge_and_fold():
            mean2, var2 = gn.merge_partials(*part.view(3, n * groups, -1))
            return gn.fold_affine(mean2.view(n, -1), var2.view(n, -1), norm.weight,
                                  norm.bias, norm.eps, f2)

        merge_and_fold()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            merge_and_fold()
            torch.cuda.synchronize()
        glue = _device_kernels(prof)
        t0 = time.perf_counter()
        for _ in range(100):
            merge_and_fold()
        host_ms = (time.perf_counter() - t0) * 1e3 / 100
        torch.cuda.synchronize()
    per = FUSED_PER_PREDICTOR
    print(f"  fused-block GroupNorm-2 merge + fold {name} ({per} fused blocks per "
          f"predictor call at fuse_levels={FUSE_LEVELS}): "
          f"{per * sum(e.count for e in glue)} kernel launches, device "
          f"{per * sum(e.self_device_time_total for e in glue) / 1e3:.3f} ms, host dispatch "
          f"{per * host_ms:.3f} ms")


def sampling_serving_time(dev, ckpt: str, smi: str):
    """16 unconditional 4 s samples with 10 quadratic-warped DPM++ steps, at
    fuse_levels 0 and 2 in turns (0, 2 / 2, 0 / 0, 2 after a warm call of
    each), per compute dtype; then one profiled bf16 predictor call at each."""
    warp = make_warp("quadratic")
    gen = torch.Generator(device=dev).manual_seed(4)
    x_T = torch.randn(BATCH, SAMPLES, 1, generator=gen, device=dev)
    unfused = {}
    for dtype in ("bfloat16", None):
        name = dtype or "float32"
        models = {k: DiffusionModel.load(ckpt, dtype=dtype, device=dev, fuse_levels=k)
                  for k in (0, FUSE_LEVELS)}

        def sample(k):
            with torch.no_grad():
                return models[k].diffusion.dpmpp_sample(
                    x_T, models[k].predict_eps, 10, warp=warp)

        runs = {k: [] for k in models}
        outs = {k: sample(k) for k in models}  # warm
        for order in ((0, FUSE_LEVELS), (FUSE_LEVELS, 0), (0, FUSE_LEVELS)):
            for k in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[k] = sample(k)
                torch.cuda.synchronize()
                runs[k].append(time.perf_counter() - t0)
        for k, out in outs.items():
            assert out.shape == (BATCH, SAMPLES, 1) and torch.isfinite(out).all()
            seconds = sorted(runs[k])[1]
            print(f"sampling {name} fuse_levels={k} on {smi}: 10-step quadratic DPM++ of "
                  f"{BATCH} x 4 s, median {seconds:.4f} s of "
                  f"{[round(r, 4) for r in runs[k]]}, real-time factor "
                  f"{BATCH * 4 / seconds:.2f}")
        gap = (outs[0] - outs[FUSE_LEVELS]).abs().mean().item()
        print(f"sampling {name}: mean |fuse_levels 0 - {FUSE_LEVELS}| waveform gap "
              f"{gap:.4g}, mean |sample| {outs[0].abs().mean().item():.4g}")
        unfused[name] = outs[0]
        if dtype == "bfloat16":
            ts = torch.full((BATCH,), 0.5, device=dev)
            for k, m in models.items():
                profile_call(lambda: m.predict_eps(x_T, ts), f"{name} fuse_levels={k}")
        del models, outs
    gap = (unfused["bfloat16"] - unfused["float32"]).abs().mean().item()
    print(f"sampling, for scale: mean |bf16 - f32| waveform gap at fuse_levels=0 {gap:.4g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t_start = time.perf_counter()
    logs = cuda_build.build_all()
    for name, log in logs.items():
        if log is not None:
            print(f"built {name}:\n{log.strip()}")
    print(f"built {', '.join(logs)} in {time.perf_counter() - t_start:.1f} s")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = check_group_norm(dev, gen) + [check_vq(dev, gen)]
    torch.cuda.empty_cache()
    kernels += check_fused_resblock(dev, gen)
    check_tickets("the kernel checks")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for serving
    torch.cuda.empty_cache()
    print(f"phases 1-2: {time.perf_counter() - t_start:.1f} s")

    clips = np.stack([speech_like(s, SAMPLES) for s in range(BATCH)])
    with tempfile.TemporaryDirectory() as workdir:
        # Each kernel's launches come from the path that runs it: the swap
        # for VQ and GroupNorm, unconditional sampling for the fused pair.
        ckpt, swap_launches = main_path(dev, workdir, clips)
        uncond_ckpt, sampling_launches = sampling_path(dev, workdir)
        for k in kernels:
            path = sampling_launches if k["name"].startswith("fused") else swap_launches
            k["launches"] = sum(path[w] for w in KERNEL_WRAPPERS.get(k["name"], (k["name"],)))
        print(f"phase 3: {time.perf_counter() - t_start:.1f} s")
        serving_time(dev, ckpt, clips, smi)
        sampling_serving_time(dev, uncond_ckpt, smi)
    check_tickets("the main paths and serving")
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
