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
   assignment (CUDA, 3xTF32 tensor cores) at B=1, 200, 3200, 3201 and
   8000 (the unet128 encoder's rows at the training batch), C=1024, D=512,
   twice for the same bits, and an exact-tie case (indices
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
   time per call. The GroupNorm backward (CUDA; the route of bwd_route,
   printed with its cluster size and memory passes: one cluster launch per
   (n, group), or reduce + dx beyond a cluster's capacity) against
   group_norm_backward_plain at the guidance networks' largest shape
   [16, 32, 64000], at the guided CLIs' [1, 32, 64000] and [2, 32, 64000],
   at unet64's first level [16, 64, 64000] (two channels a group), at
   unet64's first up level in training [16, 128, 64000] (four channels a
   group, 16-block clusters), at [3, 20, 333] (odd T, 5 channels a group) and at [1, 128, 128000] (a
   unet64 first-level span at 8 s: the two-kernel route), f32 and bf16,
   with and without FiLM and GELU (dx within 1e-4 / 2e-2 of max(|dx|, 1),
   S1 and S2 within 1e-4 of their largest), from the forward's saved
   statistics and again from recomputed ones for the same bits; the kernel
   timed at [16, 32, 64000] and [1, 32, 64000] beside its bound (x and dy
   read, dx written), the standalone wrapper (with a statistics launch),
   the two-kernel route at the same shape, its plain version and
   torch.ops.aten.native_group_norm_backward (no FiLM, no GELU). A
   training step's GroupNorm at [16, 128, 64000], FiLM + GELU, f32 and
   bf16, x, the affine and the FiLM projection and its input all requiring
   grad: every gradient through GroupNormFunction (the statistics, apply
   and backward kernels) against autograd through the plain versions
   (1e-4 / 2e-2 of its largest entry); then the add-classes regime at
   the same shape (x, the affine and the projection frozen, only the
   embedding trained): dca, dcb and the embedding's gradient. The
   classifier's widest GroupNorm [16, 32, 64000] (one channel a group,
   FiLM + GELU) forward, and VQ assign at the WaveGrad VQ-VAE's width
   (512 channels, 512 codes, 1000 and 16000 rows). Every ticket counter
   (ops/tickets.py) is 0 after this phase, after phase 4 and after the
   last.
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
   f32 (TF32 off) and bf16. Guided sampling, each CLI's ``main``: the swap
   with encoder-predictor guidance (``sample_vqvae --enc-pred-path``, an
   EncoderPredictorModel at base 32 on seeded weights), classifier-guided
   unconditional sampling (``sample_diffusion --classifier-path``, a
   251-label ClassifierModel at base 32, in bf16 at --fuse-levels 2) and
   classifier-free guidance (``sample_vqvae_uncond``); asserts one GroupNorm
   backward launch (the cluster route, from the statistics the forward
   saved) per guidance-network GroupNorm per step (131 and 55), no
   statistics relaunch, and the forward launch counts.
4. Serving time: encode + 10-step DPM++ decode of 16 clips in f32 (TF32
   convolutions, PyTorch's default) and bf16, a torch.profiler breakdown
   of one predictor call by kernel class with its kernel launch count; a
   check that one GroupNorm is two launches with no torch op between them,
   and the launches, device time and host time of the torch ops left
   around the kernels (the fused ResBlock's GroupNorm-2 merge and fold).
   Then unconditional sampling of 16 clips with 10 quadratic-warped DPM++
   steps at fuse_levels 0 and 2 (in turns) in bf16 and f32, and a profile
   of one bf16 predictor call at each. Guided serving in f32: the swap of 16
   clips with encoder-predictor guidance and 16 classifier-guided
   unconditional samples, 10 DPM++ steps each, with peak device memory and a
   profile of one guided step.
5. Training, a main path of its own (launch counts set to 0 just before
   each run and read just after), each CLI's ``main``: ``train_vqvae`` on the JAX package's training flagship
   (``tones:40``, unet64 predictor, unet128 encoder, 512 x 1024 codebook,
   class-conditional, batch 16 of 4 s) for 8 steps in bf16, then in f32,
   and ``train_diffusion`` (unet64, class-conditional, bf16, batch 16) for
   5; each run's samples/s (the median of the steady steps), peak device
   memory, and launches asserted (per step, every GroupNorm one statistics,
   one apply and one cluster backward launch: 178 for the VQ-VAE, 131 for
   the diffusion model; one VQ assign per VQ-VAE step); each run resumed
   from its save and one step profiled, its GroupNorm and VQ launches
   asserted from the profiler; then one full-width VQ-VAE step (f32, TF32
   off, batch 1 x 16384) on the card against the same step on the CPU
   through the plain versions (the same codes, the loss within 1e-4
   relative, each gradient leaf within 1e-3 of its largest entry). Then,
   5 steps each in bf16 from the flagship's bf16 checkpoint:
   ``train_vqvae_add`` (3 -> 6 labels; every parameter leaf but the label
   table saved bit for bit as the pretrained one, its first rows too;
   per step 178 statistics and apply, 130 backward, 1 VQ),
   ``train_vqvae_uncond`` (178 / 178 / 1), ``train_enc_pred`` at base 32
   (178 forward with the frozen encoder's 47, 131 backward, 1 VQ) and
   ``train_classifier`` at base 32 (55 each), each with a profiled step;
   ``train_classifier`` at the diffusion run's width warm-started from its
   checkpoint for 2 steps (the scalars copied equal the predictor's down
   path's). Last the WaveGrad VQ-VAE at base 32 (``train_vqvae
   --predictor wavegrad --encoder wavegrad``, 5 steps in bf16 and f32, a
   profiled step each: 1 VQ and no GroupNorm launch a step), its f32
   checkpoint through ``sample_vqvae`` (1 VQ launch, no other), swap
   serving (encode + 10-step DPM++ of 16 clips, f32) with a profiled
   predictor call, and a full-width WaveGrad step on the card against the
   CPU as above.
6. Real-audio data and eval, each CLI's ``main`` with the launch counts set
   to 0 just before it and read just after: a LibriSpeech-style directory
   at train-clean-100's speaker count (251 speakers, two 6 s utterances
   each, 502 WAV files, ~50 minutes, 5020 windows; one speaker at 22050 Hz,
   resampled on decode) and a held-out set (one 4.5 s file a speaker, 753
   windows), with the seconds index.json and the window cache take;
   with ffmpeg, one .flac written and read back. ``train_vqvae`` on the
   directory at the flagship's widths (251 labels, bf16, 5 steps), its
   samples/s beside the tones flagship's of phase 5 and its launches
   asserted as there; one batch of 16 windows through the built C gather
   against the numpy loop (bit for bit, both timed); then the eval CLIs at
   full width: ``stat_generate --data-dir`` on the held-out set (256
   segments, the base-32 classifier: 55 GroupNorms a batch), ``swap_eval``
   on the tones flagship (32 clips, 10 DPM++ steps: 2 x 47 + 10 x 131
   GroupNorms and 2 VQ assigns a batch), ``stat_generate --sample-dir`` on
   its WAVs and ``stat_compare`` of the two (a finite distance),
   ``eval_diffusion`` (phase 3's unet64, 131 a batch), ``eval_vqvae`` (the
   directory's checkpoint, 47 + 2 x 131 and one VQ a batch) and
   ``voice_search_vqvae`` (251 labels x 4 timesteps, 63 predictor calls);
   each with its wall seconds, rate, peak device memory and launches
   (no backward launch on any eval path); last, one stat_generate batch of
   the base-32 classifier, f32 with TF32 off, on the card against the CPU
   (features and probabilities within 1e-4 of their largest entry).

The line before the last is a JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.
"""

import contextlib
import copy
import io
import json
import os
import shutil
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
from vq_voice_swap_torch import (  # noqa: E402
    eval_diffusion,
    eval_vqvae,
    sample_diffusion,
    sample_vqvae,
    sample_vqvae_uncond,
    stat_compare,
    stat_generate,
    swap_eval,
    train_classifier,
    train_diffusion,
    train_enc_pred,
    train_vqvae,
    train_vqvae_add,
    train_vqvae_uncond,
    voice_search_vqvae,
)
from vq_voice_swap_torch.classifier_model import (  # noqa: E402
    ClassifierModel,
    EncoderPredictorModel,
)
from vq_voice_swap_torch.data import (  # noqa: E402
    ChunkReader,
    ChunkWriter,
    LibriSpeech,
    build_file_index,
    have_ffmpeg,
)
from vq_voice_swap_torch.data.native import (  # noqa: E402
    batch_gather_windows,
    batch_gather_windows_plain,
)
from vq_voice_swap_torch.diffusion import make_warp  # noqa: E402
from vq_voice_swap_torch.diffusion_model import DiffusionModel  # noqa: E402
from vq_voice_swap_torch.models import make_encoder  # noqa: E402
from vq_voice_swap_torch.models.layers import ResBlock  # noqa: E402
from vq_voice_swap_torch.ops import cuda_build  # noqa: E402
from vq_voice_swap_torch.ops import fused_resblock as frb  # noqa: E402
from vq_voice_swap_torch.ops import group_norm as gn  # noqa: E402
from vq_voice_swap_torch.ops import vq_assign as vqa  # noqa: E402
from vq_voice_swap_torch.ops.tickets import ticket_buffers  # noqa: E402
from vq_voice_swap_torch.train import (  # noqa: E402
    ClassifierTrainLoop,
    DiffusionTrainLoop,
    EncoderPredictorTrainLoop,
    VQVAEAddClassesTrainLoop,
    VQVAETrainLoop,
    VQVAEUncondTrainLoop,
)
from vq_voice_swap_torch.train.loops import step_generator  # noqa: E402
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
# The guidance networks, at the JAX package's training defaults
# (train/loops.py:1151-1155, 1216-1220): 131 and 55 GroupNorms.
ENC_PRED_KWARGS = dict(base_channels=32, num_latents=512)
CLASSIFIER_KWARGS = dict(num_labels=251, base_channels=32)
GN_PER_CLASSIFIER = 55  # 27 ResBlocks x 2 + out_norm


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
        # The classifier's widest GroupNorms (base 32, first level): one
        # channel a group.
        ("classifier f32 film+gelu", (BATCH, 32, SAMPLES), torch.float32, True, True, 0.0,
         1e-4),
        ("classifier bf16 film+gelu", (BATCH, 32, SAMPLES), torch.bfloat16, True, True, 0.0,
         2e-2),
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


def check_group_norm_backward(dev, gen):
    """The backward kernel, by the route bwd_route takes, vs
    group_norm_backward_plain; returns the JSON entry (f32 at the largest
    guidance-network shape, no FiLM, no GELU: the function
    native_group_norm_backward computes)."""
    # (shape, groups, route, blocks): the guidance networks' largest shape
    # at the serving batch, the guided CLIs' batches 1 (enc-pred) and 2
    # (classifier), unet64's first down level and the unet128 encoder's
    # first levels (two channels a group), unet64's first up level in
    # training (four channels a group, 16-block clusters), an odd T with 5
    # channels a group, and a unet64 first-level span at 8 s, beyond a
    # cluster's capacity.
    cases = [((BATCH, 32, SAMPLES), 32, "cluster", 8), ((1, 32, SAMPLES), 32, "cluster", 16),
             ((2, 32, SAMPLES), 32, "cluster", 8), ((BATCH, 64, SAMPLES), 32, "cluster", 16),
             ((BATCH, 128, SAMPLES), 32, "cluster", 16), ((3, 20, 333), 4, "cluster", 2),
             ((1, 128, 2 * SAMPLES), 32, "two_kernel", 4)]
    err = 0.0
    for shape, groups, want_route, want_blocks in cases:
        n, c, _ = shape
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x = (torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
            dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
            route = gn.bwd_route(x, groups)
            assert (route.name, route.blocks) == (want_route, want_blocks), (shape, route)
            passes = 3 if route.name == "cluster" else 5
            w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
            b = 0.2 * torch.randn(c, generator=gen, device=dev)
            proj = (0.5 * torch.randn(n, 2 * c, generator=gen, device=dev)).to(dtype)
            for film in (None, tuple(proj.chunk(2, dim=-1))):
                # The forward's statistics, as GroupNormFunction saves them.
                stats = gn.group_norm_coeffs(x, groups, w, b, 1e-5, film, stats=True)[3:]
                for use_gelu in (False, True):
                    got = gn.group_norm_backward(x, dy, groups, w, b, 1e-5, use_gelu, film,
                                                 stats)
                    again = gn.group_norm_backward(x, dy, groups, w, b, 1e-5, use_gelu, film)
                    want = gn.group_norm_backward_plain(x, dy, groups, w, b, 1e-5, use_gelu,
                                                        film)
                    torch.cuda.synchronize()
                    e_dx = out_err(got[0], want[0])
                    e_s = max(((g - v).abs().max() / v.abs().max()).item()
                              for g, v in zip(got[1:], want[1:]))
                    same_bits = all(torch.equal(u, v) for u, v in zip(got, again))
                    print(f"groupnorm backward {list(shape)} {str(dtype)[6:]} "
                          f"film={film is not None} gelu={use_gelu}: route {route.name}, "
                          f"{route.blocks} block(s) a {'span' if passes == 3 else 'row'} of "
                          f"{route.chunk} elements each, {passes} passes: dx err {e_dx:.3g} "
                          f"(limit {tol}), S1/S2 err {e_s:.3g} of their largest (limit "
                          f"1e-4), same bits twice (saved and recomputed statistics) "
                          f"{same_bits}")
                    assert e_dx <= tol and e_s <= 1e-4 and same_bits, (shape, dtype)
                    if dtype == torch.float32:
                        err = max(err, (got[0] - want[0]).abs().max().item())
                    del got, again, want
            del x, dy
    torch.cuda.empty_cache()

    # Timing at [16, 32, 64000] (x and dy, 131-262 MB each, exceed L2) and
    # at the enc-pred CLI's [1, 32, 64000]. The kernel's own time is its
    # launch from the forward's (mean, var), as the guided paths call it and
    # as native_group_norm_backward takes (mean, rstd); the standalone
    # wrapper adds a statistics launch; the two-kernel route is timed at the
    # same shape, and with a statistics launch before it, the parent design.
    entry = None
    for n, dtype in ((BATCH, torch.float32), (BATCH, torch.bfloat16), (1, torch.float32)):
        c, t, groups = 32, SAMPLES, 32
        w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
        b = 0.2 * torch.randn(c, generator=gen, device=dev)
        proj = 0.5 * torch.randn(n, 2 * c, generator=gen, device=dev)
        x = torch.randn((n, c, t), generator=gen, device=dev).to(dtype)
        dy = torch.randn((n, c, t), generator=gen, device=dev).to(dtype)
        film = tuple(proj.to(dtype).chunk(2, dim=-1))
        wl, bl = w.to(dtype), b.to(dtype)
        _, mean, rstd = torch.ops.aten.native_group_norm(x, wl, bl, n, c, t, groups, 1e-5)
        mean_g, var_g = gn.group_norm_stats(x, groups)
        route = gn.bwd_route(x, groups)
        two = gn.BwdRoute("two_kernel", *gn.bwd_slices(x))
        times = {}
        for label, f, g in (("plain", None, False), ("film+gelu", film, True)):
            times[label] = (
                cuda_ms(lambda: gn._launch_bwd(x, dy, groups, mean_g, var_g, w, b, 1e-5, g, f),
                        20),
                cuda_ms(lambda: gn.group_norm_backward(x, dy, groups, w, b, 1e-5, g, f), 20),
                cuda_ms(lambda: gn._launch_bwd(x, dy, groups, mean_g, var_g, w, b, 1e-5, g, f,
                                               two), 20),
                cuda_ms(lambda: gn.group_norm_backward_plain(x, dy, groups, w, b, 1e-5, g, f),
                        5),
            )
        stats_ms = cuda_ms(lambda: gn.group_norm_stats(x, groups), 20)
        lib = cuda_ms(lambda: torch.ops.aten.native_group_norm_backward(
            dy, x, mean, rstd, wl, n, c, t, groups, [True, False, False]), 20)
        x_bytes = x.numel() * x.element_size()
        # Bound: x and dy read once, dx written once; ~15 flops an element
        # without GELU, ~40 with GELU' (erf and exp) once an element.
        bnd, by = bound_ms(3 * x_bytes, 15 * x.numel())
        bnd_g, _ = bound_ms(3 * x_bytes, 40 * x.numel())
        (ms, wrap, two_ms, plain), (ms_g, wrap_g, two_g, plain_g) = (times["plain"],
                                                                     times["film+gelu"])
        print(f"groupnorm backward timing {[n, c, t]} {str(dtype)[6:]}, route {route.name} "
              f"({route.blocks} blocks a cluster, {route.chunk} elements a block): no FiLM, "
              f"no GELU: kernel {ms:.4f} ms from the forward's statistics "
              f"({100 * bnd / ms:.1f}% of its bound {bnd:.4f} by {by}; "
              f"native_group_norm_backward (dx) {lib:.4f}, {lib / ms:.2f}x; plain "
              f"{plain:.4f}), standalone wrapper with a statistics launch {wrap:.4f} ms, "
              f"two-kernel route {two_ms:.4f} ms ({two_ms + stats_ms:.4f} with the "
              f"statistics launch, the earlier design); FiLM + GELU: kernel {ms_g:.4f} ms "
              f"({100 * bnd_g / ms_g:.1f}% of its bound {bnd_g:.4f}, plain {plain_g:.4f}), "
              f"standalone wrapper {wrap_g:.4f} ms, two-kernel route {two_g:.4f} ms; the "
              f"statistics launch alone {stats_ms:.4f} ms. Passes: cluster 3 (x and dy "
              f"read once, dx written once), two-kernel 5")
        if entry is None:
            entry = dict(name="group_norm_backward", route="cuda",
                         source="vq_voice_swap_torch/csrc/group_norm_bwd.cu",
                         replaces="vq_voice_swap_tpu/ops/fused_norm.py:280 (_fgn_bwd; no "
                                  "Pallas kernel)",
                         launches=0, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                         bound_by=by, library_ms=lib, wrapper_ms=wrap, passes=3,
                         cluster_blocks=route.blocks, film_gelu_ms=ms_g,
                         two_kernel_ms=two_ms, two_kernel_passes=5)
        del x, dy, mean, rstd, mean_g, var_g
    torch.cuda.empty_cache()
    return entry


def check_group_norm_training_grads(dev, gen):
    """A training step's GroupNorm at unet64's first up level ([16, 128,
    64000], 32 groups, 16-block clusters), FiLM + GELU, in float32 and
    bfloat16: x, the float32 affine and the FiLM pair (the halves of a
    ResBlock's cond_proj of the step's embedding, in the compute dtype) all
    require grad. Through GroupNormFunction (the statistics, apply and
    backward kernels), every gradient down to the projection's weight and
    bias and the embedding is autograd's through the plain versions, within
    the dtype's tolerance of its largest entry."""
    shape, groups, emb_ch = (BATCH, 128, SAMPLES), 32, EMB
    n, c, _ = shape
    names = ("x", "weight", "bias", "proj weight", "proj bias", "embedding")
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x0 = (torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
        w0 = torch.rand(c, generator=gen, device=dev) + 0.5
        b0 = 0.1 * torch.randn(c, generator=gen, device=dev)
        pw0 = torch.randn(2 * c, emb_ch, generator=gen, device=dev) / emb_ch ** 0.5
        pb0 = 0.1 * torch.randn(2 * c, generator=gen, device=dev)
        emb0 = torch.randn(n, emb_ch, generator=gen, device=dev).to(dtype)
        dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
        assert gn.bwd_route(x0, groups) == gn.BwdRoute("cluster", 16, 16000)

        def grads(kernel: bool):
            x, w, b, pw, pb, emb = (v.clone().requires_grad_()
                                    for v in (x0, w0, b0, pw0, pb0, emb0))
            film = tuple(F.linear(F.gelu(emb), pw.to(dtype), pb.to(dtype)).chunk(2, dim=-1))
            if kernel:
                y = gn.group_norm(x, w, b, groups, 1e-5, True, film)
                assert "GroupNormFunction" in type(y.grad_fn).__name__
            else:
                coeffs = gn.group_norm_coeffs_plain(x, groups, w, b, 1e-5, film)
                y = gn.group_norm_apply_plain(x, *coeffs, True)
            y.backward(dy)
            return [v.grad for v in (x, w, b, pw, pb, emb)]

        launches = gn._bwd_cluster.launches
        got = grads(True)
        assert gn._bwd_cluster.launches == launches + 1
        want = grads(False)
        torch.cuda.synchronize()
        errs = []
        for name, g, v in zip(names, got, want):
            assert g.dtype == v.dtype and g.shape == v.shape, name
            scale = v.float().abs().max().item()
            errs.append((g.float() - v.float()).abs().max().item() / scale)
        print(f"groupnorm training gradients {list(shape)} {str(dtype)[6:]} FiLM + GELU, "
              f"route cluster of 16 blocks: error of each gradient over its largest entry "
              + ", ".join(f"{k} {e:.3g}" for k, e in zip(names, errs)) + f" (limit {tol})")
        assert max(errs) <= tol, errs

        # The add-classes regime: x and the affine frozen, the projection
        # frozen, only the label embedding (and so the FiLM pair) trained.
        def film_grads(kernel: bool):
            emb = emb0.clone().requires_grad_()
            ca, cb = F.linear(F.gelu(emb), pw0.to(dtype), pb0.to(dtype)).chunk(2, dim=-1)
            ca.retain_grad()
            cb.retain_grad()
            if kernel:
                y = gn.group_norm(x0, w0, b0, groups, 1e-5, True, (ca, cb))
                assert "GroupNormFunction" in type(y.grad_fn).__name__
            else:
                coeffs = gn.group_norm_coeffs_plain(x0, groups, w0, b0, 1e-5, (ca, cb))
                y = gn.group_norm_apply_plain(x0, *coeffs, True)
            y.backward(dy)
            return [ca.grad, cb.grad, emb.grad]

        launches = gn._bwd_cluster.launches
        got = film_grads(True)
        assert gn._bwd_cluster.launches == launches + 1
        want = film_grads(False)
        torch.cuda.synchronize()
        errs = [((g.float() - v.float()).abs().max() / v.float().abs().max()).item()
                for g, v in zip(got, want)]
        print(f"groupnorm add-classes gradients {list(shape)} {str(dtype)[6:]} FiLM + GELU, "
              f"x, affine and projection frozen: error over the largest entry of dca "
              f"{errs[0]:.3g}, dcb {errs[1]:.3g}, the embedding's {errs[2]:.3g} (limit {tol})")
        assert max(errs) <= tol, errs
        del x0, dy, got, want
    torch.cuda.empty_cache()


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
    # Rows: the CLI's batch 1 and the serving batch of the conv-mfcc-ulaw
    # encoder (200 frames a 4 s clip), one more, and the flagship training
    # batch of the unet128 encoder (500 frames a clip).
    for b in (1, 200, BATCH * 200, BATCH * 200 + 1, BATCH * 500):
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

    # The WaveGrad VQ-VAE's codes: 512 channels, 512 codes, 16000 rows at
    # batch 16 x 4 s (downsample 64).
    wg_dictionary = torch.randn(d, 512, generator=gen, device=dev)
    for b in (SAMPLES // 64, BATCH * SAMPLES // 64):
        x = torch.randn(b, 512, generator=gen, device=dev)
        idx, used = vqa.vq_assign(wg_dictionary, x)
        idx2, used2 = vqa.vq_assign(wg_dictionary, x)
        pidx, pused = vqa.vq_assign_plain(wg_dictionary, x)
        torch.cuda.synchronize()
        gap, rel = _vq_pick_gap(wg_dictionary, x, idx, pidx)
        differ = int((idx != pidx).sum().item())
        same_bits = torch.equal(idx, idx2) and torch.equal(used, used2)
        print(f"vq WaveGrad width B={b} C=512 D={d}: {differ} indices differ from plain, "
              f"largest gap {gap:.3g} ({rel:.3g} relative), same bits twice {same_bits}")
        assert rel <= 1e-6 and same_bits and (differ or torch.equal(used, pused))
        err = max(err, gap)

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
           gn.group_norm_backward, gn._bwd_cluster, gn._bwd_two_kernel,
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
        assert counts["group_norm_stats"] == counts["group_norm_backward"] == 0
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
    assert counts["group_norm_stats"] == counts["group_norm_backward"] == 0
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


def guidance_checkpoints(workdir: str):
    """Seeded full-width guidance networks for the swap flagship, saved as
    .npz: (encoder predictor, classifier)."""
    enc_rate = make_encoder(MODEL_KWARGS["enc_name"], MODEL_KWARGS["base_channels"]
                            ).downsample_rate
    paths = []
    for name, model, seed in (
        ("enc_pred", EncoderPredictorModel(downsample_rate=enc_rate, **ENC_PRED_KWARGS), 5),
        ("classifier", ClassifierModel(**CLASSIFIER_KWARGS), 6),
    ):
        seed_weights(model, seed)
        paths.append(os.path.join(workdir, f"{name}.npz"))
        model.save(paths[-1])
        print(f"guidance network {name}: {type(model).__name__}, "
              f"{sum(p.numel() for p in model.parameters())} parameters, saved to npz")
    return paths


def _wav_frames(path: str):
    with wave.open(path, "rb") as w:
        frames = w.getnframes()
        return frames, np.frombuffer(w.readframes(frames), "<i2")


def guided_paths(dev, workdir: str, ckpt: str, uncond_ckpt: str, ep_ckpt: str,
                 clf_ckpt: str):
    """The three guided CLIs at batch 1-2, each with the counts set to 0
    just before it; returns {path: counts}."""
    src = os.path.join(workdir, "in.wav")
    steps = 3
    runs = {}

    def run(name, fn, argv):
        reset_counts()
        t0 = time.perf_counter()
        fn(argv)
        torch.cuda.synchronize()
        runs[name] = read_counts()
        print(f"guided path {name}: {time.perf_counter() - t0:.3f} s, {steps} steps, "
              f"launches {runs[name]}")
        return runs[name]

    out = os.path.join(workdir, "out_enc_pred.wav")
    counts = run("sample_vqvae --enc-pred-path", sample_vqvae.main, [
        "--label", "7", "--input-file", src, "--sample-steps", str(steps), "--sampler",
        "dpmpp", "--enc-pred-path", ep_ckpt, "--check-vq", "--device", "cuda", ckpt, out])
    frames, data = _wav_frames(out)
    assert frames == SAMPLES and np.abs(data).max() > 0
    # Encode, the guidance targets, the --check-vq re-encode.
    assert counts["vq_assign"] == 3
    # Each GroupNorm's backward: one cluster launch from the statistics its
    # forward saved; no statistics relaunch.
    assert counts["group_norm_backward"] == counts["_bwd_cluster"] == GN_PER_PREDICTOR * steps
    assert counts["group_norm_stats"] == counts["_bwd_two_kernel"] == 0
    assert counts["group_norm_coeffs"] == counts["group_norm_apply"] == \
        2 * GN_PER_PREDICTOR * steps
    assert counts["fused_resblock_stats"] == counts["fused_resblock_apply"] == 0

    out = os.path.join(workdir, "guided_samples")
    counts = run("sample_diffusion --classifier-path", sample_diffusion.main, [
        "--checkpoint-path", uncond_ckpt, "--bf16", "--fuse-levels", str(FUSE_LEVELS),
        "--sampler", "dpmpp", "--sample-steps", str(steps), "--constrain",
        "--classifier-path", clf_ckpt, "--num-samples", "2", "--batch-size", "2",
        "--sample-path", out, "--device", "cuda"])
    for name in ("sample_000000.wav", "sample_000001.wav"):
        frames, data = _wav_frames(os.path.join(out, name))
        assert frames == SAMPLES and np.abs(data).max() > 0
    fused = FUSED_PER_PREDICTOR * steps
    unfused_gn = (GN_PER_PREDICTOR - 2 * FUSED_PER_PREDICTOR) * steps
    clf_gn = GN_PER_CLASSIFIER * steps
    assert counts["fused_resblock_stats"] == counts["fused_resblock_apply"] == fused
    assert counts["group_norm_backward"] == counts["_bwd_cluster"] == clf_gn
    assert counts["group_norm_stats"] == counts["_bwd_two_kernel"] == 0
    assert counts["group_norm_apply"] == unfused_gn + clf_gn
    assert counts["group_norm_coeffs"] == (unfused_gn + fused + TWO_INPUT_PER_PREDICTOR * steps
                                           + clf_gn)
    assert counts["vq_assign"] == 0

    out = os.path.join(workdir, "out_uncond.wav")
    counts = run("sample_vqvae_uncond", sample_vqvae_uncond.main, [
        "--label", "7", "--input-file", src, "--sample-steps", str(steps), "--sampler",
        "dpmpp", "--guide-label-scale", "1", "--guide-vq-scale", "0.5", "--schedule",
        "quadratic", "--device", "cuda", ckpt, out])
    frames, data = _wav_frames(out)
    assert frames == SAMPLES and np.abs(data).max() > 0
    assert counts["vq_assign"] == 1
    # One predictor call per step on the 3x stacked batch; nothing differentiated.
    assert counts["group_norm_coeffs"] == counts["group_norm_apply"] == GN_PER_PREDICTOR * steps
    assert counts["group_norm_backward"] == counts["group_norm_stats"] == 0
    return runs


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
    if "group_norm_bwd_" in name:
        return "groupnorm backward (CUDA)"
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
    launches, _ = profile_call(lambda: model.predict_eps(x, ts, cond, labels),
                               f"{name} predictor call")
    print(f"  swap predictor call {name}: {launches} kernel launches (target: < 2000)")
    group_norm_glue(model, dev, name)


def profile_call(fn, name: str, grad: bool = False):
    """Device time by kernel class for one warm call of fn (a predictor
    call or a train step at BATCH), and the device's busy share of its wall
    time. Returns the call's kernel launches and their count by class."""
    with torch.set_grad_enabled(grad):
        fn()
        torch.cuda.synchronize()
        records, wall_ms, lost = profiled(fn)
    total = sum(ms for _, ms in records)
    by_class, counts, by_name = {}, {}, {}
    for key, ms in records:
        cls = _kernel_class(key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        counts[cls] = counts.get(cls, 0) + 1
        t, c = by_name.get(key, (0.0, 0))
        by_name[key] = (t + ms, c + 1)
    to_host = sum("DtoH" in key for key, _ in records)
    print(f"profile {name}, batch {BATCH}: wall {wall_ms:.3f} ms, "
          f"device busy {total:.3f} ms ({100 * total / wall_ms:.1f}%), "
          f"{len(records)} kernel launches, {to_host} copies to the host (the profiler "
          f"lost the device records of {lost} of the {PROFILE_PAD} pad launches before it)")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {ms:.3f} ms ({100 * ms / max(total, 1e-9):.1f}%), "
              f"{counts[cls]} launches")
    for key, (ms, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  top kernel {ms:.3f} ms x{c} {key[:100]}")
    return len(records), counts


# torch.profiler loses the device records of a session's first launches:
# none in a fresh process, most often 1-6 a session later on, now and then
# 49-252 (PERF.md §6, PR 8), while the host's launch records stay whole
# and a pause before the work does not shrink the loss. So every profiled
# window opens with PROFILE_PAD small launches (~20 ms of host time) that
# take the loss, and the records of the work are found by their launches'
# correlation ids.
PROFILE_PAD = 4096
_LAUNCH_CALLS = ("Launch", "Memcpy", "Memset")


def profiled(fn):
    """Run fn() under torch.profiler after PROFILE_PAD small launches.
    Returns fn's device records as (name, ms), one per kernel or copy its
    launches made, fn's wall time in ms, and how many pad launches lost
    their device record. Fails if any launch of fn has no device record."""
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            pad.add_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    launches = sorted((e for e in events if e.device_type() != cuda
                       and any(k in e.name() for k in _LAUNCH_CALLS)),
                      key=lambda e: e.start_ns())
    ids = [e.correlation_id() for e in launches]
    # Device records by their launch; not the ranges that record_function
    # annotations (the optimizer's step) draw on the device's timeline.
    recorded = {}
    for e in events:
        if e.device_type() == cuda and not e.is_user_annotation():
            recorded.setdefault(e.correlation_id(), []).append(e)
    pad_ids, fn_ids = ids[:PROFILE_PAD], ids[PROFILE_PAD:]
    missing = [launches[PROFILE_PAD + i].name() for i, c in enumerate(fn_ids)
               if c not in recorded]
    assert len(pad_ids) == PROFILE_PAD and not missing, (
        f"{len(missing)} of {len(fn_ids)} launches without a device record: {missing[:8]}")
    records = [(e.name(), e.duration_ns() / 1e6) for c in fn_ids for e in recorded[c]]
    return records, wall_ms, sum(c not in recorded for c in pad_ids)


def group_norm_glue(model: VQVAE, dev, name: str) -> None:
    """The torch ops left around the GroupNorm kernels. On the unfused path
    there are none: one GroupNorm, with or without FiLM, is exactly one
    statistics launch and one apply launch (asserted from torch.profiler).
    What is left is the fused ResBlock's GroupNorm-2 merge and affine/FiLM
    fold: its device launches and device time, counted by torch.profiler on
    one call for the largest fused block, and its host dispatch time, each
    scaled by the fused blocks of one predictor call at fuse_levels=2."""
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
        records, _, _ = profiled(lambda: gn.group_norm(x, w, b, groups, 1e-5, True, f))
        names = sorted(_kernel_class(key) for key, _ in records)
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
        glue, _, _ = profiled(merge_and_fold)
        t0 = time.perf_counter()
        for _ in range(100):
            merge_and_fold()
        host_ms = (time.perf_counter() - t0) * 1e3 / 100
        torch.cuda.synchronize()
    per = FUSED_PER_PREDICTOR
    print(f"  fused-block GroupNorm-2 merge + fold {name} ({per} fused blocks per "
          f"predictor call at fuse_levels={FUSE_LEVELS}): "
          f"{per * len(glue)} kernel launches, device "
          f"{per * sum(ms for _, ms in glue):.3f} ms, host dispatch "
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
                profile_call(lambda: m.predict_eps(x_T, ts),
                             f"{name} fuse_levels={k} predictor call")
        del models, outs
    gap = (unfused["bfloat16"] - unfused["float32"]).abs().mean().item()
    print(f"sampling, for scale: mean |bf16 - f32| waveform gap at fuse_levels=0 {gap:.4g}")


def guided_serving_time(dev, ckpt: str, uncond_ckpt: str, ep_ckpt: str, clf_ckpt: str,
                        clips: np.ndarray, smi: str):
    """Guided serving in f32 (TF32 convolutions, PyTorch's default), 10
    DPM++ steps, 3 timed runs after a warm one each, with peak device
    memory: the swap of BATCH clips with encoder-predictor guidance, and
    BATCH classifier-guided unconditional samples; then a profile of one
    guided step of each (predictor call + guidance gradient)."""
    audio = torch.from_numpy(clips[:, :, None]).to(dev)
    labels = torch.arange(BATCH, device=dev) * 13 % MODEL_KWARGS["num_labels"]
    gen = torch.Generator(device=dev).manual_seed(5)
    x_T = torch.randn(BATCH, SAMPLES, 1, generator=gen, device=dev)
    model = VQVAE.load(ckpt, device=dev)
    enc_pred = EncoderPredictorModel.load(ep_ckpt, device=dev)
    uncond = DiffusionModel.load(uncond_ckpt, device=dev)
    classifier = ClassifierModel.load(clf_ckpt, device=dev)

    def swap():
        with torch.no_grad():
            codes = model.encode(audio)
            return model.decode(codes, labels=labels, steps=10, sampler="dpmpp",
                                constrain=True, x_T=x_T, enc_pred=enc_pred)

    def sample():
        with torch.no_grad():
            return uncond.diffusion.dpmpp_sample(
                x_T, uncond.predict_eps, 10, constrain=True,
                cond_fn=classifier.cond_fn(labels, 1.0))

    for name, fn in (("enc-pred guided swap", swap), ("classifier-guided sampling", sample)):
        fn()  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        assert out.shape == (BATCH, SAMPLES, 1) and torch.isfinite(out).all()
        seconds = sorted(runs)[1]
        print(f"guided serving f32 {name} on {smi}: 10-step DPM++ of {BATCH} x 4 s, "
              f"median {seconds:.4f} s of {[round(r, 4) for r in runs]}, real-time factor "
              f"{BATCH * 4 / seconds:.2f}, peak device memory {peak:.2f} GiB, mean |sample| "
              f"{out.abs().mean().item():.4g}")

    ts = torch.full((BATCH,), 0.5, device=dev)
    cond = torch.randn(BATCH, SAMPLES // 320, model.cond_channels, generator=gen, device=dev)
    targets = torch.randint(0, MODEL_KWARGS["dictionary_size"], (BATCH, SAMPLES // 320),
                            generator=gen, device=dev)
    ep_fn = enc_pred.cond_fn(targets, 1.0)
    clf_fn = classifier.cond_fn(labels, 1.0)
    launches, _ = profile_call(
        lambda: (model.predict_eps(x_T, ts, cond, labels), ep_fn(x_T, ts)),
        "f32 enc-pred guided step")
    print(f"  enc-pred guided step: {launches} kernel launches")
    launches, _ = profile_call(lambda: (uncond.predict_eps(x_T, ts), clf_fn(x_T, ts)),
                               "f32 classifier-guided step")
    print(f"  classifier-guided step: {launches} kernel launches")
    del model, enc_pred, uncond, classifier
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 5


# Training: the flagship of the JAX package's train benchmark
# (scripts/bench_train.py:56-57): unet64 predictor, unet128 encoder, 512
# codes of 1024 channels, class-conditional, batch 16 of 4 s tones.
TRAIN_VQVAE_ARGV = ["tones:40", "--predictor", "unet", "--base-channels", "64",
                    "--encoder", "unet128", "--class-cond", "--batch-size", str(BATCH)]
TRAIN_DIFFUSION_ARGV = ["tones:40", "--base-channels", "64", "--class-cond",
                        "--batch-size", str(BATCH), "--bf16"]
# The other train CLIs, from the flagship's checkpoint where they need one,
# at the JAX CLIs' default widths (base 32) unless said, bf16.
NEW_RUN_ARGV = ["tones:40", "--batch-size", str(BATCH), "--bf16"]
# WaveGrad at the JAX CLI's default width (base 32, cond_mult 16: 512-channel
# codes, 512 of them).
TRAIN_WAVEGRAD_ARGV = ["tones:40", "--predictor", "wavegrad", "--encoder", "wavegrad",
                       "--base-channels", "32", "--class-cond", "--batch-size", str(BATCH)]
TRAIN_STEPS = 8
NEW_TRAIN_STEPS = 5
GN_PER_ENCODER128 = 47  # 23 ResBlocks x 2 + out_norm
GN_PER_ENC_PRED = GN_PER_PREDICTOR  # its UNet is unet-shaped at base 32


def _flag(argv, flag: str) -> str:
    return argv[argv.index(flag) + 1]


def per_step(forward: int, backward: int, vq: int):
    """A train step's launches: GroupNorms run forward (one statistics and
    one apply launch each), GroupNorms differentiated (one cluster
    backward each, from the saved statistics) and VQ assigns."""
    return dict(forward=forward, backward=backward, vq=vq)


def _train_log(out: str):
    """(step, {key: value}) of each line of a run's train_log.txt."""
    entries = []
    with open(os.path.join(out, "train_log.txt")) as f:
        for line in f:
            if line.startswith("step "):
                head, fields = line.split(": ", 1)
                entries.append((int(head[5:]), {k: float(v) for k, v in (
                    tok.split("=") for tok in fields.split())}))
    return entries


class _Tee(io.StringIO):
    """Stdout that is also kept."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)


def training_run(dev, workdir: str, name: str, cli, argv, steps: int, launches, smi: str):
    """One train CLI run of ``steps`` steps (saved at the last), with the
    launch counts set to 0 just before it; asserts the launches of every
    kernel of the path (``launches``, per step) and prints samples/s (the
    median over the steps after two warm-up steps, less the last, whose
    metrics are fetched at the save) and peak device memory. Returns the
    run's directory, argv, counts and what the CLI printed."""
    out = os.path.join(workdir, name.replace(" ", "_"))
    argv = argv + ["--max-steps", str(steps), "--save-interval", str(steps),
                   "--output-dir", out, "--device", "cuda"]
    torch.cuda.synchronize(dev)  # the peak-memory reset needs the card's context
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout)) as printed:
        cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log = _train_log(out)
    assert [s for s, _ in log] == list(range(1, steps + 1)), log
    assert all(np.isfinite(v) for _, f in log for v in f.values())
    # The last step's metrics are fetched at the save, just after the one before.
    rates = [f["samples_per_sec"] for _, f in log[2:-1]]
    rate = (f"{float(np.median(rates)):.4f} samples/s (median of steps 3-{steps - 1}: "
            f"{[round(r, 3) for r in rates]})" if rates else "no steady step")
    print(f"training {name} on {smi}: {steps} steps in {seconds:.3f} s (build, data and "
          f"save included), {rate}, peak device memory "
          f"{peak:.2f} GiB, "
          f"losses {[round(f['loss'], 4) for _, f in log]}, launches {counts}, per step: "
          + ", ".join(f"{k} {v / steps:g}" for k, v in counts.items() if v))
    if "codebook_used" in log[0][1]:
        print(f"  codebook_used {[f['codebook_used'] for _, f in log]}")
    for f in ("model.npz", "opt.pt"):
        assert os.path.exists(os.path.join(out, f)), f
    assert counts["group_norm_coeffs"] == counts["group_norm_apply"] == \
        launches["forward"] * steps
    assert counts["group_norm_backward"] == counts["_bwd_cluster"] == \
        launches["backward"] * steps
    assert counts["group_norm_stats"] == counts["_bwd_two_kernel"] == 0
    assert counts["vq_assign"] == launches["vq"] * steps
    assert counts["fused_resblock_stats"] == counts["fused_resblock_apply"] == 0
    return out, argv, counts, printed.getvalue()


def profile_train_step(dev, loop_cls, argv, name: str, launches):
    """Resume the run in argv's directory and profile one train step: its
    kernel launches by class, asserted for the GroupNorm and VQ kernels."""
    loop = loop_cls(loop_cls.arg_parser().parse_args(argv))
    assert loop.resume
    batch = loop.to_device(loop.prepare_batch(next(iter(loop.data_loader))))
    generator = step_generator(0, 10**6, dev)
    n, counts = profile_call(lambda: loop.train_step(batch, generator),
                             f"{name} train step", grad=True)
    assert counts.get("groupnorm stats + fold (CUDA)", 0) == launches["forward"], counts
    assert counts.get("groupnorm apply (Triton)", 0) == launches["forward"], counts
    assert counts.get("groupnorm backward (CUDA)", 0) == launches["backward"], counts
    assert counts.get("vq assign (CUDA)", 0) == launches["vq"], counts
    print(f"  {name} train step: {n} kernel launches")
    del loop


def train_step_card_vs_cpu(dev, name: str, model_kwargs, launches):
    """One full-width VQ-VAE training forward and backward (f32, TF32 off)
    at batch 1 of 16384 samples (a multiple of the downsample rate near
    1 s) on the card, through the kernels, and on the CPU, through their
    plain versions, from the same seeded weights and draws: the same codes,
    the loss within 1e-4 relative and each parameter's gradient within
    1e-3 of its largest entry plus 1e-6 of the largest gradient (a bias
    before a GroupNorm has a true gradient of 0)."""
    torch.backends.cudnn.allow_tf32 = False
    model = VQVAE(**model_kwargs)
    seed_weights(model, 11)
    t = 16384
    gen = torch.Generator().manual_seed(12)
    x = torch.from_numpy(speech_like(21, t))[None, :, None]
    with torch.no_grad():
        enc = model.encode_raw(x)
        model.vq.dictionary.copy_(enc.mean(dim=(0, 1)) + model.vq.dictionary * enc.std())
    draws = dict(ts=torch.tensor([0.4]), epsilon=torch.randn(1, t, 1, generator=gen))

    def step(device):
        m = copy.deepcopy(model).to(device)
        t0 = time.perf_counter()
        out = m.losses(x.to(device), labels=torch.tensor([1], device=device), train=True,
                       **{k: v.to(device) for k, v in draws.items()})
        loss = out["mse"] + out["vq_loss"]
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in m.named_parameters()}
        print(f"  full-width {name} train step on {device}: {time.perf_counter() - t0:.3f} s")
        return loss.item(), out["idxs"].cpu(), grads

    cpu_loss, cpu_idxs, cpu_grads = step(torch.device("cpu"))
    reset_counts()
    loss, idxs, grads = step(dev)
    counts = read_counts()
    torch.backends.cudnn.allow_tf32 = True
    top = max(g.abs().max().item() for g in cpu_grads.values())
    worst, worst_name = 0.0, None
    for n, want in cpu_grads.items():
        err = (grads[n] - want).abs().max().item() / (want.abs().max().item() + 1e-3 * top)
        if err > worst:
            worst, worst_name = err, n
    rel = abs(loss - cpu_loss) / abs(cpu_loss)
    print(f"train step card vs CPU, full-width {name}, batch 1 x {t}: loss {loss:.6f} vs "
          f"{cpu_loss:.6f} (rel {rel:.3g}, limit 1e-4), codes equal "
          f"{torch.equal(idxs, cpu_idxs)} ({cpu_idxs.unique().numel()} distinct), worst "
          f"gradient leaf {worst_name}: {worst:.3g} of its scale (limit 1e-3), {len(grads)} "
          f"leaves, launches {counts}")
    assert torch.equal(idxs, cpu_idxs)
    assert rel <= 1e-4 and worst <= 1e-3
    assert counts["group_norm_backward"] == launches["backward"]
    assert counts["group_norm_coeffs"] == launches["forward"]
    assert counts["vq_assign"] == launches["vq"]


def _params_npz(path: str):
    with np.load(path) as data:
        return {k: data[k] for k in data.files if k.startswith("params/")}


def _pred_down_path_size(ckpt: str) -> int:
    """The scalars of a UNet predictor's in_conv, time embeddings and down
    blocks: what a classifier stem of the same widths takes from it."""
    predictor = DiffusionModel.load(ckpt, device="cpu").predictor
    return sum(p.numel() for n, p in predictor.named_parameters()
               if n.split(".")[0] in ("in_conv", "time_embed", "time_embed_extra",
                                      "down_blocks"))


def guidance_training_paths(dev, workdir: str, flagship: str, diffusion: str, smi: str):
    """The four train CLIs that start from a trained model or train a
    guidance network, each a run of its own with its launches asserted and
    a profiled step. Returns {run name: counts}."""
    gn_vqvae = GN_PER_PREDICTOR + GN_PER_ENCODER128
    steps = NEW_TRAIN_STEPS
    pretrained = ["--class-cond", "--pretrained-path", flagship]
    runs = {}
    for name, cli, loop_cls, argv, n_steps, launches in (
        # Only the label table trains: the predictor's first GroupNorm
        # (down block 0's norm_in) sees neither a trained input nor a
        # trained affine, so it runs forward alone; every later one is
        # downstream of the labels' FiLM, and the encoder is frozen.
        ("vqvae add-classes bf16", train_vqvae_add, VQVAEAddClassesTrainLoop,
         NEW_RUN_ARGV + pretrained, steps, per_step(gn_vqvae, GN_PER_PREDICTOR - 1, 1)),
        ("vqvae uncond bf16", train_vqvae_uncond, VQVAEUncondTrainLoop,
         NEW_RUN_ARGV + pretrained, steps, per_step(gn_vqvae, gn_vqvae, 1)),
        # The frozen VQ-VAE's encode runs its encoder's GroupNorms forward.
        ("enc-pred bf16", train_enc_pred, EncoderPredictorTrainLoop,
         NEW_RUN_ARGV + ["--vq-vae-path", flagship], steps,
         per_step(GN_PER_ENC_PRED + GN_PER_ENCODER128, GN_PER_ENC_PRED, 1)),
        ("classifier bf16", train_classifier, ClassifierTrainLoop, NEW_RUN_ARGV, steps,
         per_step(GN_PER_CLASSIFIER, GN_PER_CLASSIFIER, 0)),
        # At the diffusion run's width (unet64), from its checkpoint.
        ("classifier warm bf16", train_classifier, ClassifierTrainLoop,
         NEW_RUN_ARGV + ["--base-channels", _flag(TRAIN_DIFFUSION_ARGV, "--base-channels"),
                         "--pretrained-path", diffusion], 2,
         per_step(GN_PER_CLASSIFIER, GN_PER_CLASSIFIER, 0)),
    ):
        out, full_argv, runs[name], printed = training_run(
            dev, workdir, name, cli, argv, n_steps, launches, smi)
        if "warm" in name:
            want = _pred_down_path_size(diffusion)
            assert f"loaded {want} pre-trained parameters" in printed, want
            print(f"  classifier warm start: {want} scalars copied from the diffusion "
                  f"predictor's down path, as its shapes give")
        else:
            profile_train_step(dev, loop_cls, full_argv, name, launches)
        if "add-classes" in name:
            before, after = _params_npz(flagship), _params_npz(
                os.path.join(out, "model.npz"))
            table = "params/predictor/class_embed/embedding"
            assert before.keys() == after.keys()
            same = [k for k in before if k != table and np.array_equal(before[k], after[k])]
            assert len(same) == len(before) - 1, sorted(set(before) - set(same))
            labels = before[table].shape[0]
            assert np.array_equal(after[table][:labels], before[table])
            moved = np.abs(after[table][labels:] - before[table][:1]).max()
            print(f"  add-classes: {len(same)} of {len(before)} parameter leaves equal to the "
                  f"pretrained ones bit for bit; the label table grew {labels} -> "
                  f"{after[table].shape[0]} rows, its first {labels} unchanged")
            assert moved > 0
        shutil.rmtree(out)
    return runs


def wavegrad_paths(dev, workdir: str, clips: np.ndarray, smi: str):
    """The WaveGrad VQ-VAE at the JAX CLI's default width: train_vqvae in
    bf16 and f32, its checkpoint through sample_vqvae, swap serving in f32,
    and one full-width step on the card against the CPU. Returns
    {run name: counts}."""
    runs = {}
    launches = per_step(0, 0, 1)  # no GroupNorm in this family
    ckpt = None
    for name, argv in (("wavegrad vqvae bf16", TRAIN_WAVEGRAD_ARGV + ["--bf16"]),
                       ("wavegrad vqvae f32", TRAIN_WAVEGRAD_ARGV)):
        out, full_argv, runs[name], _ = training_run(
            dev, workdir, name, train_vqvae, argv, NEW_TRAIN_STEPS, launches, smi)
        profile_train_step(dev, VQVAETrainLoop, full_argv, name, launches)
        ckpt = os.path.join(out, "model.npz")

    src = os.path.join(workdir, "in.wav")
    out_wav = os.path.join(workdir, "out_wavegrad.wav")
    reset_counts()
    t0 = time.perf_counter()
    sample_vqvae.main(["--label", "1", "--input-file", src, "--sample-steps", "10",
                       "--sampler", "dpmpp", "--device", "cuda", ckpt, out_wav])
    torch.cuda.synchronize()
    counts = runs["wavegrad sample_vqvae"] = read_counts()
    frames, data = _wav_frames(out_wav)
    print(f"wavegrad sample_vqvae 10-step DPM++: {time.perf_counter() - t0:.3f} s, {frames} "
          f"samples, peak {np.abs(data).max()}, launches {counts}")
    assert frames == SAMPLES and np.isfinite(data).all()
    assert counts["vq_assign"] == 1
    assert sum(v for k, v in counts.items() if k != "vq_assign") == 0

    model = VQVAE.load(ckpt, device=dev)
    audio = torch.from_numpy(clips[:, :, None]).to(dev)
    labels = torch.arange(BATCH, device=dev) % model.num_labels

    def swap():
        with torch.no_grad():
            return model.decode(model.encode(audio), labels=labels, steps=10,
                                sampler="dpmpp", constrain=True,
                                generator=torch.Generator(device=dev).manual_seed(0))

    swap()  # warm
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = swap()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    assert out.shape == (BATCH, SAMPLES, 1) and torch.isfinite(out).all()
    seconds = sorted(times)[1]
    print(f"serving wavegrad f32 on {smi}: encode + 10-step DPM++ decode of {BATCH} x 4 s "
          f"clips, median {seconds:.4f} s of {[round(r, 4) for r in times]}, real-time "
          f"factor {BATCH * 4 / seconds:.2f}, peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(BATCH, SAMPLES, 1, generator=gen, device=dev)
    cond = torch.randn(BATCH, SAMPLES // 64, model.cond_channels, generator=gen, device=dev)
    ts = torch.full((BATCH,), 0.5, device=dev)
    n, _ = profile_call(lambda: model.predict_eps(x, ts, cond, labels),
                        "wavegrad f32 predictor call")
    print(f"  wavegrad predictor call: {n} kernel launches")
    del model, audio, out
    torch.cuda.empty_cache()
    train_step_card_vs_cpu(dev, "wavegrad", dict(
        pred_name="wavegrad", base_channels=32, enc_name="wavegrad", num_labels=3), launches)
    return runs


def training_paths(dev, workdir: str, clips: np.ndarray, smi: str):
    """The train CLIs at full width, each run's launches counted, a
    profiled step of each, and one step held against the CPU; then the
    other train CLIs from the flagship's and the diffusion run's
    checkpoints, and the WaveGrad family. Returns {run name: counts}."""
    gn_vqvae = GN_PER_PREDICTOR + GN_PER_ENCODER128
    runs, kept = {}, {}
    for name, cli, loop_cls, argv, steps, launches in (
        ("vqvae bf16", train_vqvae, VQVAETrainLoop, TRAIN_VQVAE_ARGV + ["--bf16"],
         TRAIN_STEPS, per_step(gn_vqvae, gn_vqvae, 1)),
        ("vqvae f32", train_vqvae, VQVAETrainLoop, TRAIN_VQVAE_ARGV, TRAIN_STEPS,
         per_step(gn_vqvae, gn_vqvae, 1)),
        ("diffusion bf16", train_diffusion, DiffusionTrainLoop, TRAIN_DIFFUSION_ARGV, 5,
         per_step(GN_PER_PREDICTOR, GN_PER_PREDICTOR, 0)),
    ):
        out, full_argv, runs[name], _ = training_run(dev, workdir, name, cli, argv, steps,
                                                     launches, smi)
        profile_train_step(dev, loop_cls, full_argv, name, launches)
        kept[name] = os.path.join(out, "model.npz")
    torch.cuda.empty_cache()
    train_step_card_vs_cpu(dev, "unet64 + unet128", dict(
        pred_name="unet", base_channels=64, enc_name="unet128", num_labels=3),
        per_step(gn_vqvae, gn_vqvae, 1))
    t0 = time.perf_counter()
    runs.update(guidance_training_paths(dev, workdir, kept["vqvae bf16"],
                                        kept["diffusion bf16"], smi))
    print(f"the other train CLIs: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs.update(wavegrad_paths(dev, workdir, clips, smi))
    print(f"wavegrad: {time.perf_counter() - t0:.1f} s")
    return runs



# ------------------------------------------------------------------ phase 6

# A LibriSpeech-style directory at train-clean-100's speaker count: two
# 6 s utterances a speaker to train on (10 windows each), one 4.5 s file a
# speaker held out (3 windows each); one speaker's files at 22050 Hz.
SPEAKERS = 251
TRAIN_UTTERANCE_S = 6.0
HELD_OUT_S = 4.5
RESAMPLED_SPEAKER = 7
DIRECTORY_STEPS = TRAIN_STEPS  # as the tones flagship, for the same steady steps
STAT_SAMPLES = 256
SWAP_SAMPLES = 32
SWAP_STEPS = 10
SEARCH_TIMESTEPS = 4


def write_librispeech(root: str, chapters: int, seconds: float, seed: int) -> int:
    """<speaker>/<chapter>/<speaker>-<chapter>-0000.wav for SPEAKERS speakers,
    each a speech_like clip of its own seed; returns the number of files."""
    files = 0
    for spk in range(SPEAKERS):
        rate = 22050 if spk == RESAMPLED_SPEAKER else SAMPLE_RATE
        for ch in range(chapters):
            d = os.path.join(root, str(100 + spk), str(ch))
            os.makedirs(d)
            clip = speech_like(seed + 1000 * spk + ch, int(seconds * rate))
            with wave.open(os.path.join(d, f"{100 + spk}-{ch}-0000.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(rate)
                w.writeframes((np.clip(clip, -1, 1) * (2**15 - 1)).astype("<i2").tobytes())
            files += 1
    return files


def audio_io_check(workdir: str) -> None:
    """With ffmpeg, one .flac through ChunkWriter and back through
    ChunkReader; without it, the WAV path alone runs (not a failure)."""
    if not have_ffmpeg():
        print("ffmpeg: not installed; the data phase reads WAV through the stdlib")
        return
    clip = speech_like(3, SAMPLES)
    path = os.path.join(workdir, "clip.flac")
    with ChunkWriter(path, SAMPLE_RATE) as writer:
        writer.write(clip)
    with ChunkReader(path, SAMPLE_RATE) as reader:
        back = reader.read(1 << 40)
    err = np.abs(back[:SAMPLES] - clip).max()
    print(f"ffmpeg: installed; a 4 s .flac written and read back, {len(back)} samples, "
          f"max |diff| {err:.3g} (16-bit rounding: limit 1e-4)")
    assert len(back) == SAMPLES and err <= 1e-4


def build_directories(workdir: str):
    """The train and held-out directories, each indexed and cached as the
    loader does it; prints the seconds each step takes."""
    dirs = {}
    for name, chapters, seconds, seed in (("train", 2, TRAIN_UTTERANCE_S, 0),
                                          ("held_out", 1, HELD_OUT_S, 500000)):
        root = os.path.join(workdir, f"librispeech_{name}")
        t0 = time.perf_counter()
        files = write_librispeech(root, chapters, seconds, seed)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        index = build_file_index(root)
        with open(os.path.join(root, "index.json"), "w") as f:
            json.dump(index, f)
        t_index = time.perf_counter() - t0
        t0 = time.perf_counter()
        dataset = LibriSpeech(root)
        t_cache = time.perf_counter() - t0
        arena = os.path.getsize(dataset.cache.arena_path)
        print(f"directory {name}: {len(dataset.speaker_ids)} speakers, {files} files, "
              f"{arena / 4 / SAMPLE_RATE / 60:.2f} min of audio, {len(dataset)} windows; "
              f"written in {t_write:.3f} s, index.json in {t_index:.3f} s, window cache "
              f"({arena / 1e6:.1f} MB) in {t_cache:.3f} s")
        want = (SPEAKERS * chapters * (10 if name == "train" else 3))
        assert len(dataset.speaker_ids) == SPEAKERS and len(dataset) == want, len(dataset)
        dirs[name] = (root, dataset)
    return dirs


def gather_check(dataset) -> None:
    """One batch of BATCH windows through the built C gather against the
    numpy loop, bit for bit, each timed."""
    refs = [(w.path, w.offset) for w in np.random.RandomState(0).choice(
        dataset.windows, BATCH, replace=False)]
    cache = dataset.cache
    got = cache.read_windows(refs, SAMPLES)
    want = cache.read_windows(refs, SAMPLES, gather=batch_gather_windows_plain)
    assert got.shape == (BATCH, SAMPLES) and np.array_equal(got, want)
    times = {}
    for name, gather in (("C", batch_gather_windows), ("numpy", batch_gather_windows_plain)):
        runs = []
        for _ in range(20):
            t0 = time.perf_counter()
            cache.read_windows(refs, SAMPLES, gather=gather)
            runs.append((time.perf_counter() - t0) * 1e3)
        times[name] = float(np.median(runs))
    print(f"window gather, {BATCH} x {SAMPLES} windows from the cache, warm: C "
          f"{times['C']:.4f} ms, numpy {times['numpy']:.4f} ms (medians of 20), equal bit "
          f"for bit")


def median_rate(out: str) -> float:
    """The median samples/s of a train run's steady steps (3 to the one
    before the last), as training_run prints it."""
    return float(np.median([f["samples_per_sec"] for _, f in _train_log(out)[2:-1]]))


def eval_run(dev, name: str, fn, argv, want, units: float, unit: str):
    """One eval CLI's main with the launch counts set to 0 just before it:
    asserts each wrapper's count in ``want`` (and no backward launch),
    prints wall seconds, units per second and peak device memory. Returns
    the counts and what the CLI printed."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout)) as printed:
        fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    print(f"eval {name}: {seconds:.3f} s, {units / seconds:.4f} {unit}, peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, launches {counts}")
    for k, v in want.items():
        assert counts[k] == v, (name, k, counts[k], v)
    assert counts["group_norm_backward"] == counts["group_norm_stats"] == 0
    assert counts["fused_resblock_stats"] == counts["fused_resblock_apply"] == 0
    return counts, printed.getvalue()


def gn_launches(norms: int, vq: int = 0):
    """Forward GroupNorms (one statistics and one apply launch each) and VQ
    assigns of an eval path."""
    return dict(group_norm_coeffs=norms, group_norm_apply=norms, vq_assign=vq)


def features_card_vs_cpu(dev, clf_ckpt: str, held_out) -> None:
    """One stat_generate batch of the base-32 classifier, f32 with TF32 off,
    on the card (kernels) and on the CPU (plain versions): features and
    probabilities within 1e-4 of their largest entry."""
    torch.backends.cudnn.allow_tf32 = False
    batch = torch.from_numpy(held_out.get_batch(np.arange(BATCH))["samples"])
    outs = {}
    for device in ("cpu", dev):
        model = ClassifierModel.load(clf_ckpt, device=device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            outs[str(device)] = [o.cpu() for o in stat_generate.featurize(
                model, batch.to(device))]
        print(f"  stat_generate batch of {BATCH} on {device}: {time.perf_counter() - t0:.3f} s")
    torch.backends.cudnn.allow_tf32 = True
    errs = [((g - w).abs().max() / w.abs().max()).item()
            for g, w in zip(outs[str(dev)], outs["cpu"])]
    print(f"classifier features card vs CPU, base 32, batch {BATCH} x {SAMPLES}, f32: "
          f"features {errs[0]:.3g}, probabilities {errs[1]:.3g} of their largest entry "
          f"(limit 1e-4)")
    assert max(errs) <= 1e-4


def data_eval_paths(dev, workdir: str, smi: str, flagship: str, uncond_ckpt: str,
                    clf_ckpt: str):
    """Real-audio data and the six eval CLIs at full width: the directories,
    a train run on them beside the tones flagship's, the gather, each eval
    CLI with its launches asserted, and the classifier card against CPU.
    Returns {run name: counts}."""
    audio_io_check(workdir)
    dirs = build_directories(workdir)
    train_dir, train_set = dirs["train"]
    held_dir, held_set = dirs["held_out"]

    gn_vqvae = GN_PER_PREDICTOR + GN_PER_ENCODER128
    argv = [train_dir] + TRAIN_VQVAE_ARGV[1:] + ["--bf16"]
    out, _, counts, _ = training_run(dev, workdir, "vqvae bf16 librispeech", train_vqvae,
                                     argv, DIRECTORY_STEPS, per_step(gn_vqvae, gn_vqvae, 1),
                                     smi)
    runs = {"train_vqvae librispeech": counts}
    ckpt = os.path.join(out, "model.npz")
    print(f"training on the directory ({SPEAKERS} labels) vs {TRAIN_VQVAE_ARGV[0]} (3 "
          f"labels), both bf16 batch {BATCH} in this call: {median_rate(out):.4f} vs "
          f"{median_rate(os.path.dirname(flagship)):.4f} samples/s")
    gather_check(train_set)

    stats_data = os.path.join(workdir, "stats_data.npz")
    batches = STAT_SAMPLES // BATCH
    runs["stat_generate data"], _ = eval_run(dev, "stat_generate --data-dir", stat_generate.main, [
        "--checkpoint-path", clf_ckpt, "--data-dir", held_dir, "--num-samples",
        str(STAT_SAMPLES), "--batch-size", str(BATCH), "--device", "cuda", stats_data],
        gn_launches(GN_PER_CLASSIFIER * batches), STAT_SAMPLES, "segments/s")

    swap_dir = os.path.join(workdir, "swap_eval")
    swap_batches = SWAP_SAMPLES // BATCH
    runs["swap_eval"], printed = eval_run(dev, "swap_eval", swap_eval.main, [
        "--num-samples", str(SWAP_SAMPLES), "--batch-size", str(BATCH), "--sample-steps",
        str(SWAP_STEPS), "--sampler", "dpmpp", "--device", "cuda", flagship, swap_dir],
        gn_launches((2 * GN_PER_ENCODER128 + SWAP_STEPS * GN_PER_PREDICTOR) * swap_batches,
                    2 * swap_batches), SWAP_SAMPLES * 4, "s of audio per s (swap RTF)")
    report = json.loads(printed.strip().splitlines()[-1])
    assert report["n"] == SWAP_SAMPLES and all(np.isfinite(v) for v in report.values())

    stats_swap = os.path.join(workdir, "stats_swap.npz")
    runs["stat_generate samples"], _ = eval_run(dev, "stat_generate --sample-dir",
                                                stat_generate.main, [
        "--checkpoint-path", clf_ckpt, "--sample-dir", swap_dir, "--batch-size", str(BATCH),
        "--device", "cuda", stats_swap],
        gn_launches(GN_PER_CLASSIFIER * swap_batches), SWAP_SAMPLES, "segments/s")
    with contextlib.redirect_stdout(_Tee(sys.stdout)) as printed:
        stat_compare.main([stats_data, stats_swap])
    distance = float(printed.getvalue().strip().splitlines()[-1])
    with np.load(stats_data) as a, np.load(stats_swap) as b:
        scores = float(a["class_score"]), float(b["class_score"])
        assert a["probs"].shape == (STAT_SAMPLES, CLASSIFIER_KWARGS["num_labels"])
    print(f"stat_compare held-out data vs swap_eval samples: Frechet distance {distance}, "
          f"class scores {scores[0]:.4f} / {scores[1]:.4f} (seeded weights: not a quality "
          f"number)")
    assert np.isfinite(distance) and distance >= 0

    held_batches = len(held_set) // BATCH
    runs["eval_diffusion"], _ = eval_run(dev, "eval_diffusion", eval_diffusion.main, [
        "--batch-size", str(BATCH), "--device", "cuda", uncond_ckpt, held_dir],
        gn_launches(GN_PER_PREDICTOR * held_batches), held_batches * BATCH, "segments/s")

    runs["eval_vqvae"], _ = eval_run(dev, "eval_vqvae", eval_vqvae.main, [
        "--batch-size", str(BATCH), "--device", "cuda", ckpt, held_dir],
        gn_launches((GN_PER_ENCODER128 + 2 * GN_PER_PREDICTOR) * held_batches, held_batches),
        held_batches * BATCH, "segments/s")

    pairs = SPEAKERS * SEARCH_TIMESTEPS
    calls = -(-pairs // BATCH)
    clip = held_set.windows[0].path
    runs["voice_search_vqvae"], printed = eval_run(dev, "voice_search_vqvae",
                                                   voice_search_vqvae.main, [
        "--num-timesteps", str(SEARCH_TIMESTEPS), "--batch-size", str(BATCH), "--top-k", "5",
        "--input-file", clip, "--device", "cuda", ckpt],
        gn_launches(GN_PER_ENCODER128 + calls * GN_PER_PREDICTOR, 1), pairs,
        f"(label, t) pairs/s ({calls} predictor calls)")
    assert f"{pairs}/{pairs}" in printed

    features_card_vs_cpu(dev, clf_ckpt, held_set)
    return runs


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
    kernels.append(check_group_norm_backward(dev, gen))
    check_group_norm_training_grads(dev, gen)
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
        ep_ckpt, clf_ckpt = guidance_checkpoints(workdir)
        guided = guided_paths(dev, workdir, ckpt, uncond_ckpt, ep_ckpt, clf_ckpt)
        for k in kernels:
            if k["name"] == "group_norm_backward":  # the two differentiating paths
                k["launches"] = sum(c["_bwd_cluster"] for c in guided.values())
                continue
            path = sampling_launches if k["name"].startswith("fused") else swap_launches
            k["launches"] = sum(path[w] for w in KERNEL_WRAPPERS.get(k["name"], (k["name"],)))
        print(f"phase 3: {time.perf_counter() - t_start:.1f} s")
        serving_time(dev, ckpt, clips, smi)
        sampling_serving_time(dev, uncond_ckpt, smi)
        guided_serving_time(dev, ckpt, uncond_ckpt, ep_ckpt, clf_ckpt, clips, smi)
        check_tickets("the main paths and serving")
        print(f"phase 4: {time.perf_counter() - t_start:.1f} s")
        # Training last: its runs and profiles come after the serving
        # phases' profiler checks, as they did before training was ported.
        training = training_paths(dev, workdir, clips, smi)
        print("training launches, all runs: " + ", ".join(
            f"{k} {sum(c[k] for c in training.values())}" for k in (
                "vq_assign", "group_norm_coeffs", "group_norm_apply", "group_norm_backward")))
        check_tickets("the training paths")
        print(f"phase 5: {time.perf_counter() - t_start:.1f} s")
        # Real-audio data and eval, from the tones flagship's bf16 run
        # (training_run's directory for "vqvae bf16"), phase 3's
        # unconditional unet64 and classifier.
        flagship = os.path.join(workdir, "vqvae_bf16", "model.npz")
        evals = data_eval_paths(dev, workdir, smi, flagship, uncond_ckpt, clf_ckpt)
        print(f"phase 6: {time.perf_counter() - t_start:.1f} s")
        print("data and eval launches, all runs: " + ", ".join(
            f"{k} {sum(c[k] for c in evals.values())}" for k in (
                "vq_assign", "group_norm_coeffs", "group_norm_apply", "group_norm_backward")))
    check_tickets("the data and eval paths")
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
