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
   (512 channels, 512 codes, 1000 and 16000 rows). The statistics kernel
   at one group of 17.2 M elements ([1, 4, 4300000], beyond 2^24), f32 and
   bf16, against float64 statistics, with the apply kernel and the
   two-kernel backward there; the split backward (reduce, dx) of two
   shards, their sums added as the sequence-parallel all-reduce adds
   them, against the plain backward of the whole input at [2, 128, 64000]
   and [3, 20, 334], at one shard the two-kernel route's bits, timed at
   [2, 128, 64000] f32 beside its bound, the one-device route, the plain
   version and native_group_norm_backward. The int8 serving path's
   kernels against their plain versions, bit for bit: the int8
   convolution (CUDA, int8 tensor cores) at [16, 64, 64000] 64 -> 64, 3
   taps, dilations 1 and 2 (f32 and bf16 out), [16, 128, 64000] 128 -> 64,
   the 1x1 128 -> 64 projection with a per-channel scale, [16, 128, 16000]
   128 -> 128 and [3, 8, 1000] -> 12 at dilation 32 (the plain version a
   float64 convolution of the codes, exact), f32 and bf16 out, and [16,
   256, 16000] 256 -> 128; the quantize kernels (Triton) of f32, bf16 and
   zero input, and at each prologue (the GroupNorm apply on int8 input
   and on float input with FiLM, the residual add with an int8 and a
   float skip), f32 and bf16 at [16, 64, 64000], against the unfused card
   route (the Triton apply or the eager add, then quantize) and their
   plain versions, codes and scale bit for bit; quantize-then-upsample
   against upsample-then-quantize; the int8 GroupNorm statistics kernel
   (exact integer sums) against its plain version
   (``group_norm_coeffs_int8_plain``) at [16, 64, 64000] with a per-tensor
   scale (group mean and var bit for bit) and [16, 128, 64000] with a
   per-channel one (within one float32 ulp), a and b within 1e-6, both
   timed beside their bounds, and the apply kernel's int8 mode (1e-4);
   each timed beside its bound and plain version (a fused quantize also
   beside the unfused route; the bf16 cuDNN conv1d of the same shape
   printed as a different function, for scale). The serving bf16
   convolution (CUDA, ``csrc/conv1d_bf16.cu``): the shapes one bf16 swap
   predictor call routes to it read off the call (79 convolutions,
   asserted), each at batch 64 on the call's seeded layer against its plain
   version on the card (cuDNN, then the bias add) within 1.5 bf16 ulps of
   the larger of |sum| and |out| and against the float32 reference rounded
   once within one ulp (each plus four times the float32 summation bound),
   twice for the same bits; timed at [64, 64, 64000] 64 -> 64 d2 beside its
   bound, its plain version and cuDNN with the weight cast once. Every
   ticket counter
   (ops/tickets.py) is 0 after this phase, after phase 4 and after the
   last.
3. Main paths, each with every launch count set to 0 just before it and
   read just after. The swap: a full-width VQ-VAE (unet64 predictor,
   conv-mfcc-ulaw encoder, 512 x 1024 codebook, 251 labels) on seeded
   weights is saved in the JAX .npz format and driven through
   ``python -m vq_voice_swap_torch.sample_vqvae``'s ``main`` on a 4 s WAV,
   with DPM++ (10 steps) and DDPM (5 steps); asserts 64000 output samples
   and the launch counts (VQ once per encode, GroupNorm statistics and
   apply 131 each per predictor call, no bf16 convolution kernel in
   float32). Unconditional sampling: a
   full-width unet64 DiffusionModel on seeded weights, saved as .npz,
   driven through
   ``python -m vq_voice_swap_torch.sample_diffusion``'s ``main`` in bf16
   with --fuse-levels 2, 5 quadratic-warped DDPM steps, 2 samples; asserts
   two 4 s WAVs, 10 launches of each fused kernel per step and 53 of the
   serving bf16 convolution (``CONV_BF16_PER_FUSED_PREDICTOR``); then one
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
   convolutions, PyTorch's default) and bf16 (the warm run's launches of
   the serving bf16 convolution asserted: 79 a predictor call in bf16, none
   in f32), a torch.profiler breakdown
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
   each run and read just after), each CLI's ``main`` or its loop
   spelled out as ``main`` runs it: ``train_vqvae`` on the JAX package's
   training flagship (``tones:40``, unet64 predictor, unet128 encoder, 512 x 1024 codebook,
   class-conditional, batch 16 of 4 s) for 8 steps in bf16, then in f32,
   and ``train_diffusion`` (unet64, class-conditional, bf16, batch 16) for
   5; each run's samples/s (the median of the steady steps), peak device
   memory, and launches asserted (per step, every GroupNorm one statistics,
   one apply and one cluster backward launch: 178 for the VQ-VAE, 131 for
   the diffusion model; one VQ assign per VQ-VAE step); one more step of
   each run profiled (the first resumed from its save, the others from the
   loop the run kept: a resume reads ~1 GB), its GroupNorm and VQ launches
   asserted from the profiler; then one full-width VQ-VAE step (f32, TF32
   off, batch 1 x 8192) on the card against the same step on the CPU
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
   CPU as above. Then the single-device train flags: the bf16 flagship
   for 8 steps at ``--steps-per-dispatch 4`` (its forwards and backward
   replayed from a CUDA graph; a wrapper counts the warm-up and the
   capture, and a profiled replay shows 1 VQ and 178 of each GroupNorm
   launch a step) against the eager run above and a second eager run,
   then an eager and a K=4 run with deterministic algorithms, which must
   agree bit for bit (logged values, model, EMA, AdamW moments); the
   samples/s, busy share, launches and peak memory of both; the other
   five loops at K=4 for one window each, with a profiled replay
   (add-classes, uncond, enc-pred with ``--async-save --async-snapshot
   device``, the classifier with ``--async-save``, whose markers and files
   are checked, and WaveGrad with ``--profile-dir``, whose trace is read);
   ``--grad-checkpoint full`` and ``convs`` on the flagship (bf16 at K=1
   and K=4, f32 at K=1: peak memory and samples/s against none, 354
   GroupNorm forward launches a step) and one full-width step's
   gradients against none (1e-4 f32, 2e-2 bf16 of each leaf's scale).
   Last, phase 3's swap model written as a released-reference ``.pt``
   loads through ``ModelBase.load`` and swaps to the npz's bits.
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

7. Data parallelism and FSDP (``parallel_paths``): the bf16 flagship
   without the launcher, under torchrun at world size 1 (DP, FSDP, DP at
   K=4) and on two gloo ranks sharing the card (DP, FSDP with a dcp save),
   the three launches running together; the same bits or losses within
   1e-2, launches a rank, state bytes.
8. Tensor parallelism (``tensor_parallel_paths``): one torchrun launch of
   4 gloo ranks sharing the card, 2 data rows x 2 model columns, each rank
   through the CLIs' ``main`` or the train loop with --tensor-parallel 2:
   phase 3's swap (f32, TF32 off, 4 DPM++ steps; codes equal, samples
   within 1e-3 of the world-1 run's largest magnitude), bf16 sampling at
   --fuse-levels 2 (2 samples split over the data rows, 3 steps; the
   world-1 files, within 1e-1), the bf16 flagship at global batch 4 for 2
   steps with deterministic algorithms, with and without --fsdp (losses
   within 1e-2 of the world-1 run's), one more profiled step; every
   rank's launches equal to the world-1 run's, state bytes a rank equal to
   the placements' count; wall seconds, rates and peak memory a rank.
   Its ranks start after phase 4 and work beside phase 5, phase 9's
   beside phase 6, then both phases' world-1 runs run here and phase 7
   follows, alone: the host's cores, not the card, bound these phases,
   and this process uses few of them. So the rates and profiles of
   phases 5, 6, 8 and 9 are taken while the card is shared.
9. Sequence parallelism (``sequence_parallel_paths``): one torchrun launch
   of 4 gloo ranks sharing the card, each holding a quarter of the time
   axis: ``long_audio_convert`` of a 300 s speech-like clip with the
   seeded flagship VQ-VAE (unet64 predictor, unet128 encoder, f32, TF32
   off, 10 DPM++ steps; encoder outputs within 1e-4 and samples within
   1e-3 of the world-1 run's largest magnitude, codes equal but at
   near-ties, two codes' distances within 1e-4 relative, the samples then
   held to one device's decode of the sharded run's codes) and 2 steps of
   ``make_seq_parallel_train_step`` on the seeded unet64 diffusion model
   at batch 2 of 16 s (losses within 1e-3 relative), each beside its
   world-1 run in this process (which converts the clip on one device,
   GroupNorm groups of 19.2 M elements); every rank's launches asserted
   (statistics and apply a GroupNorm, the split reduce and dx a
   GroupNorm a train step, no coefficients, cluster or fused launch);
   wall seconds, RTF, peak memory and collectives a rank.
10. int8 activations (``int8_serving_paths``): ``sample_diffusion --bf16
   --act-int8 16000`` on phase 3's unconditional unet64 (16 x 4 s, 5 DPM++
   steps) and ``sample_vqvae --act-int8 16000`` on phase 3's swap model
   (f32, 10 DPM++ steps), each with its launches asserted from the code
   (a unet64 call, ``INT8_PER_PREDICTOR``: 61 quantizes of two launches,
   38 of them with the GroupNorm apply and 20 with the residual add
   fused in, 50 int8 convolutions, 21 int8 GroupNorm statistics and 4
   applies, 110 float statistics and 89 applies; in bf16 31 launches of the
   serving bf16 convolution, none in f32), then timed in turns with the same CLI
   without --act-int8, two runs each (RTF of the medians); one predictor
   call at batch 16
   against the same call through the plain versions on the card (every
   float convolution on ``F.conv1d``; held by
   the int8 path's own error: within 1.5 times the L2 distance between the
   plain int8 and the float output, correlation above 0.995 f32 / 0.98
   bf16), one under ``torch.cuda.set_sync_debug_mode("error")`` (no host
   sync), and a profile of one int8 and one float call. Last,
   ``sample_vqvae_uncond --act-int8 16000`` on the swap model (10 DPM++
   steps), its launches asserted.

The line before the last is a JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.
"""

import contextlib
import copy
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import wave

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from kernel_ab import (cuda_ms, eager_ms, predictor_inputs, seed_weights,  # noqa: E402
                       swap_predictor)
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
from vq_voice_swap_torch.models import layers  # noqa: E402
from vq_voice_swap_torch.models.layers import ResBlock  # noqa: E402
from vq_voice_swap_torch.ops import conv1d as c1  # noqa: E402
from vq_voice_swap_torch.ops import cuda_build  # noqa: E402
from vq_voice_swap_torch.ops import fused_resblock as frb  # noqa: E402
from vq_voice_swap_torch.ops import group_norm as gn  # noqa: E402
from vq_voice_swap_torch.ops import qact  # noqa: E402
from vq_voice_swap_torch.ops import vq_assign as vqa  # noqa: E402
from vq_voice_swap_torch.ops.tickets import ticket_buffers  # noqa: E402
from vq_voice_swap_torch.observe import Logger  # noqa: E402
from vq_voice_swap_torch.train import (  # noqa: E402
    ClassifierTrainLoop,
    DiffusionTrainLoop,
    EncoderPredictorTrainLoop,
    VQVAEAddClassesTrainLoop,
    VQVAETrainLoop,
    VQVAEUncondTrainLoop,
)
from vq_voice_swap_torch.train.graphs import WARMUP_STEPS  # noqa: E402
from vq_voice_swap_torch.train.loops import step_generator  # noqa: E402
from vq_voice_swap_torch.vq_vae import VQVAE  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet), at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense tensor cores
TF32_FLOP_PER_S = 495e12  # dense tensor cores
INT8_OP_PER_S = 1979e12  # dense tensor cores

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
# Launches of the serving bf16 convolution (ops/conv1d.py's rule) a unet64
# predictor call at 4 s: 79 of its 163 convolutions (every one with Cin up
# to 192, the 3-tap 256 -> 128); 53 with fuse_levels=2 (the fused blocks'
# convolutions leave); 31 at --act-int8 16000 (the levels at T <= 8000,
# in_conv and out_conv). None in the conv-MFCC encoder.
CONV_BF16_PER_PREDICTOR = 79
CONV_BF16_PER_FUSED_PREDICTOR = 53
CONV_BF16_PER_INT8_PREDICTOR = 31
CONV_BF16_BATCH = 64  # the swap cell's batch
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


def float32_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in ulps of want rounded to float32."""
    w32 = want.float().abs()
    ulp = torch.nextafter(w32, torch.full_like(w32, float("inf"))) - w32
    return ((got.double() - want.double()).abs() / ulp.double()).max().item()


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


# A group of more than 2^24 elements, where a float32 count stops being
# exact: one group of [1, 4, 4300000] spans 17.2 M elements (the span of
# unet64's first up level, four channels a group, at 4.5 minutes of audio).
LONG_SPAN = (1, 4, 4_300_000)


def _stats64(x: torch.Tensor, groups: int):
    """Two-pass float64 group (mean, var) [N, G]."""
    x = x.double().reshape(x.shape[0], groups, -1)
    mean = x.mean(dim=-1)
    return mean, torch.square(x - mean[..., None]).mean(dim=-1)


def check_group_norm_long_span(dev, gen) -> None:
    """The statistics kernel as (mean, var) and folded with FiLM, the apply
    kernel and the two-kernel backward at LONG_SPAN, f32 and bf16, against
    the float64 statistics and the plain versions."""
    n, c, t = LONG_SPAN
    eps = 1e-5
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = (torch.randn(LONG_SPAN, generator=gen, device=dev) + 0.5).to(dtype)
        dy = torch.randn(LONG_SPAN, generator=gen, device=dev).to(dtype)
        w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
        b = 0.2 * torch.randn(c, generator=gen, device=dev)
        film = tuple((0.5 * torch.randn(n, 2 * c, generator=gen, device=dev)).to(dtype)
                     .chunk(2, dim=-1))
        mean64, var64 = _stats64(x, 1)
        mean_k, var_k = gn.group_norm_stats(x, 1)
        e_mean = (mean_k.double() - mean64).abs().max().item()
        e_var = ((var_k.double() - var64).abs() / var64).max().item()
        folded = gn.fold_affine(mean64.float(), var64.float(), w, b, eps, film)
        coeffs = gn.group_norm_coeffs(x, 1, w, b, eps, film)
        e_coef = max(((k - p).abs() / p.abs().clamp(min=1.0)).max().item()
                     for k, p in zip(coeffs, folded))
        e_apply = out_err(gn.group_norm_apply(x, *coeffs, True),
                          gn.group_norm_apply_plain(x, *folded, True))
        route = gn.bwd_route(x, 1)
        got = gn.group_norm_backward(x, dy, 1, w, b, eps, True, film)
        want = gn.group_norm_backward_plain(x, dy, 1, w, b, eps, True, film)
        e_dx = out_err(got[0], want[0])
        e_s = max(((g - v).abs().max() / v.abs().max()).item()
                  for g, v in zip(got[1:], want[1:]))
        stats_ms = cuda_ms(lambda: gn.group_norm_stats(x, 1), 10)
        sb, sby = bound_ms(x.numel() * x.element_size(), 4 * x.numel())
        torch.cuda.synchronize()
        print(f"groupnorm long span {list(LONG_SPAN)} {str(dtype)[6:]} (one group of "
              f"{c * t} elements, above 2^24 = {1 << 24}): mean err {e_mean:.3g} and var rel "
              f"err {e_var:.3g} against float64 (limits 1e-5, 1e-4), (mean, a, b) with FiLM "
              f"rel err {e_coef:.3g} (1e-4), apply+GELU err {e_apply:.3g} ({tol}); backward "
              f"route {route.name}, dx err {e_dx:.3g} ({tol}), S1/S2 err {e_s:.3g} (1e-4); "
              f"(mean, var) {stats_ms:.4f} ms, {100 * sb / stats_ms:.1f}% of its bound "
              f"{sb:.4f} by {sby}")
        assert e_mean <= 1e-5 and e_var <= 1e-4 and e_coef <= 1e-4, dtype
        assert e_apply <= tol and e_dx <= tol and e_s <= 1e-4 and route.name == "two_kernel"
        del x, dy, got, want, coeffs
    torch.cuda.empty_cache()


def _split_backward(shards, groups, stats, w, b, eps, use_gelu, film):
    """The sequence-parallel backward of a group cut into ``shards`` (x,
    dy pairs along T): each shard's reduce, their sums (the all-reduce),
    then each shard's dx with the whole group's count. (dx, S1, S2)."""
    sums = [gn.group_norm_bwd_reduce(x, dy, groups, *stats, w, b, eps, use_gelu, film)
            for x, dy in shards]
    s1, s2 = (torch.stack(v).sum(dim=0) for v in zip(*sums))
    count = shards[0][0].shape[1] // groups * sum(x.shape[2] for x, _ in shards)
    dx = torch.cat([gn.group_norm_bwd_dx(x, dy, groups, *stats, w, b, eps, use_gelu, film,
                                         s1, s2, count) for x, dy in shards], dim=-1)
    return dx, s1, s2


def check_group_norm_split_backward(dev, gen):
    """The split backward (reduce, then dx; ``parallel/sequence.py``'s
    route, the all-reduce between them simulated by summing two shards'
    partials) against group_norm_backward_plain of the whole input, at
    phase 9's training shape a rank at unet64's first up level ([2, 128,
    64000], four channels a group) and an odd T with 5 channels a group,
    f32 and bf16, with and without FiLM and GELU; at one shard it is the
    two-kernel route's bits. Timed at [2, 128, 64000] f32, no FiLM, no
    GELU, beside the one-device routes, the plain version and
    native_group_norm_backward. Returns the JSON entry."""
    eps, err = 1e-5, 0.0
    for shape, groups in (((2, 128, SAMPLES), 32), ((3, 20, 334), 4)):
        n, c, t = shape
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x = (torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
            dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
            w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
            b = 0.2 * torch.randn(c, generator=gen, device=dev)
            proj = (0.5 * torch.randn(n, 2 * c, generator=gen, device=dev)).to(dtype)
            stats = gn.group_norm_stats(x, groups)
            halves = [(u.contiguous(), v.contiguous())
                      for u, v in zip(x.chunk(2, dim=-1), dy.chunk(2, dim=-1))]
            for film in (None, tuple(proj.chunk(2, dim=-1))):
                for use_gelu in (False, True):
                    got = _split_backward(halves, groups, stats, w, b, eps, use_gelu, film)
                    want = gn.group_norm_backward_plain(x, dy, groups, w, b, eps, use_gelu,
                                                        film, stats)
                    one = _split_backward([(x, dy)], groups, stats, w, b, eps, use_gelu, film)
                    two = gn._launch_bwd(x, dy, groups, *stats, w, b, eps, use_gelu, film,
                                         gn.BwdRoute("two_kernel", *gn.bwd_slices(x)))
                    torch.cuda.synchronize()
                    e_dx = out_err(got[0], want[0])
                    e_s = max(((g - v).abs().max() / v.abs().max()).item()
                              for g, v in zip(got[1:], want[1:]))
                    same = all(torch.equal(u, v) for u, v in zip(one, two))
                    print(f"groupnorm split backward {list(shape)} {str(dtype)[6:]} "
                          f"film={film is not None} gelu={use_gelu}, two shards: dx err "
                          f"{e_dx:.3g} (limit {tol}), S1/S2 err {e_s:.3g} (1e-4); one shard: "
                          f"the two-kernel route's bits {same}")
                    assert e_dx <= tol and e_s <= 1e-4 and same, (shape, dtype)
                    if dtype == torch.float32:
                        err = max(err, (got[0] - want[0]).abs().max().item())
            del x, dy, halves

    n, c, t, groups = 2, 128, SAMPLES, 32
    x = torch.randn((n, c, t), generator=gen, device=dev)
    dy = torch.randn((n, c, t), generator=gen, device=dev)
    w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    b = 0.2 * torch.randn(c, generator=gen, device=dev)
    stats = gn.group_norm_stats(x, groups)
    _, mean, rstd = torch.ops.aten.native_group_norm(x, w, b, n, c, t, groups, eps)
    count = c // groups * t
    split_ms = cuda_ms(lambda: gn.group_norm_bwd_dx(
        x, dy, groups, *stats, w, b, eps, False, None,
        *gn.group_norm_bwd_reduce(x, dy, groups, *stats, w, b, eps, False, None), count), 20)
    reduce_ms = cuda_ms(lambda: gn.group_norm_bwd_reduce(x, dy, groups, *stats, w, b, eps,
                                                         False, None), 20)
    route = gn.bwd_route(x, groups)
    route_ms = cuda_ms(lambda: gn._launch_bwd(x, dy, groups, *stats, w, b, eps, False, None),
                       20)
    plain = cuda_ms(lambda: gn.group_norm_backward_plain(x, dy, groups, w, b, eps, False, None,
                                                         stats), 5)
    lib = cuda_ms(lambda: torch.ops.aten.native_group_norm_backward(
        dy, x, mean, rstd, w, n, c, t, groups, [True, False, False]), 20)
    bnd, by = bound_ms(3 * x.numel() * 4, 15 * x.numel())
    print(f"groupnorm split backward timing {[n, c, t]} f32, no FiLM, no GELU: reduce + dx "
          f"{split_ms:.4f} ms ({100 * bnd / split_ms:.1f}% of its bound {bnd:.4f} by {by}; "
          f"reduce alone {reduce_ms:.4f}, so dx {split_ms - reduce_ms:.4f}; five passes: x "
          f"and dy read twice, dx written), one-device route {route.name} ({route.blocks} "
          f"blocks) {route_ms:.4f} ms, plain {plain:.4f} ms, native_group_norm_backward (dx) "
          f"{lib:.4f} ms; the all-reduce between them is not in these times")
    del x, dy
    torch.cuda.empty_cache()
    return dict(name="group_norm_bwd_split", route="cuda",
                source="vq_voice_swap_torch/csrc/group_norm_bwd.cu",
                replaces="vq_voice_swap_tpu/ops/fused_norm.py:280 (_fgn_bwd; no Pallas "
                         "kernel) under vq_voice_swap_tpu/parallel/sequence.py:146",
                launches=0, max_abs_err=err, ms=split_ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib, reduce_ms=reduce_ms, passes=5,
                one_device_route_ms=route_ms)


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


def conv_int8_plain(qa, weight, bias, stride, dilation, dtype=None):
    """``qact.conv1d_int8``'s plain version end to end: the weight quantized
    as the wrapper quantizes it, then ``conv1d_int8_plain`` (a float64
    convolution of the codes, exact, and the same float32 epilogue)."""
    per_channel = qa.scale.ndim == 1
    kq, w_scale = qact.quantize_weight(weight, qa.scale if per_channel else None)
    return qact.conv1d_int8_plain(qa.q, kq, w_scale, None if per_channel else qa.scale, bias,
                                  stride, dilation, dtype or qa.dtype)


def split_quantize(x: torch.Tensor):
    """x's two channel halves quantized apart and concatenated: a per-channel
    scale, as the up path's skip concat makes it."""
    c = x.shape[1] // 2
    return qact.qact_concat(qact.quantize(x[:, :c].contiguous()),
                            qact.quantize(x[:, c:].contiguous()))


def quantize_sites(dev, gen, n: int, c: int, t: int, dtype):
    """The int8 path's quantize sites at [n, c, t] in ``dtype``, each as
    (label, fused call, the unfused card route's call, the fused call's
    plain version, bytes, operations): the kernels' bound counts each input
    read once and the codes written once."""
    x = 3.0 * torch.randn(n, c, t, generator=gen, device=dev)
    codes = qact.quantize(x + 0.5)
    codes = qact.QAct(codes.q, codes.scale, dtype)
    h = (torch.randn(n, c, t, generator=gen, device=dev) + 0.3).to(dtype)
    w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    b = 0.2 * torch.randn(c, generator=gen, device=dev)
    film = tuple((0.5 * torch.randn(n, c, generator=gen, device=dev)).to(dtype) for _ in "ab")
    int8_coeffs = gn.group_norm_coeffs_int8(codes.q, codes.scale, 32, w, b, 1e-5)
    float_coeffs = gn.group_norm_coeffs(h, 32, w, b, 1e-5, film)
    skip = (2.0 * torch.randn(n, c, t, generator=gen, device=dev)).to(dtype)
    el, size = n * c * t, torch.tensor([], dtype=dtype).element_size()
    return [
        ("norm_in, int8 input", lambda: qact.quantize_group_norm(codes, *int8_coeffs, True),
         lambda: qact.quantize(gn.group_norm_apply_int8(codes.q, codes.scale, *int8_coeffs,
                                                        True, dtype)),
         lambda: qact.quantize_group_norm_plain(codes, *int8_coeffs, True), 2 * el, 30 * el),
        ("norm_mid, FiLM", lambda: qact.quantize_group_norm(h, *float_coeffs, True),
         lambda: qact.quantize(gn.group_norm_apply(h, *float_coeffs, True)),
         lambda: qact.quantize_group_norm_plain(h, *float_coeffs, True), (size + 1) * el,
         30 * el),
        ("residual, int8 skip", lambda: qact.quantize_residual(codes, h),
         lambda: qact.quantize(qact.dequantize(codes, dtype) + h),
         lambda: qact.quantize_residual_plain(codes, h), (size + 2) * el, 6 * el),
        ("residual, float skip", lambda: qact.quantize_residual(skip, h),
         lambda: qact.quantize(skip + h),
         lambda: qact.quantize_residual_plain(skip, h), (2 * size + 1) * el, 5 * el),
        ("no prologue", lambda: qact.quantize(h), lambda: qact.quantize(h),
         lambda: qact.quantize_plain(h), (size + 1) * el, 4 * el),
    ]


def code_gap(got, want) -> float:
    """The share of codes that differ (0.0 when the codes are equal)."""
    return (got.q != want.q).float().mean().item()


def check_int8_kernels(dev, gen):
    """The int8 serving path's kernels against their plain versions on the
    card: the convolution and the plain quantize bit for bit, each fused
    quantize bit for bit against the unfused card route and within one
    code step of its plain version, the int8 GroupNorm statistics' group
    (mean, var) bit for bit (one scale) or within one ulp (one a channel),
    the apply within 1e-4; returns their JSON entries (launches are phase
    10's)."""
    n, t = BATCH, SAMPLES
    cases = [
        # (label, n, cin, cout, t, taps, dilation, per-channel scale)
        ("64->64 d1", n, 64, 64, t, 3, 1, False),
        ("64->64 d2", n, 64, 64, t, 3, 2, False),
        ("128->64", n, 128, 64, t, 3, 1, False),
        ("1x1 128->64, per-channel", n, 128, 64, t, 1, 1, True),
        ("128->128 at 16000", n, 128, 128, t // 4, 3, 1, False),
        ("256->128 at 16000", n, 256, 128, t // 4, 3, 1, False),
        ("8->12 T 1000 d32", 3, 8, 12, 1000, 3, 32, False),
    ]
    conv_err = 0.0
    for label, nn_, cin, cout, tt, taps, dil, per_channel in cases:
        x = torch.randn(nn_, cin, tt, generator=gen, device=dev)
        if per_channel:
            x[:, cin // 2:] *= 20.0
        q0 = split_quantize(x) if per_channel else qact.quantize(x)
        w = torch.randn(cout, cin, taps, generator=gen, device=dev) / (cin * taps) ** 0.5
        b = 0.1 * torch.randn(cout, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            qa = qact.QAct(q0.q, q0.scale, dtype)
            got = qact.conv1d_int8(qa, w, b, dilation=dil)
            again = qact.conv1d_int8(qa, w, b, dilation=dil)
            want = conv_int8_plain(qa, w, b, 1, dil)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs().max().item()
            print(f"int8 conv {label} [{nn_}, {cin}, {tt}] -> {cout}, {taps} taps, "
                  f"{str(dtype)[6:]} out: max |kernel - plain| {diff:.3g}, bit-equal "
                  f"{torch.equal(got, want)}, same bits twice {torch.equal(got, again)}")
            assert torch.equal(got, want) and torch.equal(got, again), (label, dtype)
            conv_err = max(conv_err, diff)
            del got, again, want
        del x, q0

    for label, x in (("f32", torch.randn(n, 64, t, generator=gen, device=dev)),
                     ("bf16", torch.randn(n, 64, t, generator=gen, device=dev).to(
                         torch.bfloat16)),
                     ("zero", torch.zeros(n, 64, t, device=dev))):
        got, want = qact.quantize(x), qact.quantize_plain(x)
        torch.cuda.synchronize()
        same = torch.equal(got.q, want.q) and torch.equal(got.scale, want.scale)
        print(f"quantize {label} [{n}, 64, {t}]: codes and scale bit-equal {same}, "
              f"scale {got.scale.item():.6g}")
        assert same, label
    # Each fused quantize against the unfused card route (the Triton apply
    # or the eager add, then quantize), bit for bit, and against its plain
    # version (torch's GELU rounds otherwise than the kernels' erf, and the
    # plain route rounds unfused): the scale within 1e-6, codes at most one
    # step apart and at most 1e-5 of them differing; timed beside the
    # unfused route, its bound and its plain version. max_abs_err is the
    # largest |dequantized kernel - dequantized plain| of the entry point.
    entries, errs = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, fused, unfused, plain, nbytes, ops in quantize_sites(dev, gen, n, 64, t,
                                                                        dtype):
            got, route, want = fused(), unfused(), plain()
            torch.cuda.synchronize()
            gap = code_gap(got, route)
            step = (got.q.int() - want.q.int()).abs()
            gap_plain, step_max = (step > 0).float().mean().item(), step.max().item()
            scale_rel = ((got.scale - want.scale).abs() / want.scale).item()
            err = (qact.dequantize(got) - qact.dequantize(want)).abs().max().item()
            del step
            print(f"quantize {label} [{n}, 64, {t}] {str(dtype)[6:]}: against the unfused "
                  f"card route: scale bits equal {torch.equal(got.scale, route.scale)}, "
                  f"codes that differ {gap:.3g}; against the plain version: scale "
                  f"{scale_rel:.3g} relative apart, codes that differ {gap_plain:.3g} (at "
                  f"most {step_max} step), max |dequantized kernel - plain| {err:.3g}")
            assert torch.equal(got.scale, route.scale) and gap == 0.0, (label, dtype)
            assert scale_rel <= 1e-6 and step_max <= 1 and gap_plain <= 1e-5, (
                label, dtype, scale_rel, step_max, gap_plain)
            ms = cuda_ms(fused, 20)
            route_ms = cuda_ms(unfused, 20)
            plain_ms = cuda_ms(plain, 5)
            qb, qby = bound_ms(nbytes, ops)
            print(f"quantize timing {label} [{n}, 64, {t}] {str(dtype)[6:]}: {ms:.4f} ms, two "
                  f"launches ({100 * qb / ms:.1f}% of its bound {qb:.4f} by {qby}; the unfused "
                  f"card route {route_ms:.4f}; plain {plain_ms:.4f})")
            name = {"norm": "quantize_group_norm", "resi": "quantize_residual",
                    "no p": "quantize"}[label[:4]]
            errs[name] = max(errs.get(name, 0.0), err)
            if dtype == torch.float32 and all(e["name"] != name for e in entries):
                entries.append(dict(
                    name=name, route="triton", source="vq_voice_swap_torch/ops/qact.py",
                    replaces="vq_voice_swap_tpu/ops/qact.py:67", launches=0,
                    max_abs_err=None, ms=ms, plain_ms=plain_ms, bound_ms=qb, bound_by=qby,
                    library_ms=None))
            del got, route, want
    for entry in entries:
        entry["max_abs_err"] = errs[entry["name"]]
    # A nearest upsample commutes with the quantize: quantize then repeat
    # the codes, as the up path's norm_in does.
    x = torch.randn(n, 64, t // 2, generator=gen, device=dev)
    up = qact.qact_upsample(qact.quantize(x), 2)
    ref = qact.quantize(layers.nearest_upsample_1d(x, 2))
    assert torch.equal(up.q, ref.q) and torch.equal(up.scale, ref.scale)
    print("quantize then upsample the codes: upsample then quantize's bits")
    del x, up, ref

    # The int8 statistics kernel against its plain version, the same
    # exact integer sums and float64 steps: group mean and var bit-equal
    # with one scale, within one float32 ulp with one a channel, a and b
    # within 1e-6 (rsqrtf against torch.rsqrt); each scale mode timed
    # beside its bound (the codes read once, the coefficients written once).
    err_stats = err_apply = 0.0
    stats_timing = {}
    for label, c, per_channel in (("per-tensor", 64, False), ("per-channel", 128, True)):
        x = torch.randn(n, c, t, generator=gen, device=dev) + 0.5
        if per_channel:
            x[:, c // 2:] *= 9.0
        qa = split_quantize(x) if per_channel else qact.quantize(x)
        w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
        b = 0.2 * torch.randn(c, generator=gen, device=dev)
        *coeffs, mean, var = gn.group_norm_coeffs_int8(qa.q, qa.scale, 32, w, b, 1e-5, True)
        *plain, pmean, pvar = gn.group_norm_coeffs_int8_plain(qa.q, qa.scale, 32, w, b, 1e-5,
                                                              True)
        torch.cuda.synchronize()
        ulps = max(float32_ulps(mean, pmean), float32_ulps(var, pvar))
        same = torch.equal(mean, pmean) and torch.equal(var, pvar)
        e_rel = max(((k - p).abs() / p.abs().clamp(min=1e-30)).max().item()
                    for k, p in zip(coeffs, plain))
        e_coef = max(((k - p).abs() / p.abs().clamp(min=1.0)).max().item()
                     for k, p in zip(coeffs, plain))
        print(f"int8 groupnorm statistics {label} [{n}, {c}, {t}]: group mean and var "
              f"bit-equal to the plain version {same} (at most {ulps:g} float32 ulp apart), "
              f"(mean, a, b) largest relative gap {e_rel:.3g}")
        assert (ulps <= 1.0 if per_channel else same) and e_rel <= 1e-6, (label, ulps, e_rel)
        err_stats = max(err_stats, e_coef)
        sms = cuda_ms(lambda: gn.group_norm_coeffs_int8(qa.q, qa.scale, 32, w, b, 1e-5), 20)
        splain = cuda_ms(lambda: gn.group_norm_coeffs_int8_plain(qa.q, qa.scale, 32, w, b,
                                                                 1e-5), 5)
        sb, sby = bound_ms(qa.q.numel() + 3 * 4 * n * c, 3 * qa.q.numel(), INT8_OP_PER_S)
        print(f"int8 groupnorm statistics timing {label} [{n}, {c}, {t}]: {sms:.4f} ms "
              f"({100 * sb / sms:.1f}% of its bound {sb:.4f} by {sby}; plain {splain:.4f})")
        stats_timing[label] = (sms, splain, sb, sby)
        for dtype in (torch.float32, torch.bfloat16):
            y = gn.group_norm_apply_int8(qa.q, qa.scale, *plain, True, dtype)
            y_p = gn.group_norm_apply_plain(qact.dequantize(qa), *plain, True).to(dtype)
            e_apply = out_err(y, y_p)
            print(f"int8 groupnorm apply {label} [{n}, {c}, {t}] -> {str(dtype)[6:]}: "
                  f"apply+gelu err {e_apply:.3g}")
            assert e_apply <= (1e-4 if dtype == torch.float32 else 2e-2)
            if dtype == torch.float32:
                err_apply = max(err_apply, e_apply)
        del x, qa, y, y_p

    # Timing at the top level's shapes: [16, 64, 64000] 64 -> 64, 3 taps,
    # dilation 2 (conv_out), float32 out (the JSON line) and bf16 out.
    x = torch.randn(n, 64, t, generator=gen, device=dev)
    qa = qact.quantize(x)
    w = torch.randn(64, 64, 3, generator=gen, device=dev) / 96 ** 0.5
    b = 0.1 * torch.randn(64, generator=gen, device=dev)
    conv = torch.nn.Conv1d(64, 64, 3, padding=2, dilation=2).to(dev)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(b)
    flops = 2.0 * n * t * 64 * 64 * 3
    for dtype in (torch.float32, torch.bfloat16):
        q8 = qact.QAct(qa.q, qa.scale, dtype)
        ms = cuda_ms(lambda: qact.conv1d_int8(q8, conv.weight, conv.bias, dilation=2,
                                              conv=conv), 20)
        plain_ms = cuda_ms(lambda: conv_int8_plain(q8, w, b, 1, 2), 5)
        xb = x.to(torch.bfloat16)
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: F.conv1d(xb, wb, bb, padding=2, dilation=2), 20)
        out_bytes = n * 64 * t * (4 if dtype == torch.float32 else 2)
        cb, cby = bound_ms(qa.q.numel() + w.numel() + out_bytes, flops, INT8_OP_PER_S)
        print(f"int8 conv timing [{n}, 64, {t}] 64->64 d2, {str(dtype)[6:]} out: {ms:.4f} ms "
              f"({100 * cb / ms:.1f}% of its bound {cb:.4f} by {cby}; plain {plain_ms:.4f}); "
              f"a different function for scale: cuDNN bf16 conv1d of the same shape "
              f"{lib_ms:.4f} ms")
        if dtype == torch.float32:
            entries.append(dict(
                name="conv1d_int8", route="cuda",
                source="vq_voice_swap_torch/csrc/conv1d_int8.cu",
                replaces="vq_voice_swap_tpu/ops/qact.py:185", launches=0,
                max_abs_err=conv_err, ms=ms, plain_ms=plain_ms, bound_ms=cb, bound_by=cby,
                library_ms=None))
        del xb
    ww = 1.0 + 0.2 * torch.randn(64, generator=gen, device=dev)
    bw = 0.2 * torch.randn(64, generator=gen, device=dev)
    coeffs = gn.group_norm_coeffs_int8(qa.q, qa.scale, 32, ww, bw, 1e-5)
    ams = cuda_ms(lambda: gn.group_norm_apply_int8(qa.q, qa.scale, *coeffs, True,
                                                   torch.float32), 20)
    aplain = cuda_ms(lambda: gn.group_norm_apply_plain(qact.dequantize(qa), *coeffs, True), 20)
    ab, aby = bound_ms(qa.q.numel() * 5 + 3 * 4 * n * 64, 26 * qa.q.numel())
    print(f"int8 groupnorm apply timing [{n}, 64, {t}]: apply+gelu to f32 {ams:.4f} ms "
          f"({100 * ab / ams:.1f}% of its bound {ab:.4f} by {aby}; plain {aplain:.4f})")
    sms, splain, sb, sby = stats_timing["per-tensor"]
    entries += [
        dict(name="group_norm_stats_int8", route="cuda",
             source="vq_voice_swap_torch/csrc/group_norm_stats.cu",
             replaces="vq_voice_swap_tpu/ops/qact.py:138", launches=0, max_abs_err=err_stats,
             ms=sms, plain_ms=splain, bound_ms=sb, bound_by=sby, library_ms=None),
        dict(name="group_norm_apply_int8", route="triton",
             source="vq_voice_swap_torch/ops/group_norm.py",
             replaces="vq_voice_swap_tpu/ops/qact.py:144", launches=0, max_abs_err=err_apply,
             ms=ams, plain_ms=aplain, bound_ms=ab, bound_by=aby, library_ms=None),
    ]
    del x, qa, conv
    torch.cuda.empty_cache()
    return entries


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at |v| (float32), 0 at 0."""
    _, e = torch.frexp(v)
    return torch.where(v == 0, 0.0, torch.ldexp(torch.ones_like(v), e - 8))


@torch.no_grad()
def check_conv1d_bf16(dev, gen):
    """The serving bf16 convolution (csrc/conv1d_bf16.cu, through the
    route's wrapper and the layer's kept weight) against its plain version
    on the card, ``conv1d_bf16_plain`` (cuDNN's bf16 convolution, then
    aten's bias add), at every shape one bf16 swap predictor call routes to
    it, on that call's seeded layers at batch 64. The plain version rounds
    the float32 sum to bf16 and again after the bias, the kernel once after
    it: the two lie within 1.5 bf16 ulps of the larger of |sum| and |out|
    (plus four times the float32 summation bound: both sum the same exact
    products in other orders), and the kernel within one ulp of the float32
    reference rounded once. Timed at [64, 64, 64000] 64 -> 64 d2 beside its
    bound, its plain version and cuDNN with the bf16 weight cast once.
    Returns its JSON entry (launches are phase 4's)."""
    model = swap_predictor(DiffusionModel, dev)
    layers_at = {}

    def hook(m, args):
        x = args[0]
        if c1.routes(x.device.type, x.dtype, False, x.shape, True, m.conv):
            cout, cin, taps = m.conv.weight.shape
            key = (cin, cout, taps, m.conv.dilation[0], x.shape[2])
            layers_at.setdefault(key, []).append(m.conv)

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, layers.Conv1d)]
    model.predict_eps(*predictor_inputs(dev, 1))
    for h in handles:
        h.remove()
    routed = sum(len(v) for v in layers_at.values())
    print(f"conv1d_bf16: one bf16 swap predictor call routes {routed} convolutions of "
          f"{len(layers_at)} shapes to the kernel")
    assert routed == CONV_BF16_PER_PREDICTOR, routed
    n = CONV_BF16_BATCH
    worst_plain = worst_ref = err = 0.0
    for (cin, cout, taps, dil, t), convs in sorted(layers_at.items()):
        conv = convs[0]
        x = torch.randn(n, cin, t, generator=gen, device=dev).to(torch.bfloat16)
        got = c1.conv1d_bf16(x, conv.weight, conv.bias, dil, conv)
        plain = c1.conv1d_bf16_plain(x, conv.weight, conv.bias, dil)
        again = c1.conv1d_bf16(x, conv.weight, conv.bias, dil, conv)
        wb = conv.weight.to(torch.bfloat16).float()
        bb = conv.bias.to(torch.bfloat16).float()
        pad = conv.padding[0]
        total = F.conv1d(x.float(), wb, None, padding=pad, dilation=dil)
        slack = 4 * (cin * taps + 1) * 2.0 ** -24 * (
            F.conv1d(x.float().abs(), wb.abs(), None, padding=pad, dilation=dil)
            + bb.abs()[:, None])
        total_b = total + bb[:, None]
        want = total_b.to(torch.bfloat16).float()
        ulp = bf16_ulp(torch.maximum(total.abs(), total_b.abs()) * (1 + 2.0 ** -7))
        gap = (got.float() - plain.float()).abs()
        off_ref = (got.float() - want).abs()
        r_plain = ((gap - slack) / ulp.clamp(min=2.0 ** -133)).max().item()
        r_ref = ((off_ref - slack) / bf16_ulp(want).clamp(min=2.0 ** -133)).max().item()
        same = torch.equal(got, again)
        print(f"conv1d_bf16 [{n}, {cin}, {t}] {cin}->{cout} k{taps} d{dil} x{len(convs)}: "
              f"kernel vs plain at most {r_plain:.3f} ulps beyond the summation bound, vs "
              f"the float32 reference rounded once {r_ref:.3f}; bits equal to plain "
              f"{(got == plain).float().mean().item():.4f}, same bits twice {same}")
        assert bool((gap <= 1.5 * ulp + slack).all()), (cin, cout, taps, dil, t)
        assert bool((off_ref <= bf16_ulp(want) + slack).all()), (cin, cout, taps, dil, t)
        assert same
        worst_plain, worst_ref = max(worst_plain, r_plain), max(worst_ref, r_ref)
        err = max(err, gap.max().item())
        del x, got, plain, again, total, slack, total_b, want, ulp, gap, off_ref
        torch.cuda.empty_cache()

    conv = layers_at[(64, 64, 3, 2, SAMPLES)][0]
    x = torch.randn(n, 64, SAMPLES, generator=gen, device=dev).to(torch.bfloat16)
    wb, bb = conv.weight.to(torch.bfloat16), conv.bias.to(torch.bfloat16)
    ms = cuda_ms(lambda: c1.conv1d_bf16(x, conv.weight, conv.bias, 2, conv), 10)
    plain_ms = cuda_ms(lambda: c1.conv1d_bf16_plain(x, conv.weight, conv.bias, 2), 10)
    lib_ms = cuda_ms(lambda: F.conv1d(x, wb, bb, padding=2, dilation=2), 10)
    cb, cby = bound_ms(2 * x.numel() * 2 + wb.numel() * 2, 2.0 * n * SAMPLES * 64 * 64 * 3,
                       BF16_FLOP_PER_S)
    print(f"conv1d_bf16 timing [{n}, 64, {SAMPLES}] 64->64 k3 d2: {ms:.4f} ms "
          f"({100 * cb / ms:.1f}% of its bound {cb:.4f} by {cby}; plain {plain_ms:.4f}; "
          f"cuDNN + bias, the weight cast once, {lib_ms:.4f}); kernel vs plain at most "
          f"{worst_plain:.3f} ulps, vs the reference {worst_ref:.3f}")
    del x, model, layers_at
    torch.cuda.empty_cache()
    return dict(name="conv1d_bf16", route="cuda", source="vq_voice_swap_torch/csrc/conv1d_bf16.cu",
                replaces="none: XLA's convolution (vq_voice_swap_tpu/models/layers.py, nn.Conv)",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=cb,
                bound_by=cby, library_ms=lib_ms)


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
           gn.group_norm_bwd_reduce, gn.group_norm_bwd_dx,
           frb.fused_resblock_stats, frb.fused_resblock_apply,
           qact.quantize, qact.quantize_group_norm, qact.quantize_residual, qact.conv1d_int8,
           gn.group_norm_coeffs_int8, gn.group_norm_apply_int8, c1.conv1d_bf16)
KERNEL_WRAPPERS = {"group_norm_stats": ("group_norm_coeffs", "group_norm_stats"),
                   "group_norm_stats_int8": ("group_norm_coeffs_int8",)}
INT8_KERNELS = ("conv1d_int8", "quantize", "quantize_group_norm", "quantize_residual",
                "group_norm_stats_int8", "group_norm_apply_int8")


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
        assert counts["conv1d_bf16"] == 0  # float32
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
    assert counts["conv1d_bf16"] == CONV_BF16_PER_FUSED_PREDICTOR * steps

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


def serving_time(dev, ckpt: str, clips: np.ndarray, smi: str) -> int:
    """Encode + 10-step DPM++ decode of BATCH clips, 3 timed runs after a
    warm one, per compute dtype, the serving bf16 convolution's launches
    asserted in the warm run; then where one predictor call's device time
    goes. Returns the bf16 run's launches of that convolution."""
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

        reset_counts()
        swap()  # warm: kernel compiles and cuDNN plans
        torch.cuda.synchronize()
        conv_launches = c1.conv1d_bf16.launches
        print(f"serving {name}: conv1d_bf16 launches in one swap {conv_launches}")
        assert conv_launches == (CONV_BF16_PER_PREDICTOR * 10 if dtype else 0), conv_launches
        if dtype:
            bf16_launches = conv_launches
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
    return bf16_launches


def _kernel_class(name: str) -> str:
    if "resblock_stats_kernel" in name:
        return "fused resblock stats (CUDA)"
    if "resblock_apply_kernel" in name:
        return "fused resblock apply (CUDA)"
    if "group_norm_stats_kernel" in name:
        return "groupnorm stats + fold (CUDA)"
    if "group_norm_stats_int8_kernel" in name:
        return "groupnorm int8 stats + fold (CUDA)"
    if "group_norm_bwd_" in name:
        return "groupnorm backward (CUDA)"
    if name.startswith("apply_kernel"):
        return "groupnorm apply (Triton)"
    if "vq_assign_kernel" in name:
        return "vq assign (CUDA)"
    if "conv1d_int8_kernel" in name:
        return "int8 conv (CUDA)"
    if name.startswith(("amax_kernel", "codes_kernel")):
        return "quantize, producer fused in (Triton)"
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
        records, wall_ms, lost, host_launches = profiled(fn)
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
          f"{len(records)} kernel launches from {host_launches} host launch calls, "
          f"{to_host} copies to the host (the profiler "
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
    launches made (a CUDA graph launch makes one per node), fn's wall time
    in ms, how many pad launches lost their device record and fn's host
    launch calls. Fails if any launch of fn has no device record."""
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
    return records, wall_ms, sum(c not in recorded for c in pad_ids), len(fn_ids)


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
        records, _, _, _ = profiled(lambda: gn.group_norm(x, w, b, groups, 1e-5, True, f))
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
        glue, _, _, _ = profiled(merge_and_fold)
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


# What each train run logged (unrounded, as Logger.log got it), its
# samples/s and peak device memory, and the loops kept for a profile, by
# run name.
RAW_LOGS, RATES, PEAKS, LOOPS = {}, {}, {}, {}


@contextlib.contextmanager
def recorded_log(into: list):
    """Record every Logger.log call's step and values, unrounded."""
    log = Logger.log

    def record(self, step, **values):
        into.append((step + self.start_step, values))
        return log(self, step, **values)

    Logger.log = record
    try:
        yield into
    finally:
        Logger.log = log


def training_run(dev, workdir: str, name: str, cli, argv, steps: int, launches, smi: str,
                 k: int = 1, loop_cls=None, save: bool = True):
    """One train CLI run of ``steps`` steps (saved at the last; with
    ``save`` false not at all, for runs whose files nothing reads: a
    flagship's save writes ~1 GB and takes ~3 s, and every CLI's save is
    checked in another run), with the
    launch counts set to 0 just before it; asserts the launches of every
    kernel of the path (``launches``, per step) and prints samples/s (the
    median over the steps after two warm-up steps, less the last, whose
    metrics are fetched at the save) and peak device memory. With ``k`` > 1
    the run takes --steps-per-dispatch k: a wrapper counts its launches as
    the warm-up and the capture run it (WARMUP_STEPS + 1 steps), not per
    replay, and a tail shorter than k runs eagerly. With ``loop_cls`` (the
    CLI's loop class) the run is the CLI's ``main`` spelled out, and the
    loop is kept in LOOPS[name] for ``profile_loop``. Returns the run's
    directory, argv, counts and what the CLI printed."""
    out = os.path.join(workdir, name.replace(" ", "_"))
    argv = argv + ["--max-steps", str(steps), "--save-interval",
                   str(steps if save else 10**9), "--output-dir", out, "--device", "cuda"]
    if k > 1:
        argv += ["--steps-per-dispatch", str(k)]
    torch.cuda.synchronize(dev)  # the peak-memory reset needs the card's context
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout)) as printed, \
            recorded_log([]) as raw:
        if loop_cls is None:
            cli.main(argv)
        else:
            LOOPS[name] = loop_cls(loop_cls.arg_parser().parse_args(argv))
            LOOPS[name].loop()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = PEAKS[name] = torch.cuda.max_memory_allocated(dev) / 2**30
    RAW_LOGS[name] = raw
    log = _train_log(out)
    assert [s for s, _ in log] == list(range(1, steps + 1)), log
    assert all(np.isfinite(v) for _, f in log for v in f.values())
    # The last step's metrics are fetched at the save, just after the one
    # before; with k > 1 the steps of a window share the window's rate, and
    # the last window's is steady.
    rates = [f["samples_per_sec"] for _, f in (log[2:-1] if k == 1 else log[-k:-k + 1])]
    RATES[name] = float(np.median(rates)) if rates else float("nan")
    rate = (f"{RATES[name]:.4f} samples/s (median of steps 3-{steps - 1}: "
            f"{[round(r, 3) for r in rates]})" if k == 1 and rates else
            f"{RATES[name]:.4f} samples/s (the last window of {k} replayed steps)"
            if rates else "no steady step")
    print(f"training {name} on {smi}: {steps} steps in {seconds:.3f} s (build, data and "
          f"save included), {rate}, peak device memory "
          f"{peak:.2f} GiB, "
          f"losses {[round(f['loss'], 4) for _, f in log]}, launches {counts}, per step: "
          + ", ".join(f"{k} {v / steps:g}" for k, v in counts.items() if v))
    if "codebook_used" in log[0][1]:
        print(f"  codebook_used {[f['codebook_used'] for _, f in log]}")
    for f in ("model.npz", "opt.pt"):
        assert os.path.exists(os.path.join(out, f)) == save, (f, save)
    calls = steps if k == 1 else WARMUP_STEPS + 1 + steps % k
    assert counts["group_norm_coeffs"] == counts["group_norm_apply"] == \
        launches["forward"] * calls
    assert counts["group_norm_backward"] == counts["_bwd_cluster"] == \
        launches["backward"] * calls
    assert counts["group_norm_stats"] == counts["_bwd_two_kernel"] == 0
    assert counts["vq_assign"] == launches["vq"] * calls
    assert counts["fused_resblock_stats"] == counts["fused_resblock_apply"] == 0
    return out, argv, counts, printed.getvalue()


def profile_loop(dev, name: str, launches) -> None:
    """Profile one step of the loop that training_run kept for ``name``,
    as profile_train_step does, then let the loop go."""
    _profile_step(dev, LOOPS.pop(name), name, launches)
    torch.cuda.empty_cache()


def profile_train_step(dev, loop_cls, argv, name: str, launches):
    """Resume the run in argv's directory and profile one train step."""
    loop = loop_cls(loop_cls.arg_parser().parse_args(argv))
    assert loop.resume
    _profile_step(dev, loop, name, launches)


def _profile_step(dev, loop, name: str, launches) -> None:
    """Profile one train step of ``loop`` (with --steps-per-dispatch, one
    replay of the captured step, after the call that captures it): its
    kernel launches by class, asserted for the GroupNorm and VQ kernels."""
    batch = loop.to_device(loop.prepare_batch(next(iter(loop.data_loader))))
    generator = step_generator(0, 10**6, dev)
    step = loop.graphed_step or loop.train_step
    n, counts = profile_call(lambda: step(batch, generator), f"{name} train step", grad=True)
    assert counts.get("groupnorm stats + fold (CUDA)", 0) == launches["forward"], counts
    assert counts.get("groupnorm apply (Triton)", 0) == launches["forward"], counts
    assert counts.get("groupnorm backward (CUDA)", 0) == launches["backward"], counts
    assert counts.get("vq assign (CUDA)", 0) == launches["vq"], counts
    print(f"  {name} train step: {n} kernel launches")


def train_step_card_vs_cpu(dev, name: str, model_kwargs, launches):
    """One full-width VQ-VAE training forward and backward (f32, TF32 off)
    at batch 1 of 8192 samples (a multiple of the downsample rate near
    0.5 s, cut from 1 s for the script's time limit) on the card, through
    the kernels, and on the CPU, through their plain versions, from the
    same seeded weights and draws: the same codes, the loss within 1e-4
    relative and each parameter's gradient within 1e-3 of its largest
    entry plus 1e-6 of the largest gradient (a bias before a GroupNorm has
    a true gradient of 0)."""
    torch.backends.cudnn.allow_tf32 = False
    model = VQVAE(**model_kwargs)
    seed_weights(model, 11)
    t = 8192
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
        warm = "warm" in name
        # enc-pred's and the classifier's saves are checked at K=4
        # (--async-save); nothing reads these runs' files.
        out, _, runs[name], printed = training_run(
            dev, workdir, name, cli, argv, n_steps, launches, smi,
            loop_cls=None if warm else loop_cls,
            save=not name.startswith(("enc-pred", "classifier")))
        if warm:
            want = _pred_down_path_size(diffusion)
            assert f"loaded {want} pre-trained parameters" in printed, want
            print(f"  classifier warm start: {want} scalars copied from the diffusion "
                  f"predictor's down path, as its shapes give")
        else:
            profile_loop(dev, name, launches)
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
        out, _, runs[name], _ = training_run(
            dev, workdir, name, train_vqvae, argv, NEW_TRAIN_STEPS, launches, smi,
            loop_cls=VQVAETrainLoop, save=name.endswith("f32"))  # the f32 run's is read
        profile_loop(dev, name, launches)
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
         per_step(gn_vqvae, gn_vqvae, 1)),  # not saved
        ("diffusion bf16", train_diffusion, DiffusionTrainLoop, TRAIN_DIFFUSION_ARGV, 5,
         per_step(GN_PER_PREDICTOR, GN_PER_PREDICTOR, 0)),
    ):
        # The first run's profiled step resumes from its save, as the CLI
        # would; the others profile the loop they kept (a resume reads ~1 GB).
        resume = name == "vqvae bf16"
        out, full_argv, runs[name], _ = training_run(
            dev, workdir, name, cli, argv, steps, launches, smi,
            loop_cls=None if resume else loop_cls, save=name != "vqvae f32")
        if resume:
            profile_train_step(dev, loop_cls, full_argv, name, launches)
        else:
            profile_loop(dev, name, launches)
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
    t0 = time.perf_counter()
    runs.update(graph_training_paths(dev, workdir, smi, kept["vqvae bf16"]))
    print(f"CUDA graphs, checkpointing and the flags: {time.perf_counter() - t0:.1f} s")
    return runs



# ------------------------------------------------ phase 5: graphs, remat, .pt

GRAPH_K = 4
RESBLOCKS_VQVAE = 65 + 23  # unet64 predictor, unet128 encoder
GRAPH_STEPS = 4  # one window: the other loops' runs at --steps-per-dispatch


def _npz_leaf_errors(got_path: str, want_path: str):
    """(the largest |got - want| of any parameter leaf over that leaf's
    largest entry, its leaf, whether every array is the same bits)."""
    with np.load(got_path) as got, np.load(want_path) as want:
        assert got.files == want.files
        same, worst, leaf = True, 0.0, None
        for k in want.files:  # an npz reads an array from its file at each index
            g, w = got[k], want[k]
            same = same and np.array_equal(g, w)
            if not k.startswith("params/"):
                continue
            w = w.astype(np.float64)
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            if err > worst:
                worst, leaf = err, k
    return worst, leaf, same


def _loss_error(got, want) -> float:
    """The largest relative difference of two runs' per-step losses."""
    assert [s for s, _ in got] == [s for s, _ in want]
    return max(abs(g["loss"] - w["loss"]) / abs(w["loss"]) for (_, g), (_, w) in zip(got, want))


def _logged(raw):
    """A run's logged values but samples/s (a wall-clock rate)."""
    return [(step, {k: v for k, v in values.items() if k != "samples_per_sec"})
            for step, values in raw]


def _codebook_used(raw):
    return [int(v["codebook_used"]) for _, v in raw]


def _check_async_markers(out: str, steps: int) -> None:
    """An --async-save run's log: '# saving @ steps' after the last step's
    line, confirmed by one '# saved' after it; the files are down."""
    with open(os.path.join(out, "train_log.txt")) as f:
        lines = f.read().splitlines()
    marker = lines.index(f"# saving @ {steps}")
    assert lines[marker - 1].startswith(f"step {steps}:"), lines[marker - 1:]
    assert lines[marker + 1:] == ["# saved"], lines[marker:]
    for f in ("model.npz", "opt.pt", "model_ema_0.9999.npz"):
        assert os.path.getsize(os.path.join(out, f)) > 0, f


@contextlib.contextmanager
def deterministic(on: bool):
    """PyTorch's deterministic algorithms (cuDNN's, sorted index accumulation
    for atomic adds) while on."""
    if not on:
        yield
        return
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def graph_training_paths(dev, workdir: str, smi: str, flagship: str):
    """--steps-per-dispatch, --grad-checkpoint, --async-save and
    --profile-dir on the card. The bf16 flagship at K=4 for TRAIN_STEPS
    steps against phase 5's eager run (``flagship``, the same seed) and a
    second eager run, then both again with deterministic algorithms: the
    per-step logged values, codebook_used, every parameter, EMA and AdamW
    moment (the same bits with deterministic algorithms); samples/s, device
    busy share, launches per step and peak memory at K=1 and K=4. The other five loops at K=4 for one window each (two with
    --async-save, host and device snapshots; WaveGrad with --profile-dir),
    their GroupNorm and VQ launches per replayed step from a profiled
    replay. The flagship with --grad-checkpoint full and convs, bf16 and
    f32: peak memory and samples/s against the un-checkpointed runs.
    Returns {run name: counts}."""
    runs = {}
    gn_vqvae = GN_PER_PREDICTOR + GN_PER_ENCODER128
    vqvae = per_step(gn_vqvae, gn_vqvae, 1)
    argv = TRAIN_VQVAE_ARGV + ["--bf16"]
    for name, k, exact in (("vqvae bf16 again", 1, False), ("vqvae bf16 k4", GRAPH_K, False),
                           ("vqvae bf16 exact", 1, True), ("vqvae bf16 k4 exact", GRAPH_K, True)):
        with deterministic(exact):
            profiled_run = name == "vqvae bf16 k4"
            out, full_argv, runs[name], _ = training_run(
                dev, workdir, name, train_vqvae, argv, TRAIN_STEPS, vqvae, smi, k=k,
                loop_cls=VQVAETrainLoop if profiled_run else None)
        if profiled_run:
            profile_loop(dev, name, vqvae)

    def compare(a: str, b: str):
        """(loss error, parameter error, its leaf, the same bits in every
        file and every logged value) of two runs' logs and files."""
        da, db = (os.path.join(workdir, n.replace(" ", "_")) for n in (a, b))
        errs = _npz_leaf_errors(os.path.join(da, "model.npz"), os.path.join(db, "model.npz"))
        same = errs[2] and _npz_leaf_errors(os.path.join(da, "model_ema_0.9999.npz"),
                                            os.path.join(db, "model_ema_0.9999.npz"))[2]
        oa, ob = (torch.load(os.path.join(d, "opt.pt"), weights_only=True) for d in (da, db))
        same = same and all(torch.equal(v, ob["adamw"]["state"][i][k])
                            for i, st in oa["adamw"]["state"].items() for k, v in st.items())
        same = same and _logged(RAW_LOGS[a]) == _logged(RAW_LOGS[b])
        return _loss_error(RAW_LOGS[a], RAW_LOGS[b]), errs[0], errs[1], same

    results = {pair: compare(*pair) for pair in (
        ("vqvae bf16 again", "vqvae bf16"), ("vqvae bf16 k4", "vqvae bf16"),
        ("vqvae bf16 exact", "vqvae bf16 k4 exact"))}
    print(f"flagship bf16, {TRAIN_STEPS} steps, on {smi}: loss error (relative), parameter "
          f"error (of a leaf's largest entry, worst leaf), the same bits (logs, model, EMA, "
          f"AdamW):")
    for (a, b), (loss, param, leaf, same) in results.items():
        print(f"  {a} against {b}: {loss:.3g}, {param:.3g} ({leaf}), {same}")
    print(f"  codebook_used K=1 {_codebook_used(RAW_LOGS['vqvae bf16'])}, K=4 "
          f"{_codebook_used(RAW_LOGS['vqvae bf16 k4'])}")
    print(f"  samples/s K=1 {RATES['vqvae bf16']:.4f} (again {RATES['vqvae bf16 again']:.4f}, "
          f"deterministic {RATES['vqvae bf16 exact']:.4f}), K=4 {RATES['vqvae bf16 k4']:.4f} "
          f"(deterministic {RATES['vqvae bf16 k4 exact']:.4f}); peak device memory K=1 "
          f"{PEAKS['vqvae bf16']:.2f} GiB, K=4 {PEAKS['vqvae bf16 k4']:.2f} GiB")
    # With the default algorithms two eager runs differ (atomic adds in the
    # backward); with deterministic ones the graphed run is the eager run.
    assert results[("vqvae bf16 exact", "vqvae bf16 k4 exact")][3]
    for name in ("vqvae bf16 again", "vqvae bf16 exact", "vqvae bf16 k4 exact"):
        shutil.rmtree(os.path.join(workdir, name.replace(" ", "_")))

    trace = os.path.join(workdir, "wavegrad_trace")
    pretrained = ["--class-cond", "--pretrained-path", flagship]
    for name, cli, loop_cls, argv, launches in (
        ("classifier bf16 k4", train_classifier, ClassifierTrainLoop,
         NEW_RUN_ARGV + ["--async-save"], per_step(GN_PER_CLASSIFIER, GN_PER_CLASSIFIER, 0)),
        ("enc-pred bf16 k4", train_enc_pred, EncoderPredictorTrainLoop,
         NEW_RUN_ARGV + ["--vq-vae-path", flagship, "--async-save", "--async-snapshot",
                         "device"],
         per_step(GN_PER_ENC_PRED + GN_PER_ENCODER128, GN_PER_ENC_PRED, 1)),
        ("vqvae add-classes bf16 k4", train_vqvae_add, VQVAEAddClassesTrainLoop,
         NEW_RUN_ARGV + pretrained, per_step(gn_vqvae, GN_PER_PREDICTOR - 1, 1)),
        ("vqvae uncond bf16 k4", train_vqvae_uncond, VQVAEUncondTrainLoop,
         NEW_RUN_ARGV + pretrained, vqvae),
        ("wavegrad vqvae bf16 k4", train_vqvae, VQVAETrainLoop,
         TRAIN_WAVEGRAD_ARGV + ["--bf16", "--profile-dir", trace], per_step(0, 0, 1)),
    ):
        out, full_argv, runs[name], _ = training_run(
            dev, workdir, name, cli, argv, GRAPH_STEPS, launches, smi, k=GRAPH_K,
            loop_cls=loop_cls, save="--async-save" in argv)
        if "--async-save" in argv:
            _check_async_markers(out, GRAPH_STEPS)
            snapshot = "device" if "device" in argv else "host"
            print(f"  {name}: --async-save ({snapshot} snapshot) marked '# saving @ "
                  f"{GRAPH_STEPS}' and '# saved'; the files are down")
        profile_loop(dev, name, launches)
        shutil.rmtree(out)
    traces = [f for f in os.listdir(trace) if f.endswith(".json")]
    with open(os.path.join(trace, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"  --profile-dir: {traces[0]}, {len(events)} events, {kernels} kernel records")
    assert len(traces) == 1 and kernels > 0

    # Activation checkpointing: per step, each ResBlock's two GroupNorms run
    # again in the recompute (no convolution reruns under convs).
    remat = per_step(gn_vqvae + 2 * RESBLOCKS_VQVAE, gn_vqvae, 1)
    for dtype, k in (("bf16", 1), ("bf16", GRAPH_K), ("f32", 1)):
        tag = "" if k == 1 else f" k{k}"
        for policy in ("full", "convs"):
            name = f"vqvae {dtype}{tag} remat {policy}"
            argv = TRAIN_VQVAE_ARGV + (["--bf16"] if dtype == "bf16" else []) + [
                f"--grad-checkpoint={policy}"]
            out, _, runs[name], _ = training_run(
                dev, workdir, name, train_vqvae, argv, TRAIN_STEPS if k > 1 else 5, remat,
                smi, k=k, loop_cls=VQVAETrainLoop if k > 1 else None, save=False)
            if k > 1:
                profile_loop(dev, name, per_step(gn_vqvae + 2 * RESBLOCKS_VQVAE, gn_vqvae, 1))
            shutil.rmtree(out)
        none = f"vqvae {dtype}{tag}"
        print(f"--grad-checkpoint, flagship {dtype} at K={k} on {smi}: peak device memory "
              f"none {PEAKS[none]:.2f} GiB, full {PEAKS[f'{none} remat full']:.2f} GiB, "
              f"convs {PEAKS[f'{none} remat convs']:.2f} GiB; samples/s none "
              f"{RATES[none]:.4f}, full {RATES[f'{none} remat full']:.4f}, convs "
              f"{RATES[f'{none} remat convs']:.4f}")
    remat_grads(dev, remat)
    return runs


def remat_grads(dev, launches) -> None:
    """One full-width VQ-VAE training forward and backward (unet64 +
    unet128, batch 2 of 4 s, draws fixed) with --grad-checkpoint full and
    convs against none, f32 (TF32 off) and bf16: each gradient leaf within
    1e-4 (f32) or 2e-2 (bf16) of its largest entry, plus 1e-6 of the
    largest gradient (a bias before a GroupNorm has a true gradient of 0);
    the recompute's GroupNorm launches counted."""
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(31)
    x = torch.from_numpy(np.stack([speech_like(s, SAMPLES) for s in (41, 42)]))[..., None]
    draws = dict(ts=torch.tensor([0.3, 0.7]), epsilon=torch.randn(2, SAMPLES, 1, generator=gen))
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        model = VQVAE(pred_name="unet", base_channels=64, enc_name="unet128", num_labels=3,
                      dtype=dtype)
        seed_weights(model, 32)
        model = model.to(dev)

        def grads(policy):
            model.set_remat(policy)
            model.zero_grad(set_to_none=True)
            out = model.losses(x.to(dev), labels=torch.tensor([0, 2], device=dev), train=True,
                               **{k: v.to(dev) for k, v in draws.items()})
            (out["mse"] + out["vq_loss"]).backward()
            return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

        want = grads(None)
        top = max(g.abs().max().item() for g in want.values())
        for policy in ("full", "convs"):
            reset_counts()
            got = grads(policy)
            counts = read_counts()
            worst, leaf = 0.0, None
            for n, w in want.items():
                err = (got[n] - w).abs().max().item() / (w.abs().max().item() + 1e-6 * top)
                if err > worst:
                    worst, leaf = err, n
            print(f"  full-width step, remat {policy} vs none, {dtype}: worst gradient leaf "
                  f"{leaf} {worst:.3g} of its scale (limit {tol}), GroupNorm launches "
                  f"{counts['group_norm_coeffs']} forward, {counts['group_norm_backward']} "
                  f"backward")
            assert worst <= tol, (policy, dtype, leaf, worst)
            assert counts["group_norm_coeffs"] == launches["forward"]
            assert counts["group_norm_backward"] == launches["backward"]
            del got
        del model, want
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True


def reference_state_dict(model) -> dict:
    """``model``'s weights in the released reference checkpoints' layout:
    the port's reference mapper run on a state_dict that answers every
    lookup with a marker array, each flax path traced back to its key."""
    from vq_voice_swap_torch.convert import params_to_jax, torch_import

    class Markers(dict):
        def __contains__(self, key):
            if key.endswith(".post_cond.2.weight"):
                return False
            probe = re.search(r"\.(\d+)\.(pre_cond\.2|0\.ln)\.weight$", key)
            return probe is None or int(probe.group(1)) < 64

        def __missing__(self, key):
            self[key] = np.zeros((1, 1, 1), np.float32)
            return self[key]

    markers = Markers()
    flat = torch_import.convert_state_dict("VQVAE", model.save_kwargs(), markers)
    key_of = {id(v): k for k, v in markers.items()}
    mine = params_to_jax(model)
    sd = {}
    for path, v in flat.items():
        if path.startswith("buffers/") or path not in mine:
            continue  # the usage counts (a converted copy) go in below
        key = key_of[id(v if v.base is None else v.base)]
        arr = mine[path]
        if path.endswith("kernel"):
            arr = arr.T if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    sd["vq.usage_count"] = torch.from_numpy(mine["buffers/vq/usage_count"])
    assert len(sd) == len(mine), (len(sd), len(mine))
    return sd


def reference_pt_swap(dev, workdir: str, ckpt: str) -> None:
    """The swap model of phase 3 written as a released-reference ``.pt``
    (its state_dict in the reference layout and reference kwargs) loads on
    the card through ModelBase.load, and sample_vqvae swaps with it to the
    same bits as with the npz of the same weights."""
    from vq_voice_swap_torch.model_base import ModelBase

    model = ModelBase.load(ckpt, device="cpu")
    kwargs = {**model.save_kwargs(), "cond_channels": model.cond_channels,
              "dropout": (model.dropout,)}
    pt = os.path.join(workdir, "reference.pt")
    torch.save({"kwargs": kwargs, "state_dict": reference_state_dict(model)}, pt)
    loaded = ModelBase.load(pt, device=dev)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k].cpu(), v), k
    del loaded
    src = os.path.join(workdir, "in.wav")
    outs = []
    for path in (ckpt, pt):
        out = path + ".swap.wav"
        sample_vqvae.main(["--label", "7", "--input-file", src, "--sample-steps", "5",
                           "--sampler", "ddpm", "--device", "cuda", path, out])
        outs.append(_wav_frames(out)[1])
    same = np.array_equal(outs[0], outs[1])
    print(f"reference .pt ({os.path.getsize(pt) / 2**20:.1f} MiB, {len(model.state_dict())} "
          f"tensors) loaded on the card through ModelBase.load; 5-step DDPM swap with it "
          f"and with the npz of the same weights: same bits {same}")
    assert same and outs[0].shape[0] == SAMPLES

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


# ------------------------------------------------------------------ phase 7

# Data parallelism and FSDP: the bf16 flagship of phase 5, every rank a
# process of its own started by torchrun (python -m torch.distributed.run),
# each running this script's rank_main. Three launches run together (one
# after the other until the script outgrew its time limit): a run without
# the launcher; one process under torchrun that runs DP, FSDP and DP at K=4
# one after the other (the group stays up between them); two ranks sharing
# the card over gloo, DP and then FSDP (saved as dcp). Four steps (one K=4
# window, as phase 5's other K=4 runs), cut from eight to keep the script
# inside its time limit.
PARALLEL_STEPS = 4
# The world-size-1 runs whose host time a step is profiled (one more step,
# after the run's own) and set beside the plain run's.
PROFILED = ("plain", "dp", "fsdp")
PARALLEL_TIMEOUT = 420
RANK_RUN = "--rank-run"


class Launch:
    """This script run with ``args`` in a new process session, under
    torchrun with ``nproc`` ranks (0: without the launcher), what it prints
    kept in a file of ``workdir``. Launches run beside this process's
    phases and each other (phase 8's beside phase 5, phase 9's beside
    phase 6, phase 7's three together), so the rates they print are taken
    beside the others' work.
    ``wait`` returns what the launch printed and its wall seconds (from its
    start to its processes' end); it raises if the launch fails or
    outlasts PARALLEL_TIMEOUT from its start. Its processes are killed
    either way, and ``stop_all`` kills those of every launch still
    running."""

    running: list = []

    def __init__(self, workdir: str, name: str, nproc: int, args):
        self.name = name
        self.cmd = [sys.executable]
        if nproc:
            self.cmd += ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                         str(nproc)]
        self.cmd += [os.path.abspath(__file__), *args]
        self.log = os.path.join(workdir, "launch_" + re.sub(r"\W+", "_", name) + ".log")
        self.t0 = time.perf_counter()
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(self.cmd, stdout=out, stderr=subprocess.STDOUT,
                                         text=True, start_new_session=True, cwd=workdir)
        self.ended = None
        self.watch = threading.Thread(target=self._watch, daemon=True)
        self.watch.start()
        Launch.running.append(self)

    def _watch(self) -> None:
        self.proc.wait()
        self.ended = time.perf_counter()

    def stop(self) -> None:
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, 9)
            self.proc.wait()
        if self in Launch.running:
            Launch.running.remove(self)

    def wait(self):
        self.watch.join(timeout=max(PARALLEL_TIMEOUT - (time.perf_counter() - self.t0), 1))
        timed_out = self.ended is None
        self.stop()
        if timed_out:
            raise RuntimeError(f"{self.name}: {' '.join(self.cmd)} outlasted "
                               f"{PARALLEL_TIMEOUT} s")
        wall = self.ended - self.t0
        with open(self.log) as f:
            printed = f.read()
        if self.proc.returncode != 0:
            print(printed[-6000:])
            raise RuntimeError(f"{self.name}: {' '.join(self.cmd)} exited with "
                               f"{self.proc.returncode}")
        return printed, wall

    @classmethod
    def stop_all(cls) -> None:
        for launch in list(cls.running):
            launch.stop()


def check_gloo_collectives() -> None:
    """Assert that gloo carries the DP path's collectives between this
    process and the group's others on the card (NCCL refuses two ranks
    on one device): all_reduce (sum; max on uint8), all_gather and
    broadcast of CUDA tensors, each result checked."""
    import torch.distributed as dist

    dev = torch.device("cuda:0")
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((1000,), rank + 1.0, device=dev)
    dist.all_reduce(x)
    used = torch.tensor([rank == 0, rank == world - 1, 0], dtype=torch.uint8, device=dev)
    dist.all_reduce(used, op=dist.ReduceOp.MAX)
    parts = [torch.empty(2, device=dev) for _ in range(world)]
    dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
    b = torch.full((2,), float(rank), device=dev)
    dist.broadcast(b, 0)
    assert x.sum().item() == 1000 * world * (world + 1) / 2, x[:3]
    assert used.tolist() == [1, 1, 0], used
    assert [p.tolist() for p in parts] == [[float(r)] * 2 for r in range(world)], parts
    assert b.tolist() == [0.0, 0.0], b
    print(f"gloo rank {rank}: carries all_reduce, all_gather and broadcast on cuda:0")


def host_profile(loop) -> dict:
    """One more train step of ``loop`` (eager; nothing logged or saved)
    under torch.profiler: its wall ms, its host launch calls (kernels,
    copies, memsets) and {operator: [calls, self host ms]}. The step is
    the second of two profiled sessions: a process's first session pays
    the tracer's start-up, which can double a step's host time, so only
    second sessions compare across processes."""
    from torch.profiler import ProfilerActivity, profile

    batch = loop.to_device(loop.prepare_batch(next(iter(loop.data_loader))))
    for session in range(2):
        generator = step_generator(0, 10**6 + session, loop.device)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loop.train_step(batch, generator)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    launches = sum(e.device_type() != cuda and any(k in e.name() for k in _LAUNCH_CALLS)
                   for e in prof.profiler.kineto_results.events())
    ops = {e.key: [e.count, e.self_cpu_time_total / 1e3] for e in prof.key_averages()
           if e.self_cpu_time_total > 0}
    return dict(wall_ms=wall_ms, launches=launches, ops=ops)


def _state_bytes(loop) -> dict:
    """This rank's bytes of parameters, EMA shadows and AdamW moments."""
    from vq_voice_swap_torch.parallel import local_tensor

    def size(ts):
        return sum(local_tensor(t).numel() * t.element_size() for t in ts)

    moments = [v for st in loop.optimizer.adamw.state.values() for v in st.values() if v.ndim]
    return {"params": size(loop.model.parameters()),
            "emas": sum(size(e.model.parameters()) for e in loop.emas), "adamw": size(moments)}


def rank_main(spec: str) -> int:
    """One rank of phase 7's runs, ``spec`` a JSON {"root", "steps",
    "gloo", "runs": [{"name", "k", "argv"}]}: each run is the
    flagship's loop for ``steps`` steps with deterministic algorithms, the
    launch counts set to 0 just before it; each writes rank<r>.json into
    its directory (root/name): the logged values, launches, seconds, peak
    device memory, state bytes and the codebook's digest, and for a run
    with "profile" one more step's ``host_profile``. With ``gloo``
    the group starts over gloo (the ranks share cuda:0) and its
    collectives are checked first."""
    import hashlib

    from vq_voice_swap_torch.parallel import full_tensor, init_distributed, rank

    spec = json.loads(spec)
    steps = spec["steps"]
    if spec["gloo"]:
        init_distributed("cuda:0", "gloo")
        check_gloo_collectives()
    for run in spec["runs"]:
        out = os.path.join(spec["root"], run["name"].replace(" ", "_"))
        argv = run["argv"] + ["--max-steps", str(steps), "--save-interval", str(steps),
                              "--output-dir", out]
        if run["k"] > 1:
            argv += ["--steps-per-dispatch", str(run["k"])]
        with deterministic(True), recorded_log([]) as raw:
            loop = VQVAETrainLoop(VQVAETrainLoop.arg_parser().parse_args(argv))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            loop.loop()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        vq = loop.model.vq
        digest = hashlib.sha256()
        for t in (full_tensor(vq.dictionary), vq.usage_count):
            digest.update(t.detach().cpu().numpy().tobytes())
        result = dict(counts=read_counts(), raw=raw, seconds=seconds,
                      peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                      state=_state_bytes(loop), codebook=digest.hexdigest(),
                      world=loop.world, device=str(loop.device),
                      route="cuda_graph" if loop.graphed_step else "eager")
        if run["profile"]:
            result["profile"] = host_profile(loop)
        with open(os.path.join(out, f"rank{rank()}.json"), "w") as f:
            json.dump(result, f)
        loop.logger.close()
        del loop
        gc.collect()
    return 0


def parallel_runs(workdir: str, nproc: int, runs, gloo: bool = False):
    """Start phase-7 runs of PARALLEL_STEPS steps in one launch of
    ``nproc`` ranks (0: without the launcher); ``parallel_results`` waits
    for them."""
    spec = dict(root=workdir, steps=PARALLEL_STEPS, gloo=gloo,
                runs=[dict(name=n, k=k, argv=a, profile=n in PROFILED) for n, k, a in runs])
    launch = Launch(workdir, ", ".join(n for n, _, _ in runs), nproc,
                    [RANK_RUN, json.dumps(spec)])
    return launch, nproc, runs, gloo


def parallel_results(workdir: str, started):
    """{name: (its directory, each rank's result)} of the runs that
    ``parallel_runs`` started."""
    launch, nproc, runs, gloo = started
    printed, wall = launch.wait()
    if gloo:
        assert printed.count(" carries ") == nproc, printed[-3000:]
    out = {}
    for name, _, _ in runs:
        d = os.path.join(workdir, name.replace(" ", "_"))
        ranks = []
        for r in range(max(nproc, 1)):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        out[name] = (d, ranks)
    print(f"launch of {', '.join(out)} ({max(nproc, 1)} process(es)"
          f"{', under torchrun' if nproc else ''}): {wall:.1f} s wall")
    return out


def _leaf_errors(got_path: str, want_path: str, n: int = 3):
    """The ``n`` parameter leaves of the largest |got - want| over the
    leaf's largest entry: [(error, leaf)]."""
    with np.load(got_path) as got, np.load(want_path) as want:
        errs = []
        for k in want.files:
            if k.startswith("params/"):
                w = want[k].astype(np.float64)
                errs.append((float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)), k))
    return sorted(errs, reverse=True)[:n]


def fsdp_state_bytes(whole: int, worlds) -> dict:
    """{N: the state bytes of one rank under FSDP at N ranks}: the
    flagship's parameters, EMA and two AdamW moments (float32), each leaf
    cut along the axis fsdp_placements picks, the rest whole; ``whole``
    is the world-size-1 count that the runs measured."""
    from vq_voice_swap_torch.parallel import fsdp_placements

    with torch.device("meta"):
        model = VQVAE(pred_name="unet", base_channels=64, enc_name="unet128", cond_mult=16,
                      dictionary_size=512, num_labels=3)
    total = sum(p.numel() for p in model.parameters())
    assert 4 * 4 * total == whole, (total, whole)
    out = {}
    for n in worlds:
        placements = fsdp_placements(model, n)
        local = sum(p.numel() // (1 if placements[name] is None else n)
                    for name, p in model.named_parameters())
        out[n] = 4 * 4 * local
    return out


def parallel_paths(workdir: str, smi: str):
    """The flagship's loop in bf16 with deterministic algorithms, in three
    launches of fresh processes that run together: without the launcher;
    under torchrun at world size 1 with NCCL, DP, then --fsdp, then DP at
    --steps-per-dispatch 4; and two ranks on the card over gloo (NCCL
    refuses two ranks on one device) at per-rank batch 8, DP and then
    FSDP. Asserts that gloo carries the collectives between the two
    processes, DP and K=4 have the plain
    run's bits (logged values, model and EMA), FSDP within 1e-3 of its
    losses (or its bits), every rank's launches a step (1 VQ and 178
    GroupNorm statistics, apply and backward), the two ranks' losses
    within 1e-2 of the one-rank DP run's at batch 16 with one codebook on
    both ranks, the FSDP ranks' state bytes as the placements count them,
    and their sharded ``--checkpoint-format dcp`` save read whole here
    (finite, the DP run's usage counts); prints samples/s, peak device
    memory and state bytes per rank (under FSDP at 2-8 ranks also counted
    from the placements). Returns {run name, rank: counts}."""
    gn_vqvae = GN_PER_PREDICTOR + GN_PER_ENCODER128
    argv = TRAIN_VQVAE_ARGV + ["--bf16", "--device", "cuda"]
    half = TRAIN_VQVAE_ARGV[:TRAIN_VQVAE_ARGV.index("--batch-size")] + [
        "--batch-size", str(BATCH // 2), "--bf16", "--device", "cuda:0"]
    started = [
        parallel_runs(workdir, 0, [("plain", 1, argv)]),
        parallel_runs(workdir, 1, [("dp", 1, argv), ("fsdp", 1, argv + ["--fsdp"]),
                                   ("dp k4", GRAPH_K, argv)]),
        parallel_runs(workdir, 2, [("gloo dp 2", 1, half), ("gloo fsdp 2", 1, half + [
            "--fsdp", "--checkpoint-format", "dcp"])], gloo=True)]
    runs = {}
    for launch in started:
        runs.update(parallel_results(workdir, launch))

    counts = {}
    for name, (out, ranks) in runs.items():
        k = GRAPH_K if name == "dp k4" else 1
        calls = PARALLEL_STEPS if k == 1 else WARMUP_STEPS + 1 + PARALLEL_STEPS % k
        for r, res in enumerate(ranks):
            c = res["counts"]
            assert c["group_norm_coeffs"] == c["group_norm_apply"] == gn_vqvae * calls, (name, c)
            assert c["group_norm_backward"] == c["_bwd_cluster"] == gn_vqvae * calls, (name, c)
            assert c["vq_assign"] == calls, (name, c)
            assert res["world"] == len(ranks) and res["route"] == (
                "cuda_graph" if k > 1 else "eager"), (name, res["route"])
            counts[f"{name} rank {r}"] = c
        log = _train_log(out)
        assert [s for s, _ in log] == list(range(1, PARALLEL_STEPS + 1)), (name, log)
        assert all(np.isfinite(v) for _, f in log for v in f.values()), name
        res = ranks[0]
        if k == 1:
            rate = float(np.median([v["samples_per_sec"] for _, v in res["raw"]][2:-1]))
            how = f"median of steps 3-{PARALLEL_STEPS - 1}"
        else:
            rate, how = res["raw"][-1][1]["samples_per_sec"], "the last window"
        print(f"parallel {name} on {smi}: world {res['world']} ({res['device']}, steps "
              f"{res['route']}), {PARALLEL_STEPS} steps in {res['seconds']:.3f} s of the loop, "
              f"samples/s {rate:.4f} ({how}), peak device memory a rank "
              f"{[round(x['peak_gib'], 3) for x in ranks]} GiB, state bytes a rank "
              f"{[x['state'] for x in ranks]}, launches a rank a step: VQ "
              f"{res['counts']['vq_assign'] / calls:g}, GroupNorm statistics "
              f"{res['counts']['group_norm_coeffs'] / calls:g}, apply "
              f"{res['counts']['group_norm_apply'] / calls:g}, backward "
              f"{res['counts']['group_norm_backward'] / calls:g}")

    def raw(name):
        return [tuple(x) for x in runs[name][1][0]["raw"]]

    def same(a: str, b: str):
        """(loss error, the worst leaves' parameter errors, the same bits
        in the logged values, model and EMA) of two runs."""
        da, db = runs[a][0], runs[b][0]
        model = _npz_leaf_errors(os.path.join(da, "model.npz"), os.path.join(db, "model.npz"))
        ema = _npz_leaf_errors(os.path.join(da, "model_ema_0.9999.npz"),
                               os.path.join(db, "model_ema_0.9999.npz"))
        bits = model[2] and ema[2] and _logged(raw(a)) == _logged(raw(b))
        worst = _leaf_errors(os.path.join(da, "model.npz"), os.path.join(db, "model.npz"))
        return _loss_error(raw(a), raw(b)), worst, bits

    print(f"parallel runs against the plain run, {PARALLEL_STEPS} steps, deterministic "
          f"algorithms, on {smi}: loss error (relative), the worst leaves' parameter error "
          f"(of the leaf's largest entry), the same bits (logs, model, EMA):")
    results = {n: same(n, "plain") for n in ("dp", "fsdp", "dp k4")}
    for n, (loss, worst, bits) in results.items():
        print(f"  {n}: {loss:.3g}, {[(float(f'{e:.3g}'), leaf) for e, leaf in worst]}, {bits}")
    assert results["dp"][2] and results["dp k4"][2], results
    base = runs["plain"][1][0]["profile"]
    for n in PROFILED:
        prof = runs[n][1][0]["profile"]
        print(f"  one more eager step of {n}, profiled on {smi}: wall {prof['wall_ms']:.3f} ms, "
              f"{prof['launches']} host launch calls, self host ms of every operator "
              f"{sum(ms for _, ms in prof['ops'].values()):.3f}")
        if n == "plain":
            continue
        grew = sorted(((ms - base["ops"].get(key, [0, 0.0])[1], key, c,
                        base["ops"].get(key, [0, 0.0])[0]) for key, (c, ms) in prof["ops"].items()),
                      reverse=True)[:8]
        for extra, key, c, c0 in grew:
            print(f"    {key[:60]}: +{extra:.3f} self host ms against plain, calls {c0} -> {c}")
    assert results["fsdp"][2] or results["fsdp"][0] <= 1e-3, results["fsdp"]
    dp_state = sum(runs["dp"][1][0]["state"].values())
    fsdp_state = sum(runs["fsdp"][1][0]["state"].values())
    counted = fsdp_state_bytes(dp_state, (2, 4, 8))
    assert fsdp_state == dp_state
    print(f"  state bytes a rank at world size 1: DP {dp_state}, FSDP {fsdp_state}; under FSDP "
          f"at N ranks, counted from the placements (parameters, EMA, two AdamW moments, "
          f"float32): " + ", ".join(f"N={n} {b} ({b / dp_state:.4f} of DP)"
                                    for n, b in counted.items()))
    for name in ("gloo dp 2", "gloo fsdp 2"):
        ranks = runs[name][1]
        loss = _loss_error(raw(name), raw("dp"))
        one_codebook = len({x["codebook"] for x in ranks}) == 1
        print(f"  {name}: two gloo ranks on one card, batch {BATCH // 2} each, against DP "
              f"at batch {BATCH}: loss error {loss:.3g} (relative), one codebook on both "
              f"ranks {one_codebook}, codebook_used {_codebook_used(raw(name))}")
        assert loss <= 1e-2 and one_codebook, name
    measured = [sum(x["state"].values()) for x in runs["gloo fsdp 2"][1]]
    print(f"  state bytes a rank, two ranks: DP {sum(runs['gloo dp 2'][1][0]['state'].values())}"
          f", FSDP {measured} (counted: {counted[2]})")
    assert measured == [counted[2]] * 2
    # The two ranks' sharded dcp save, read whole in this process as every
    # CLI reads it (ModelBase.load, no process group), and its EMA on the card.
    from vq_voice_swap_torch.convert import params_to_jax

    fsdp_dir = runs["gloo fsdp 2"][0]
    saved = params_to_jax(VQVAE.load(os.path.join(fsdp_dir, "model.dcp"), device="cpu"))
    ema_dirs = [f for f in os.listdir(fsdp_dir) if f.startswith("model_ema_")]
    ema = VQVAE.load(os.path.join(fsdp_dir, ema_dirs[0]), device=torch.device("cuda:0"))
    assert ema_dirs[0].endswith(".dcp") and all(torch.isfinite(p).all()
                                                for p in ema.parameters())
    print(f"  gloo fsdp 2's {ema_dirs[0]} read onto the card by VQVAE.load: every leaf finite")
    del ema
    with np.load(os.path.join(runs["gloo dp 2"][0], "model.npz")) as dp:
        assert set(saved) == {k for k in dp.files if k.startswith(("params/", "buffers/"))}
        worst = max((np.abs(saved[k] - dp[k]).max() / max(np.abs(dp[k]).max(), 1e-30), k)
                    for k in saved if k.startswith("params/"))
        assert np.array_equal(saved["buffers/vq/usage_count"], dp["buffers/vq/usage_count"])
    print(f"  gloo fsdp 2's model.dcp (two ranks' shards) read whole in one process: every "
          f"leaf finite {all(np.isfinite(v).all() for v in saved.values())}, the usage counts "
          f"the DP run's, parameters within {worst[0]:.3g} of a leaf's largest entry of "
          f"the DP run's ({worst[1]})")
    assert all(np.isfinite(v).all() for v in saved.values())
    for out, _ in runs.values():
        shutil.rmtree(out)
    return counts


# ------------------------------------------------------------------ phase 8

# Tensor parallelism: one torchrun launch of TP_RANKS ranks sharing the
# card over gloo (NCCL refuses two ranks on one device), a grid of
# TP_RANKS / TP_SIZE data rows by TP_SIZE model columns, each rank running
# this script's tp_rank_main. Beside each run, its world-1 counterpart in
# this process on the same weights and seed.
TP_SIZE = 2
TP_RANKS = 4
TP_DEVICE = "cuda:0"
TP_SPEC = "--tp-run"
# Sampler depth cut from 10 and 5 steps to keep the script inside its time
# limit.
TP_SWAP_STEPS = 4
TP_SAMPLE_STEPS = 3
TP_TRAIN_STEPS = 2  # cut from 3 (the script's time limit)
TP_TRAIN_BATCH = 4  # the global batch: TP_TRAIN_BATCH / data rows a rank
# Stated tolerances, of the largest magnitude of the world-1 output (or 1):
# the swap in f32 with TF32 off (4 DPM++ steps; a cut convolution computes
# each output channel from the whole input, and three runs on an H100 gave
# 0), bf16 sampling (the batch's rows split over the data rows as well;
# three runs gave at most 6.26e-3); the training runs' losses, relative, as
# phase 7's two ranks against one.
TP_SWAP_TOL = 1e-6
TP_SAMPLE_TOL = 2e-2
TP_LOSS_TOL = 1e-2


def _swap_argv(ckpt: str, clip: str, out: str):
    return ["--label", "7", "--input-file", clip, "--sample-steps", str(TP_SWAP_STEPS),
            "--sampler", "dpmpp", ckpt, out]


def _sample_argv(ckpt: str, out: str):
    return ["--checkpoint-path", ckpt, "--bf16", "--fuse-levels", str(FUSE_LEVELS),
            "--sampler", "ddpm", "--schedule", "quadratic", "--sample-steps",
            str(TP_SAMPLE_STEPS), "--num-samples", "2", "--batch-size", "2",
            "--sample-path", out]


def _tp_train_argv(out: str, batch: int):
    argv = TRAIN_VQVAE_ARGV[:TRAIN_VQVAE_ARGV.index("--batch-size")]
    return argv + ["--batch-size", str(batch), "--bf16", "--max-steps", str(TP_TRAIN_STEPS),
                   "--save-interval", str(TP_TRAIN_STEPS), "--output-dir", out]


@contextlib.contextmanager
def recorded_outputs(into: dict):
    """Record what the sampling CLIs produce: the swap's (audio, codes)
    from ``sample_vqvae.convert`` and each float sample array that
    ``sample_diffusion.write_wav`` writes, by file name."""
    convert, write = sample_vqvae.convert, sample_diffusion.write_wav

    def record_convert(*args, **kwargs):
        audio, codes = convert(*args, **kwargs)
        into["swap"] = (audio.float().cpu().numpy(), codes.cpu().numpy())
        return audio, codes

    def record_write(path, samples, encoding):
        into[os.path.basename(path)] = np.array(samples, np.float32)
        return write(path, samples, encoding)

    sample_vqvae.convert, sample_diffusion.write_wav = record_convert, record_write
    try:
        yield into
    finally:
        sample_vqvae.convert, sample_diffusion.write_wav = convert, write


def _timed(fn):
    """(fn's result, wall seconds, launch counts, peak GiB) with the counts
    set to 0 and the peak reset just before."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts(), torch.cuda.max_memory_allocated() / 2**30


def tp_runs(root: str, ckpt: str, uncond_ckpt: str, clip: str, tp: bool) -> dict:
    """Phase 8's runs, as a rank of the grid (``tp``: with
    --tensor-parallel, on cuda:0) or in this process: the swap (f32, TF32
    off), bf16 sampling, then the flagship's training at the global batch
    without and with --fsdp (only under ``tp``; deterministic). Returns
    {run: its wall seconds, launches, peak GiB and what it produced}."""
    from vq_voice_swap_torch.parallel import full_tensor, rank

    me = rank()
    flags = ["--device", TP_DEVICE] + (["--tensor-parallel", str(TP_SIZE)] if tp else [])
    tag = "tp" if tp else "one"
    res = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with recorded_outputs({}) as got:
        _, seconds, counts, peak = _timed(lambda: sample_vqvae.main(
            _swap_argv(ckpt, clip, os.path.join(root, f"swap_{tag}.wav")) + flags))
    res["swap"] = dict(seconds=seconds, counts=counts, peak_gib=peak)
    if me == 0:
        np.save(os.path.join(root, f"swap_{tag}_audio.npy"), got["swap"][0])
        np.save(os.path.join(root, f"swap_{tag}_codes.npy"), got["swap"][1])
    torch.backends.cudnn.allow_tf32 = True
    with recorded_outputs({}) as got:
        _, seconds, counts, peak = _timed(lambda: sample_diffusion.main(
            _sample_argv(uncond_ckpt, os.path.join(root, f"samples_{tag}")) + flags))
    res["sampling"] = dict(seconds=seconds, counts=counts, peak_gib=peak)
    if me == 0:
        for name, samples in got.items():
            np.save(os.path.join(root, f"samples_{tag}_{name}.npy"), samples)
    train = [("one", TP_TRAIN_BATCH, [])] if not tp else [
        ("tp", TP_TRAIN_BATCH * TP_SIZE // TP_RANKS, flags),
        ("tp fsdp", TP_TRAIN_BATCH * TP_SIZE // TP_RANKS, flags + ["--fsdp"])]
    for name, batch, extra in train:
        out = os.path.join(root, "train_" + name.replace(" ", "_"))
        argv = _tp_train_argv(out, batch) + (extra or ["--device", TP_DEVICE])
        with deterministic(True), recorded_log([]) as raw:
            loop, seconds, counts, peak = _timed(lambda: _run_loop(argv))
        vq = loop.model.vq
        res[name] = dict(seconds=seconds, counts=counts, peak_gib=peak, raw=raw, out=out,
                         state=_state_bytes(loop), codebook=float(
                             full_tensor(vq.dictionary).double().sum().item()))
        if name != "tp fsdp":  # one more step, profiled, where the host time goes
            res[name]["profile"] = host_profile(loop)
            if tp:  # steps without deterministic algorithms: whole leaves still agree
                res[name]["whole_digest"] = _whole_digest(loop)
        loop.logger.close()
        del loop
        gc.collect()
    return res


def _whole_digest(loop) -> str:
    """A digest of the bytes of the parameters and EMA copies that the
    model groups hold whole (the dictionary, the 1-channel output convs)."""
    import hashlib

    from vq_voice_swap_torch.parallel import cut_axes, full_tensor

    cut = cut_axes(loop.model)
    digest = hashlib.sha1()
    for model in [loop.model] + [e.model for e in loop.emas]:
        for n, p in model.named_parameters():
            if n not in cut:
                digest.update(full_tensor(p).detach().cpu().contiguous().view(torch.uint8)
                              .numpy().tobytes())
    return digest.hexdigest()


def _run_loop(argv):
    loop = VQVAETrainLoop(VQVAETrainLoop.arg_parser().parse_args(argv))
    loop.loop()
    return loop


def tp_rank_main(spec: str) -> int:
    """One rank of phase 8's launch, ``spec`` a JSON {"root", "ckpt",
    "uncond", "clip"}: the group over gloo on cuda:0 (its collectives
    checked), then ``tp_runs``; writes rank<r>.json into root."""
    from vq_voice_swap_torch.parallel import init_distributed, rank

    spec = json.loads(spec)
    init_distributed(TP_DEVICE, "gloo")
    check_gloo_collectives()
    res = tp_runs(spec["root"], spec["ckpt"], spec["uncond"], spec["clip"], tp=True)
    with open(os.path.join(spec["root"], f"rank{rank()}.json"), "w") as f:
        json.dump(res, f)
    return 0


def tp_state_bytes(model_size: int, data_size: int, fsdp: bool) -> int:
    """The state bytes of one rank (the flagship's parameters, EMA and two
    AdamW moments, float32) on a grid of ``model_size`` columns, each leaf
    cut as tp_placements (and, with ``fsdp``, fsdp_placements over
    ``data_size`` rows) cut it."""
    from vq_voice_swap_torch.parallel import fsdp_placements, tp_placements

    with torch.device("meta"):
        model = VQVAE(pred_name="unet", base_channels=64, enc_name="unet128", cond_mult=16,
                      dictionary_size=512, num_labels=3)
    cut = tp_placements(model, model_size)
    data = fsdp_placements(model, data_size, model_size) if fsdp else {}
    return 16 * sum(p.numel() // (model_size if cut[n] is not None else 1)
                    // (data_size if data.get(n) is not None else 1)
                    for n, p in model.named_parameters())


def _scaled_error(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over the larger of 1 and max |want|."""
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / max(1.0, np.abs(want).max()))


def tensor_parallel_start(workdir: str, ckpt: str, uncond_ckpt: str) -> Launch:
    """Start phase 8's launch of TP_RANKS ranks."""
    root = os.path.join(workdir, "tp")
    os.makedirs(root)
    clip = os.path.join(workdir, "in.wav")
    spec = json.dumps(dict(root=root, ckpt=ckpt, uncond=uncond_ckpt, clip=clip))
    return Launch(workdir, "tensor parallelism", TP_RANKS, [TP_SPEC, spec])


def tensor_parallel_world1(workdir: str, ckpt: str, uncond_ckpt: str):
    """Phase 8's world-1 runs in this process: (their results, seconds)."""
    t0 = time.perf_counter()
    one = tp_runs(os.path.join(workdir, "tp"), ckpt, uncond_ckpt,
                  os.path.join(workdir, "in.wav"), tp=False)
    return one, time.perf_counter() - t0


def tensor_parallel_paths(workdir: str, smi: str, launch: Launch, world1_runs) -> dict:
    """Phase 8, its ranks started by ``tensor_parallel_start`` and its
    world-1 runs by ``tensor_parallel_world1``: the swap (phase 3's model,
    f32 with TF32 off, 4 DPM++ steps), bf16 sampling (phase 3's
    unconditional unet64, --fuse-levels 2, 2 samples, 3 steps) and the
    bf16 flagship's training (global batch 4, 2 steps, deterministic,
    without and with --fsdp, and one more profiled step without it) on
    TP_RANKS gloo ranks at TP_SIZE model columns, against their world-1
    runs in this process. Asserts the swap's codes equal and its samples,
    the sampled files and the losses within the stated tolerances; the
    whole leaves the same bytes on every rank after the profiled steps;
    every rank's
    launches equal to the world-1 run's (the swap: 1 VQ and 131
    GroupNorm statistics and apply a predictor call; sampling: 10 of each
    fused kernel a step; training: 1 VQ and 178 GroupNorm statistics,
    apply and backward a step); and every rank's state bytes equal to the
    placements' count. Prints each run's wall seconds, rate and peak
    device memory a rank. Returns {run, rank: launch counts}."""
    root = os.path.join(workdir, "tp")
    one, world1 = world1_runs
    printed, wall = launch.wait()
    assert printed.count(" carries ") == TP_RANKS, printed[-3000:]
    ranks = []
    for r in range(TP_RANKS):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"phase 8 on {smi}: the world-1 runs {world1:.1f} s in this process; one launch of "
          f"{TP_RANKS} gloo ranks on {TP_DEVICE}, {TP_RANKS // TP_SIZE} data rows x {TP_SIZE} "
          f"model columns: {wall:.1f} s wall (beside phase 5)")
    counts = {}

    def same_launches(run: str, per: str, calls: int):
        """Each rank launches every kernel as the world-1 run does, but the
        serving bf16 convolution: a rank's column shards (Cout / TP_SIZE)
        fit the route's rule where some whole layers do not (256 -> 256),
        so every rank launches it alike and at least as often."""
        want = dict(one[run if run in one else "one"]["counts"])
        conv = want.pop("conv1d_bf16")
        first = ranks[0][run]["counts"]["conv1d_bf16"]
        for r, res in enumerate(ranks):
            c = dict(res[run]["counts"])
            counts[f"{run} rank {r}"] = res[run]["counts"]
            rank_conv = c.pop("conv1d_bf16")
            assert c == want, (run, r, c, want)
            assert rank_conv == first >= conv, (run, r, rank_conv, conv)
        c = ranks[0][run]["counts"]
        return ", ".join(f"{k} {v / calls:g}" for k, v in c.items() if v) + f" a {per}"

    # The swap.
    audio, codes = (np.load(os.path.join(root, f"swap_tp_{k}.npy")) for k in ("audio", "codes"))
    want_audio, want_codes = (np.load(os.path.join(root, f"swap_one_{k}.npy"))
                              for k in ("audio", "codes"))
    err = _scaled_error(audio, want_audio)
    launches = same_launches("swap", "predictor call", TP_SWAP_STEPS)
    print(f"  swap (f32, TF32 off, {TP_SWAP_STEPS} DPM++ steps, 4 s): codes equal "
          f"{np.array_equal(codes, want_codes)}, samples within {err:.3g} of the world-1 "
          f"run's (limit {TP_SWAP_TOL}); wall {[round(x['swap']['seconds'], 3) for x in ranks]}"
          f" s a rank, model load included (world 1: {one['swap']['seconds']:.3f} s), RTF "
          f"{SAMPLES / SAMPLE_RATE / ranks[0]['swap']['seconds']:.4f}x (world 1: "
          f"{SAMPLES / SAMPLE_RATE / one['swap']['seconds']:.4f}x); peak device memory a rank "
          f"{[round(x['swap']['peak_gib'], 3) for x in ranks]} GiB (world 1: "
          f"{one['swap']['peak_gib']:.3f}); launches a rank: {launches}")
    assert np.array_equal(codes, want_codes) and err <= TP_SWAP_TOL
    assert ranks[0]["swap"]["counts"]["vq_assign"] == 1
    assert ranks[0]["swap"]["counts"]["group_norm_coeffs"] == GN_PER_PREDICTOR * TP_SWAP_STEPS

    # Sampling.
    names = sorted(os.listdir(os.path.join(root, "samples_one")))
    assert sorted(os.listdir(os.path.join(root, "samples_tp"))) == names, names
    errs = [_scaled_error(np.load(os.path.join(root, f"samples_tp_{n}.npy")),
                          np.load(os.path.join(root, f"samples_one_{n}.npy"))) for n in names]
    launches = same_launches("sampling", "step", TP_SAMPLE_STEPS)
    rate = [2 / x["sampling"]["seconds"] for x in ranks]
    print(f"  sampling (bf16, --fuse-levels {FUSE_LEVELS}, {TP_SAMPLE_STEPS} steps, 2 samples "
          f"split over the data rows): files {names}, the world-1 run's; samples within "
          f"{[float(f'{e:.3g}') for e in errs]} (limit {TP_SAMPLE_TOL}); samples/s a rank "
          f"{[round(r, 4) for r in rate]} (world 1: {2 / one['sampling']['seconds']:.4f}); "
          f"peak device memory a rank {[round(x['sampling']['peak_gib'], 3) for x in ranks]} "
          f"GiB; launches a rank: {launches}")
    assert max(errs) <= TP_SAMPLE_TOL
    conv = one["sampling"]["counts"]["conv1d_bf16"]
    print(f"  sampling: serving bf16 convolution launches a rank "
          f"{ranks[0]['sampling']['counts']['conv1d_bf16']}, world 1 {conv}")
    assert conv == CONV_BF16_PER_FUSED_PREDICTOR * TP_SAMPLE_STEPS, conv
    assert ranks[0]["sampling"]["counts"]["fused_resblock_stats"] == \
        ranks[0]["sampling"]["counts"]["fused_resblock_apply"] == \
        FUSED_PER_PREDICTOR * TP_SAMPLE_STEPS

    # Training.
    dp = tp_state_bytes(1, 1, False)  # a rank's under DP: 984,246,288 (phase 7)
    assert sum(one["one"]["state"].values()) == dp, (one["one"]["state"], dp)
    want_raw = [tuple(x) for x in one["one"]["raw"]]
    gn = GN_PER_PREDICTOR + GN_PER_ENCODER128
    for name, fsdp in (("tp", False), ("tp fsdp", True)):
        launches = same_launches(name, "step", TP_TRAIN_STEPS)
        c = ranks[0][name]["counts"]
        assert c["group_norm_coeffs"] == c["group_norm_apply"] == gn * TP_TRAIN_STEPS, c
        assert c["group_norm_backward"] == c["_bwd_cluster"] == gn * TP_TRAIN_STEPS, c
        assert c["vq_assign"] == TP_TRAIN_STEPS, c
        raw = [tuple(x) for x in ranks[0][name]["raw"]]
        loss = _loss_error(raw, want_raw)
        counted = tp_state_bytes(TP_SIZE, TP_RANKS // TP_SIZE, fsdp)
        measured = [sum(x[name]["state"].values()) for x in ranks]
        rates = [v["samples_per_sec"] for _, v in raw[1:-1]] or [raw[-1][1]["samples_per_sec"]]
        print(f"  training {name} (bf16 flagship, global batch {TP_TRAIN_BATCH}, "
              f"{TP_TRAIN_STEPS} steps, deterministic): loss error {loss:.3g} against the "
              f"world-1 run (limit {TP_LOSS_TOL}), losses {[round(v['loss'], 5) for _, v in raw]}"
              f" (world 1: {[round(v['loss'], 5) for _, v in want_raw]}), one codebook on every "
              f"rank {len({x[name]['codebook'] for x in ranks}) == 1}; samples/s "
              f"{[round(r, 4) for r in rates]} (world 1: "
              f"{[round(v['samples_per_sec'], 4) for _, v in want_raw[1:-1]]}); wall "
              f"{[round(x[name]['seconds'], 1) for x in ranks]} s a rank; peak device memory "
              f"a rank {[round(x[name]['peak_gib'], 3) for x in ranks]} GiB (world 1: "
              f"{one['one']['peak_gib']:.3f}); state bytes a rank {measured} (counted from the "
              f"placements: {counted}, {counted / dp:.4f} of DP's {dp}); launches a rank: "
              f"{launches}")
        assert loss <= TP_LOSS_TOL and measured == [counted] * TP_RANKS, (name, loss, measured)
        assert len({x[name]["codebook"] for x in ranks}) == 1, name
        if name == "tp":
            digests = {x[name]["whole_digest"] for x in ranks}
            print(f"  after two more steps without deterministic algorithms, the whole leaves "
                  f"(parameters and EMA) are the same bytes on every rank: {len(digests) == 1}")
            assert len(digests) == 1, digests
        log = _train_log(ranks[0][name]["out"])
        assert [s for s, _ in log] == list(range(1, TP_TRAIN_STEPS + 1)), log
    for name, prof in (("world 1", one["one"]["profile"]),
                       ("tp rank 0", ranks[0]["tp"]["profile"])):
        top = sorted(prof["ops"].items(), key=lambda kv: -kv[1][1])[:6]
        print(f"  one more eager train step of {name}, profiled on {smi}: wall "
              f"{prof['wall_ms']:.1f} ms, {prof['launches']} host launch calls; the most self "
              f"host ms: " + ", ".join(f"{k[:40]} {ms:.1f} ({c} calls)" for k, (c, ms) in top))
    print(f"  every run's outputs gathered over gloo: the rates above time the staging of "
          f"each activation gather through host memory between processes on one card, not "
          f"NVLink tensor parallelism")
    shutil.rmtree(root)
    return counts


# ------------------------------------------------------------------ phase 9

# Sequence parallelism: one torchrun launch of SEQ_RANKS ranks sharing the
# card over gloo, each holding a contiguous quarter of the time axis and
# running this script's seq_rank_main. Beside each run, its world-1 run in
# this process: the same CLI or step at one rank, the whole sequence on one
# device.
SEQ_RANKS = 4
SEQ_DEVICE = "cuda:0"
SEQ_SPEC = "--seq-run"
# Phase 5's flagship VQ-VAE (the tones flagship's configuration: unet64
# predictor, unet128 encoder, the three tones speakers), seeded.
SEQ_VQVAE_KWARGS = dict(pred_name="unet", base_channels=64, enc_name="unet128", cond_mult=16,
                        dictionary_size=512, num_labels=3)
SEQ_VQVAE_PARAMS = 61_515_393
SEQ_SWAP_SAMPLES = 4688 * 1024  # 300.032 s: a multiple of 256 x 4 ranks, kept whole by both
SEQ_SWAP_STEPS = 10
SEQ_SWAP_LABEL = 1
SEQ_TRAIN_STEPS = 2  # cut from 3 (the script's time limit)
SEQ_TRAIN_BATCH = 2
SEQ_TRAIN_SAMPLES = 16 * SAMPLE_RATE
# Stated limits (the predictions are ten times tighter): the conversion's
# f32 samples (TF32 off) of the world-1 run's largest magnitude (of one
# device's decode of the sharded run's codes where a near-tie of two codes
# went the other way), the losses relative to the world-1 run's; the
# GroupNorm merge sums in another order than one device's.
SEQ_SWAP_TOL = 1e-3
SEQ_LOSS_TOL = 1e-3
SEQ_ENC_TOL = 1e-4  # the encoder outputs, of the world-1 run's largest magnitude
SEQ_TIE_TOL = 1e-4  # a near-tie of two codes: their distances, relative


def _seq_argv(ckpt: str, clip: str, out: str):
    return ["--checkpoint-path", ckpt, "--input", clip, "--output", out, "--label",
            str(SEQ_SWAP_LABEL), "--steps", str(SEQ_SWAP_STEPS), "--sampler", "dpmpp",
            "--device", SEQ_DEVICE]


@contextlib.contextmanager
def recorded_codes(into: list):
    """Record each vq_forward's (encoder output, codes) of this process."""
    from vq_voice_swap_torch import vq

    forward = vq.vq_forward

    def record(dictionary, x):
        out = forward(dictionary, x)
        into.append((x.float().cpu().numpy(), out["idxs"].cpu().numpy()))
        return out

    vq.vq_forward = record
    try:
        yield into
    finally:
        vq.vq_forward = forward


def seq_runs(root: str, vqvae: str, diffusion: str, clip: str) -> dict:
    """Phase 9's runs in this process, over as many ranks as its group
    has (one without a group): ``long_audio_convert`` of the 5-minute clip
    (f32, TF32 off, SEQ_SWAP_STEPS DPM++ steps), then SEQ_TRAIN_STEPS steps of
    ``make_seq_parallel_train_step`` on the unet64 diffusion model at
    batch 2 of 16 s (deterministic algorithms). Writes the gathered
    conversion and this rank's codes into root; returns {run: wall
    seconds, launches, peak GiB, collectives, ...}."""
    from vq_voice_swap_torch import long_audio_convert
    from vq_voice_swap_torch.parallel import rank
    from vq_voice_swap_torch.parallel import sequence as sq
    from vq_voice_swap_torch.train import build_optimizer

    me, dev = rank(), torch.device(SEQ_DEVICE)
    mesh = sq.create_seq_mesh()
    tag = f"w{mesh.size}"
    res = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sq.COLLECTIVES.clear()
    printed = _Tee(sys.stdout)
    with recorded_codes([]) as codes, contextlib.redirect_stdout(printed):
        out, seconds, counts, peak = _timed(lambda: long_audio_convert.main(
            _seq_argv(vqvae, clip, os.path.join(root, f"swap_{tag}.wav"))))
    decode = float(re.search(r"decoded in ([0-9.]+)s", printed.getvalue()).group(1)) \
        if me == 0 else None
    res["swap"] = dict(seconds=seconds, decode_s=decode, counts=counts, peak_gib=peak,
                       collectives=dict(sq.COLLECTIVES))
    (enc, idxs), = codes
    np.save(os.path.join(root, f"codes_{tag}_{me}.npy"), idxs)
    np.save(os.path.join(root, f"enc_{tag}_{me}.npy"), enc)
    if me == 0:
        np.save(os.path.join(root, f"swap_{tag}.npy"), out)
    del out, codes, enc

    model = DiffusionModel.load(diffusion, device=dev)
    opt = build_optimizer(model.predictor, lr=1e-4)
    step = sq.make_seq_parallel_train_step(mesh, model.diffusion, model.predictor, opt)
    clips = np.stack([speech_like(20 + i, SEQ_TRAIN_SAMPLES) for i in range(SEQ_TRAIN_BATCH)])
    x = sq.shard_sequence(mesh, torch.from_numpy(clips[:, :, None]).to(dev))
    sq.COLLECTIVES.clear()
    losses, step_s = [], []

    def train():
        for i in range(SEQ_TRAIN_STEPS):
            t0 = time.perf_counter()
            loss, per = step(x, generator=step_generator(0, i, dev))
            losses.append([loss.item()] + per.tolist())
            step_s.append(time.perf_counter() - t0)

    with deterministic(True):
        _, seconds, counts, peak = _timed(train)
    res["train"] = dict(seconds=seconds, step_s=step_s, losses=losses, counts=counts,
                        peak_gib=peak, collectives=dict(sq.COLLECTIVES))
    del model, opt, step, x
    gc.collect()
    torch.cuda.empty_cache()
    return res


def seq_rank_main(spec: str) -> int:
    """One rank of phase 9's launch, ``spec`` a JSON {"root", "vqvae",
    "diffusion", "clip"}: the group over gloo on cuda:0 (its collectives
    checked), then ``seq_runs``; writes rank<r>.json into root."""
    from vq_voice_swap_torch.parallel import init_distributed, rank

    spec = json.loads(spec)
    init_distributed(SEQ_DEVICE, "gloo")
    check_gloo_collectives()
    res = seq_runs(spec["root"], spec["vqvae"], spec["diffusion"], spec["clip"])
    with open(os.path.join(spec["root"], f"rank{rank()}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _seq_checkpoints(workdir: str):
    """The seeded flagship VQ-VAE (its codebook centred on the encoder's
    outputs over four 4 s clips) and unet64 diffusion model, saved."""
    dev = torch.device(SEQ_DEVICE)
    model = VQVAE(**SEQ_VQVAE_KWARGS)
    seed_weights(model, 3)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == SEQ_VQVAE_PARAMS, n_params
    model = model.to(dev).eval()
    clips = np.stack([speech_like(30 + i, SAMPLES) for i in range(4)])
    with torch.no_grad():
        enc = model.encode_raw(torch.from_numpy(clips[:, :, None]).to(dev))
        model.vq.dictionary.copy_(
            enc.mean(dim=(0, 1)) + model.vq.dictionary * enc.std(dim=1).mean())
    vqvae = os.path.join(workdir, "seq_vqvae.npz")
    model.save(vqvae)
    diffusion = DiffusionModel(**UNCOND_KWARGS)
    seed_weights(diffusion, 4)
    path = os.path.join(workdir, "seq_diffusion.npz")
    diffusion.save(path)
    del model, enc, diffusion
    torch.cuda.empty_cache()
    return vqvae, path, n_params


def _codes_check(enc1: np.ndarray, enc4: np.ndarray, dictionary: np.ndarray,
                 codes1: np.ndarray, codes4: np.ndarray):
    """(codes that differ, the encoder outputs' largest difference over
    their largest magnitude, the largest relative gap between the two
    codes' float64 distances at a differing row). Asserts that each
    differing row's two codes are a near-tie under either run's encoder
    output: distances within SEQ_TIE_TOL relative, a gap that float32
    distances of these magnitudes (the VQ kernel's 3xTF32 arithmetic) and
    the encoder outputs' rounding can rank either way."""
    d64 = dictionary.astype(np.float64)
    e1 = enc1.reshape(-1, d64.shape[1]).astype(np.float64)
    e4 = enc4.reshape(-1, d64.shape[1]).astype(np.float64)
    c1, c4 = codes1.reshape(-1), codes4.reshape(-1)
    diff = np.nonzero(c1 != c4)[0]
    gap = 0.0
    for i in diff:
        for e in (e1[i], e4[i]):
            a, b = (np.sum((e - d64[k]) ** 2) for k in (c1[i], c4[i]))
            gap = max(gap, abs(a - b) / max(a, b))
            assert abs(a - b) <= SEQ_TIE_TOL * max(a, b), (i, c1[i], c4[i], a, b)
    return len(diff), float(np.abs(e1 - e4).max() / np.abs(e1).max()), gap


@torch.no_grad()
def _decode_codes(vqvae: str, codes: np.ndarray) -> np.ndarray:
    """The one-device decode of ``codes`` [1, T1] as ``long_audio_convert``
    decodes its own (seed 0: x_T, then the sampler's draws; label
    SEQ_SWAP_LABEL; SEQ_SWAP_STEPS DPM++ steps with the x0 constraint)."""
    from vq_voice_swap_torch.parallel import sequence as sq

    dev = torch.device(SEQ_DEVICE)
    model = VQVAE.load(vqvae, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cond = model.vq.dictionary[torch.from_numpy(codes).to(dev)]
    x_T = torch.randn((1, cond.shape[1] * model.encoder.downsample_rate, 1), generator=gen,
                      device=dev)
    out = sq.seq_parallel_sample(sq.create_seq_mesh(), model.diffusion, model.predictor, x_T,
                                 SEQ_SWAP_STEPS, gen, cond=cond,
                                 labels=torch.tensor([SEQ_SWAP_LABEL], device=dev),
                                 sampler="dpmpp", constrain=True)
    return out.reshape(-1).cpu().numpy()


def sequence_parallel_start(workdir: str):
    """Write phase 9's checkpoints and clip and start its launch of
    SEQ_RANKS ranks: (the launch, the VQ-VAE's path, the diffusion
    model's, its parameter count)."""
    root = os.path.join(workdir, "seq")
    os.makedirs(root)
    vqvae, diffusion, n_params = _seq_checkpoints(workdir)
    clip = os.path.join(workdir, "long.wav")
    write_wav(clip, speech_like(11, SEQ_SWAP_SAMPLES))
    spec = json.dumps(dict(root=root, vqvae=vqvae, diffusion=diffusion, clip=clip))
    return Launch(workdir, "sequence parallelism", SEQ_RANKS, [SEQ_SPEC, spec]), vqvae, \
        diffusion, n_params


def sequence_parallel_world1(workdir: str, started):
    """Phase 9's world-1 runs in this process: (their results, seconds)."""
    _, vqvae, diffusion, _ = started
    t0 = time.perf_counter()
    one = seq_runs(os.path.join(workdir, "seq"), vqvae, diffusion,
                   os.path.join(workdir, "long.wav"))
    return one, time.perf_counter() - t0


def sequence_parallel_paths(workdir: str, smi: str, started, world1_runs) -> dict:
    """Phase 9, its ranks started by ``sequence_parallel_start`` and its
    world-1 runs by ``sequence_parallel_world1``: ``long_audio_convert``
    of a 5-minute speech-like clip with the flagship VQ-VAE (f32, TF32
    off, 10 DPM++ steps, label 1) and 2 steps of
    ``make_seq_parallel_train_step`` on the unet64 diffusion model at
    batch 2 of 16 s, on SEQ_RANKS gloo ranks sharing the card,
    against their world-1 runs in this process (which convert the clip on
    one device: GroupNorm groups of 19.2 M elements at unet64's first up
    level, beyond 2^24). Asserts the encoder outputs within
    SEQ_ENC_TOL, each differing code a near-tie (``_codes_check``; the
    samples then held to one device's decode of the sharded run's codes),
    the samples and losses within the stated limits, and every rank's
    launches: the conversion 1 VQ and 131 GroupNorm statistics and apply a
    predictor call plus the encoder's 47, training 131 statistics, apply,
    split reduce and split dx a step, and no group_norm_coeffs, cluster
    backward or fused launch. Prints wall seconds, RTF, peak GiB a rank
    and the collectives. Returns {run, rank: launch counts}."""
    launch, vqvae, diffusion, n_params = started
    root = os.path.join(workdir, "seq")
    seconds_audio = SEQ_SWAP_SAMPLES / SAMPLE_RATE
    one, world1 = world1_runs
    printed, wall = launch.wait()
    assert printed.count(" carries ") == SEQ_RANKS, printed[-3000:]
    ranks = []
    for r in range(SEQ_RANKS):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"phase 9 on {smi}: the world-1 runs {world1:.1f} s in this process; one launch of "
          f"{SEQ_RANKS} gloo ranks on {SEQ_DEVICE}, the time axis cut in {SEQ_RANKS}: "
          f"{wall:.1f} s wall (beside phase 6 and the world-1 runs)")
    counts = {}
    zero = ("group_norm_coeffs", "group_norm_backward", "_bwd_cluster", "_bwd_two_kernel",
            "fused_resblock_stats", "fused_resblock_apply")

    def launches(run: str, want: dict):
        for r, res in enumerate(ranks + [one]):
            c = res[run]["counts"]
            counts[f"{run} {'world 1' if r == SEQ_RANKS else f'rank {r}'}"] = c
            assert all(c[k] == 0 for k in zero), (run, r, c)
            assert all(c[k] == v for k, v in want.items()), (run, r, c, want)
        return ", ".join(f"{k} {v}" for k, v in ranks[0][run]["counts"].items() if v)

    # The conversion.
    gn_swap = GN_PER_ENCODER128 + GN_PER_PREDICTOR * SEQ_SWAP_STEPS
    swap_launches = launches("swap", dict(vq_assign=1, group_norm_stats=gn_swap,
                                          group_norm_apply=gn_swap, group_norm_bwd_reduce=0,
                                          group_norm_bwd_dx=0))
    codes, enc = (np.concatenate([np.load(os.path.join(root, f"{k}_w{SEQ_RANKS}_{r}.npy"))
                                  for r in range(SEQ_RANKS)], axis=1) for k in ("codes", "enc"))
    want_codes = np.load(os.path.join(root, "codes_w1_0.npy"))
    dictionary = next(v for k, v in _params_npz(vqvae).items() if k.endswith("dictionary"))
    ties, enc_err, gap = _codes_check(np.load(os.path.join(root, "enc_w1_0.npy")), enc,
                                      dictionary, want_codes, codes)
    got, want = (np.load(os.path.join(root, f"swap_w{w}.npy")) for w in (SEQ_RANKS, 1))
    held_to = "the world-1 run's"
    if ties:  # the conditioning differs there: hold the samples to one device's decode of it
        want, held_to = _decode_codes(vqvae, codes), "one device's decode of the same codes"
    err = _scaled_error(got, want)
    col = ranks[0]["swap"]["collectives"]
    calls = {k: v for k, v in col.items() if not k.endswith(" bytes")}
    print(f"  long_audio_convert ({seconds_audio:.3f} s of audio, the flagship VQ-VAE, "
          f"{n_params} parameters, f32, TF32 off, {SEQ_SWAP_STEPS} DPM++ steps): "
          f"encoder outputs within {enc_err:.3g} of the world-1 run's largest magnitude "
          f"(limit {SEQ_ENC_TOL}); {codes.size} codes, {ties} different (near-ties: their "
          f"distances within {gap:.3g} relative, limit {SEQ_TIE_TOL}), "
          f"{len(np.unique(want_codes))} distinct; samples "
          f"within {err:.3g} of {held_to}, of its largest magnitude {np.abs(want).max():.4f} "
          f"(limit {SEQ_SWAP_TOL}); decode "
          f"{ranks[0]['swap']['decode_s']:.3f} s at {SEQ_RANKS} ranks, RTF "
          f"{seconds_audio / ranks[0]['swap']['decode_s']:.4f}x (world 1: "
          f"{one['swap']['decode_s']:.3f} s, {seconds_audio / one['swap']['decode_s']:.4f}x); "
          f"wall with the model load {[round(x['swap']['seconds'], 3) for x in ranks]} s a "
          f"rank (world 1 {one['swap']['seconds']:.3f}); peak device memory a rank "
          f"{[round(x['swap']['peak_gib'], 3) for x in ranks]} GiB (world 1: "
          f"{one['swap']['peak_gib']:.3f}); collectives a rank {calls}, bytes sent a rank "
          f"{ {k[:-6]: v for k, v in col.items() if k.endswith(' bytes')} }; launches a "
          f"rank: {swap_launches}")
    assert err <= SEQ_SWAP_TOL and enc_err <= SEQ_ENC_TOL and np.isfinite(got).all()

    # Training.
    gn_train = GN_PER_PREDICTOR * SEQ_TRAIN_STEPS
    train_launches = launches("train", dict(vq_assign=0, group_norm_stats=gn_train,
                                            group_norm_apply=gn_train,
                                            group_norm_bwd_reduce=gn_train,
                                            group_norm_bwd_dx=gn_train))
    got_l, want_l = (np.array(x["train"]["losses"]) for x in (ranks[0], one))
    loss_err = float(np.abs(got_l / want_l - 1).max())
    col = ranks[0]["train"]["collectives"]
    rate = [SEQ_TRAIN_BATCH * SEQ_TRAIN_SAMPLES / SAMPLE_RATE / s
            for s in ranks[0]["train"]["step_s"]]
    print(f"  seq-parallel train step (unet64 diffusion model, batch {SEQ_TRAIN_BATCH} of "
          f"{SEQ_TRAIN_SAMPLES // SAMPLE_RATE} s, f32, TF32 off, deterministic, "
          f"{SEQ_TRAIN_STEPS} steps): losses {[round(float(v[0]), 6) for v in got_l]} (world "
          f"1 {[round(float(v[0]), 6) for v in want_l]}), largest relative error {loss_err:.3g} of "
          f"the loss and per-element losses (limit {SEQ_LOSS_TOL}), the same on every rank "
          f"{all(x['train']['losses'] == ranks[0]['train']['losses'] for x in ranks)}; step "
          f"seconds {[round(v, 3) for v in ranks[0]['train']['step_s']]} (world 1 "
          f"{[round(v, 3) for v in one['train']['step_s']]}), seconds of audio a second "
          f"{[round(v, 3) for v in rate]}; peak device memory a rank "
          f"{[round(x['train']['peak_gib'], 3) for x in ranks]} GiB (world 1: "
          f"{one['train']['peak_gib']:.3f}); collectives a rank "
          f"{ {k: v for k, v in col.items() if not k.endswith(' bytes')} }; launches a rank: "
          f"{train_launches}")
    assert loss_err <= SEQ_LOSS_TOL and np.isfinite(got_l).all()
    assert all(x["train"]["losses"] == ranks[0]["train"]["losses"] for x in ranks)
    print("  every collective staged through host memory by gloo between processes on one "
          "card: the times above are not an interconnect's")
    shutil.rmtree(root)
    return counts


# ----------------------------------------------------------------- phase 10

# The int8 activation path at MIN_T 16000: a 4 s clip's top three UNet
# levels (64000, 32000, 16000 samples) are int8. Per unet64 predictor call
# (from the code, and a CPU count at base 4): the stem's output, 3 x 3
# same-resolution and down blocks at those levels and the deeper up path's
# Launches a unet64 predictor call at T 64000 and MIN_T 16000 (levels 0-2,
# at 64000, 32000 and 16000 samples, store int8), by site and prologue:
# - 20 blocks write an int8 output (down: 2 and the pooling block at levels
#   0 and 1, 2 at level 2; up: level 3's upsampling block, 3 and the
#   upsampling block at levels 2 and 1, 3 at level 0): 20 residual-prologue
#   quantizes, and their norm_mid 20 GroupNorm-prologue ones (float input,
#   FiLM), each after a float statistics launch;
# - norm_in where conv_in's input is int8 and no avg pool sits between: 17
#   on int8 input (down 2 a level at levels 0-2; up 4 at levels 2 and 1, 3
#   at level 0) after an int8 statistics launch, 1 on float input (level
#   3's upsampling block, whose codes are then repeated): 18 GroupNorm-
#   prologue quantizes;
# - 3 quantizes with no prologue: the stem and the pooled norm_in outputs
#   at levels 0 and 1 (the three pooling blocks' norm_in on int8 input stays
#   the int8 statistics and apply launches, as does out_norm);
# - 50 int8 convolutions (2 a block, 3 with a skip projection).
# Each quantize is 2 launches. GroupNorms: 21 read int8 (17 + 3 pooling
# blocks + out_norm; 4 of them apply), 110 read float (21 fused into a
# quantize, 89 apply): 131 in all.
INT8_MIN_T = 16000
INT8_PER_PREDICTOR = dict(quantize=2 * 3, quantize_group_norm=2 * 38, quantize_residual=2 * 20,
                          conv1d_int8=50, group_norm_coeffs_int8=21, group_norm_apply_int8=4,
                          group_norm_coeffs=110, group_norm_apply=89)
INT8_SAMPLE_STEPS = 5


@contextlib.contextmanager
def plain_versions():
    """The UNet's kernels replaced by their plain versions, on whatever
    device: the int8 path's (quantize, the convolution, the int8 GroupNorm),
    the float GroupNorm's and the serving bf16 convolution's (the rule
    routes nothing, so every float convolution runs ``F.conv1d``)."""
    def group_norm_plain(x, weight, bias, num_groups, eps, use_gelu, film=None):
        coeffs = gn.group_norm_coeffs_plain(x, num_groups, weight, bias, eps, film)
        return gn.group_norm_apply_plain(x, *coeffs, use_gelu)

    def conv_plain(qa, weight, bias, *, stride=1, dilation=1, dtype=None, conv=None):
        return conv_int8_plain(qa, weight, bias, stride, dilation, dtype)

    plain = dict(quantize=qact.quantize_plain, conv1d_int8=conv_plain,
                 qact_group_norm=qact.qact_group_norm_plain, group_norm=group_norm_plain,
                 group_norm_coeffs=gn.group_norm_coeffs_plain,
                 group_norm_coeffs_int8=gn.group_norm_coeffs_int8_plain,
                 quantize_group_norm=qact.quantize_group_norm_plain,
                 quantize_residual=qact.quantize_residual_plain,
                 routes=lambda *args: False)
    saved = {k: getattr(layers, k) for k in plain}
    for k, v in plain.items():
        setattr(layers, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(layers, k, v)


def int8_against_plain(name: str, call, int8_model, float_model, bf16: bool) -> None:
    """One predictor call through the kernels against the same call through
    the plain versions on the card. A code that flips at a .5 boundary (the
    kernels' float GroupNorm rounds otherwise than the plain one) moves the
    next statistics and flips more codes downstream, so at full depth the
    two int8 outputs differ as two quantizations of one float forward do:
    two independent ones would differ by sqrt(2) of the int8 path's own
    error (the plain int8 output against the float model's). They are held
    to 1.5 times that error (L2) and to a correlation above 0.995 (f32) or
    0.98 (bf16)."""
    with torch.no_grad():
        got = call(int8_model).double().flatten()
        with plain_versions():
            want = call(int8_model).double().flatten()
        floating = call(float_model).double().flatten()
    assert torch.isfinite(got).all()
    gap, quant = (got - want).norm().item(), (want - floating).norm().item()
    corr = torch.corrcoef(torch.stack([got, want]))[0, 1].item()
    print(f"phase 10 {name}: one predictor call, kernels vs plain versions on the card: "
          f"L2 gap {gap:.4g} against the int8 path's own L2 error {quant:.4g} (plain int8 vs "
          f"float), max |gap| / max |out| {(got - want).abs().max().item() / want.abs().max().item():.3g}, "
          f"correlation {corr:.6f}")
    assert gap < 1.5 * quant and corr > (0.98 if bf16 else 0.995), name


def no_host_sync(name: str, call) -> None:
    """One call with the CUDA sync debug mode at "error": any host sync
    inside it raises."""
    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"phase 10 {name}: one predictor call under sync debug mode \"error\": no host sync")


def timed_cli(cli, argv) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def int8_serving_paths(dev, workdir: str, ckpt: str, uncond_ckpt: str, smi: str) -> dict:
    """Phase 10: the sampling CLIs with --act-int8 16000 at full width,
    each beside the same CLI without it in this process. Returns each int8
    run's launch counts."""
    counts = {}
    gen = torch.Generator(device=dev).manual_seed(10)
    runs = [
        ("sampling bf16", sample_diffusion, [
            "--checkpoint-path", uncond_ckpt, "--bf16", "--sampler", "dpmpp",
            "--schedule", "quadratic", "--sample-steps", str(INT8_SAMPLE_STEPS),
            "--num-samples", str(BATCH), "--batch-size", str(BATCH), "--device", "cuda"],
         INT8_SAMPLE_STEPS, BATCH * SAMPLES / SAMPLE_RATE),
        ("swap f32", sample_vqvae, [
            "--label", "7", "--input-file", os.path.join(workdir, "in.wav"),
            "--sample-steps", "10", "--sampler", "dpmpp", "--device", "cuda"],
         10, SAMPLES / SAMPLE_RATE),
    ]
    for name, cli, argv, calls, audio_s in runs:
        int8 = ["--act-int8", str(INT8_MIN_T)]
        outs = iter(range(5))

        def path():
            """A new output each run (sample_diffusion skips complete batches)."""
            out = os.path.join(workdir, f"int8_{name.split()[0]}_{next(outs)}")
            return ["--sample-path", out] if cli is sample_diffusion else [ckpt, out + ".wav"]

        reset_counts()
        timed_cli(cli, argv + int8 + path())  # also the first int8 launches' compiles
        counts[name] = read_counts()
        want = {k: v * calls for k, v in INT8_PER_PREDICTOR.items()}
        want.update(vq_assign=0 if cli is sample_diffusion else 1, group_norm_stats=0,
                    group_norm_backward=0, fused_resblock_stats=0, fused_resblock_apply=0,
                    conv1d_bf16=CONV_BF16_PER_INT8_PREDICTOR * calls if "bf16" in name else 0)
        got = {k: counts[name][k] for k in want}
        print(f"phase 10 {name} --act-int8 {INT8_MIN_T} on {smi}: launches {got}")
        assert got == want, (name, got, want)
        seconds = {"int8": [], "float": []}
        for kind in ("float", "int8") * 2:
            seconds[kind].append(timed_cli(cli, argv + (int8 if kind == "int8" else []) + path()))
        rtf = {k: audio_s / float(np.median(v)) for k, v in seconds.items()}
        print(f"phase 10 {name}: CLI wall s (model load included), in turns: int8 "
              f"{seconds['int8']}, float {seconds['float']}; RTF of the medians: int8 "
              f"{rtf['int8']:.3f}x, float {rtf['float']:.3f}x (int8 / float "
              f"{rtf['int8'] / rtf['float']:.3f})")

        dtype = "bfloat16" if "bf16" in name else None
        cls, saved = (DiffusionModel, uncond_ckpt) if cli is sample_diffusion else (VQVAE, ckpt)
        m8 = cls.load(saved, dtype=dtype, device=dev, act_int8_min_t=INT8_MIN_T)
        mf = cls.load(saved, dtype=dtype, device=dev)
        rows = BATCH  # as phase 4's profiles
        x = torch.randn(rows, SAMPLES, 1, generator=gen, device=dev)
        ts = torch.full((rows,), 0.5, device=dev)
        if cli is sample_diffusion:
            def call(m):
                return m.predict_eps(x, ts)
        else:
            cond = torch.randn(rows, SAMPLES // 320, m8.cond_channels, generator=gen, device=dev)
            labels = torch.full((rows,), 7, device=dev)

            def call(m):
                return m.predict_eps(x, ts, cond, labels)
        torch.backends.cudnn.allow_tf32 = False
        int8_against_plain(name, call, m8, mf, dtype is not None)
        torch.backends.cudnn.allow_tf32 = True
        no_host_sync(name, lambda: call(m8))
        launches, _ = profile_call(lambda: call(m8), f"phase 10 {name} int8 predictor call")
        print(f"  phase 10 {name}: {launches} kernel launches in one int8 predictor call")
        profile_call(lambda: call(mf), f"phase 10 {name} float predictor call")
        del m8, mf
        torch.cuda.empty_cache()

    # The third sampling CLI: classifier-free guidance, one predictor call a
    # step on the stacked batch.
    reset_counts()
    sample_vqvae_uncond.main([
        "--label", "7", "--input-file", os.path.join(workdir, "in.wav"), "--sample-steps",
        "10", "--sampler", "dpmpp", "--guide-label-scale", "1", "--device", "cuda",
        "--act-int8", str(INT8_MIN_T), ckpt, os.path.join(workdir, "int8_uncond.wav")])
    torch.cuda.synchronize()
    counts["uncond f32"] = read_counts()
    want = {k: v * 10 for k, v in INT8_PER_PREDICTOR.items()}
    want.update(vq_assign=1, group_norm_backward=0, conv1d_bf16=0)
    got = {k: counts["uncond f32"][k] for k in want}
    print(f"phase 10 sample_vqvae_uncond --act-int8 {INT8_MIN_T}: launches {got}")
    assert got == want, (got, want)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == [RANK_RUN]:
        return rank_main(sys.argv[2])
    if sys.argv[1:2] == [TP_SPEC]:
        return tp_rank_main(sys.argv[2])
    if sys.argv[1:2] == [SEQ_SPEC]:
        return seq_rank_main(sys.argv[2])
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
    check_group_norm_long_span(dev, gen)
    kernels.append(check_group_norm_split_backward(dev, gen))
    check_group_norm_training_grads(dev, gen)
    kernels += check_fused_resblock(dev, gen)
    kernels += check_int8_kernels(dev, gen)
    kernels.append(check_conv1d_bf16(dev, gen))
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
            if k["name"] in ("group_norm_bwd_split", "conv1d_bf16") or k["name"] in INT8_KERNELS:
                continue  # phases 4, 9 and 10 set them
            path = sampling_launches if k["name"].startswith("fused") else swap_launches
            k["launches"] = sum(path[w] for w in KERNEL_WRAPPERS.get(k["name"], (k["name"],)))
        print(f"phase 3: {time.perf_counter() - t_start:.1f} s")
        conv_launches = serving_time(dev, ckpt, clips, smi)
        for k in kernels:
            if k["name"] == "conv1d_bf16":  # phase 4's bf16 swap
                k["launches"] = conv_launches
        sampling_serving_time(dev, uncond_ckpt, smi)
        guided_serving_time(dev, ckpt, uncond_ckpt, ep_ckpt, clf_ckpt, clips, smi)
        check_tickets("the main paths and serving")
        print(f"phase 4: {time.perf_counter() - t_start:.1f} s")
        # The host's cores, not the card, bound the multi-process phases, and
        # this process uses few of them: phase 8's ranks (~11 GB of the card)
        # work beside phase 5 and phase 9's (~15 GB) beside phase 6; phase
        # 7's three launches (~50 GB) run alone after them. So the rates and
        # profiles of phases 5, 6, 8 and 9 are taken on a shared card.
        tp_launch = tensor_parallel_start(workdir, ckpt, uncond_ckpt)
        # Training after the serving phases' profiler checks, as it ran
        # before training was ported.
        training = training_paths(dev, workdir, clips, smi)
        print("training launches, all runs: " + ", ".join(
            f"{k} {sum(c[k] for c in training.values())}" for k in (
                "vq_assign", "group_norm_coeffs", "group_norm_apply", "group_norm_backward")))
        check_tickets("the training paths")
        reference_pt_swap(dev, workdir, ckpt)
        print(f"phase 5: {time.perf_counter() - t_start:.1f} s (beside phase 8's ranks)")
        torch.cuda.empty_cache()
        seq_started = sequence_parallel_start(workdir)
        # Real-audio data and eval, from the tones flagship's bf16 run
        # (training_run's directory for "vqvae bf16"), phase 3's
        # unconditional unet64 and classifier.
        flagship = os.path.join(workdir, "vqvae_bf16", "model.npz")
        evals = data_eval_paths(dev, workdir, smi, flagship, uncond_ckpt, clf_ckpt)
        print(f"phase 6: {time.perf_counter() - t_start:.1f} s (beside phase 9's ranks)")
        print("data and eval launches, all runs: " + ", ".join(
            f"{k} {sum(c[k] for c in evals.values())}" for k in (
                "vq_assign", "group_norm_coeffs", "group_norm_apply", "group_norm_backward")))
        # Phases 8 and 9: their world-1 runs here, then their ranks' results.
        torch.cuda.empty_cache()
        tp_one = tensor_parallel_world1(workdir, ckpt, uncond_ckpt)
        seq_one = sequence_parallel_world1(workdir, seq_started)
        tensor_parallel = tensor_parallel_paths(workdir, smi, tp_launch, tp_one)
        print(f"phase 8: {time.perf_counter() - t_start:.1f} s")
        print("tensor-parallel launches, all ranks: " + ", ".join(
            f"{k} {sum(c[k] for c in tensor_parallel.values())}" for k in (
                "vq_assign", "group_norm_coeffs", "group_norm_apply", "group_norm_backward",
                "fused_resblock_stats", "fused_resblock_apply")))
        sequence = sequence_parallel_paths(workdir, smi, seq_started, seq_one)
        print(f"phase 9: {time.perf_counter() - t_start:.1f} s")
        print("sequence-parallel launches, all ranks and the world-1 runs: " + ", ".join(
            f"{k} {sum(c[k] for c in sequence.values())}" for k in (
                "vq_assign", "group_norm_stats", "group_norm_apply", "group_norm_bwd_reduce",
                "group_norm_bwd_dx", "group_norm_coeffs", "_bwd_cluster")))
        for k in kernels:
            if k["name"] == "group_norm_bwd_split":  # phase 9's training, rank 0
                c = sequence["train rank 0"]
                k["launches"] = c["group_norm_bwd_reduce"] + c["group_norm_bwd_dx"]
        torch.cuda.empty_cache()
        parallel = parallel_paths(workdir, smi)
        print(f"phase 7: {time.perf_counter() - t_start:.1f} s")
        print("parallel launches, all ranks: " + ", ".join(
            f"{k} {sum(c[k] for c in parallel.values())}" for k in (
                "vq_assign", "group_norm_coeffs", "group_norm_apply", "group_norm_backward")))
        int8 = int8_serving_paths(dev, workdir, ckpt, uncond_ckpt, smi)
        print(f"phase 10: {time.perf_counter() - t_start:.1f} s")
        for k in kernels:
            if k["name"] in INT8_KERNELS:
                k["launches"] = sum(c[w] for c in int8.values()
                                    for w in KERNEL_WRAPPERS.get(k["name"], (k["name"],)))
    check_tickets("the data and eval paths")
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        Launch.stop_all()  # no launch outlives a failed phase
    sys.exit(code)
