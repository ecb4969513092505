#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vq_voice_swap_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. Device: print the card's name and power limit (nvidia-smi), build the
   CUDA kernel from csrc/.
2. Kernels vs their plain PyTorch versions at the main path's shapes, in
   full float32 (TF32 off): GroupNorm statistics and apply (Triton) at
   [16, 64, 64000] in f32 and bf16, [16, 512, 250] with and without GELU
   and FiLM, and a large-mean input (f32 atol 1e-4, bf16 atol 2e-2); VQ
   assignment (CUDA) at B=3200 and B=3201, C=1024, D=512, and an exact-tie
   case (indices equal up to true ties, used masks equal). Each kernel is
   timed (CUDA events, warm) beside its bound, its plain version and a
   library call for the same work.
3. Main path: a full-width VQ-VAE (unet64 predictor, conv-mfcc-ulaw
   encoder, 512 x 1024 codebook, 251 labels) on seeded weights is saved
   in the JAX .npz format and driven through
   ``python -m vq_voice_swap_torch.sample_vqvae``'s ``main`` on a 4 s WAV,
   with DPM++ (10 steps) and DDPM (5 steps). Asserts 64000 output samples
   and the kernel launch counts (VQ once per encode, GroupNorm 131 per
   predictor call).
4. Serving time: encode + 10-step DPM++ decode of 16 clips in f32 (TF32
   convolutions, PyTorch's default) and bf16, a torch.profiler breakdown
   of one predictor call by kernel class with its kernel launch count, and
   the launches, device time and host time that the torch ops around the
   GroupNorm kernels add to that call.

The line before the last is a JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.
"""

import json
import math
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

from vq_voice_swap_torch import sample_vqvae  # noqa: E402
from vq_voice_swap_torch.ops import cuda_build  # noqa: E402
from vq_voice_swap_torch.ops import group_norm as gn  # noqa: E402
from vq_voice_swap_torch.ops import vq_assign as vqa  # noqa: E402
from vq_voice_swap_torch.vq_vae import VQVAE  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet), at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

SAMPLE_RATE = 16000
SAMPLES = 4 * SAMPLE_RATE
BATCH = 16
GN_PER_PREDICTOR = 131  # 65 ResBlocks x 2 + out_norm
MODEL_KWARGS = dict(pred_name="unet", base_channels=64, enc_name="conv-mfcc-ulaw",
                    dictionary_size=512, num_labels=251)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters warm launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float):
    """Least time for the work on the card, and which side bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
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
    """Stats and apply kernels vs plain; returns their JSON entries."""
    cases = [
        # (label, shape, dtype, gelu, film, offset, atol)
        ("flagship f32", (BATCH, 64, SAMPLES), torch.float32, True, False, 0.0, 1e-4),
        ("flagship bf16", (BATCH, 64, SAMPLES), torch.bfloat16, True, False, 0.0, 2e-2),
        ("deep f32 film+gelu", (BATCH, 512, 250), torch.float32, True, True, 0.0, 1e-4),
        ("deep f32 plain", (BATCH, 512, 250), torch.float32, False, False, 0.0, 1e-4),
        ("deep bf16 film+gelu", (BATCH, 512, 250), torch.bfloat16, True, True, 0.0, 2e-2),
        ("large-mean f32", (BATCH, 64, SAMPLES), torch.float32, False, False, 100.0, 1e-4),
    ]
    err_stats = err_apply = 0.0
    for label, shape, dtype, use_gelu, use_film, offset, atol in cases:
        n, c, _ = shape
        groups = 32
        x = (torch.randn(shape, generator=gen, device=dev) + offset).to(dtype)
        w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
        b = 0.2 * torch.randn(c, generator=gen, device=dev)
        film = None
        if use_film:
            film = tuple(
                (0.5 * torch.randn(n, c, generator=gen, device=dev)).to(dtype)
                for _ in range(2)
            )
        mean_k, var_k = gn.group_norm_stats(x, groups)
        mean_p, var_p = gn.group_stats_plain(x, groups)
        e_mean = (mean_k - mean_p).abs().max().item()
        e_var = ((var_k - var_p).abs() / var_p).max().item()
        folded = gn.fold_affine(mean_p, var_p, w, b, 1e-5, film)
        y_p = gn.group_norm_apply_plain(x, *folded, use_gelu)
        e_apply = out_err(gn.group_norm_apply(x, *folded, use_gelu), y_p)
        e_full = out_err(gn.group_norm(x, w, b, groups, 1e-5, use_gelu, film), y_p)
        torch.cuda.synchronize()
        print(f"groupnorm {label} {list(shape)}: mean err {e_mean:.3g}, "
              f"var rel err {e_var:.3g}, apply err {e_apply:.3g}, "
              f"stats+apply err {e_full:.3g} (atol {atol})")
        assert e_var <= 1e-4 and e_apply <= atol and e_full <= atol, label
        if dtype == torch.float32:
            err_stats = max(err_stats, e_mean, (var_k - var_p).abs().max().item())
            err_apply = max(err_apply, e_apply)

    # Timing at the largest main-path GroupNorm: [16, 64, 64000] f32.
    n, c, t = BATCH, 64, SAMPLES
    groups = 32
    x = torch.randn((n, c, t), generator=gen, device=dev)
    w = torch.ones(c, device=dev)
    b = torch.zeros(c, device=dev)
    mean_p, var_p = gn.group_stats_plain(x, groups)
    folded = gn.fold_affine(mean_p, var_p, w, b, 1e-5)
    x_bytes = x.numel() * x.element_size()
    n_chunks = math.ceil(c // groups * t / gn.STATS_CHUNK)
    stats_ms = cuda_ms(lambda: gn.group_norm_stats(x, groups), 20)
    stats_plain = cuda_ms(lambda: gn.group_stats_plain(x, groups), 20)
    stats_lib = cuda_ms(
        lambda: torch.var_mean(x.view(n * groups, -1), dim=1, correction=0), 20
    )
    apply_ms = cuda_ms(lambda: gn.group_norm_apply(x, *folded, True), 20)
    apply_plain = cuda_ms(lambda: gn.group_norm_apply_plain(x, *folded, True), 20)
    full_ms = cuda_ms(lambda: gn.group_norm(x, w, b, groups, 1e-5, True), 20)
    full_lib = cuda_ms(lambda: F.gelu(F.group_norm(x, groups, w, b, 1e-5)), 20)
    # Stats: x read once, 3 partials per (row, chunk) written; ~4 flops/elem.
    sb, sby = bound_ms(x_bytes + 3 * 4 * n * groups * n_chunks, 4 * x.numel())
    # Apply: x read + y written + 3 [N, C] vectors; ~25 flops/elem with erf.
    ab, aby = bound_ms(2 * x_bytes + 3 * 4 * n * c, 25 * x.numel())
    print(f"groupnorm timing {[n, c, t]} f32: stats {stats_ms:.4f} ms "
          f"(plain {stats_plain:.4f}, var_mean {stats_lib:.4f}, bound {sb:.4f}); "
          f"apply+gelu {apply_ms:.4f} ms (plain {apply_plain:.4f}, bound {ab:.4f}); "
          f"whole GroupNorm+GELU {full_ms:.4f} ms vs F.group_norm+F.gelu "
          f"{full_lib:.4f} ms")
    return [
        dict(name="group_norm_stats", route="triton",
             source="vq_voice_swap_torch/ops/group_norm.py",
             replaces="vq_voice_swap_tpu/ops/fused_norm.py:84",
             launches=0, max_abs_err=err_stats, ms=stats_ms, plain_ms=stats_plain,
             bound_ms=sb, bound_by=sby, library_ms=stats_lib),
        dict(name="group_norm_apply", route="triton",
             source="vq_voice_swap_torch/ops/group_norm.py",
             replaces="vq_voice_swap_tpu/ops/fused_norm.py:115",
             launches=0, max_abs_err=err_apply, ms=apply_ms, plain_ms=apply_plain,
             bound_ms=ab, bound_by=aby, library_ms=None),
    ]


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
    for b in (BATCH * 200, BATCH * 200 + 1):
        x = torch.randn(b, c, generator=gen, device=dev)
        idx, used = vqa.vq_assign(dictionary, x)
        pidx, pused = vqa.vq_assign_plain(dictionary, x)
        torch.cuda.synchronize()
        gap, rel = _vq_pick_gap(dictionary, x, idx, pidx)
        differ = int((idx != pidx).sum().item())
        print(f"vq B={b}: {differ} indices differ from plain, largest gap "
              f"{gap:.3g} ({rel:.3g} relative)")
        assert rel <= 1e-6, "VQ indices differ beyond a true tie"
        assert differ or torch.equal(used, pused), "VQ used masks differ"
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

    b = BATCH * 200
    x = torch.randn(b, c, generator=gen, device=dev)
    ms = cuda_ms(lambda: vqa.vq_assign(dictionary, x), 50)
    plain = cuda_ms(lambda: vqa.vq_assign_plain(dictionary, x), 50)
    dn = torch.sum(dictionary * dictionary, dim=-1)
    lib = cuda_ms(
        lambda: torch.argmin(torch.addmm(dn, x, dictionary.t(), alpha=-2.0), dim=1), 50
    )
    bnd, by = bound_ms(4 * (b * c + d * c + d + b + d), 2.0 * b * c * d)
    print(f"vq timing B={b} C={c} D={d}: kernel {ms:.4f} ms (plain {plain:.4f}, "
          f"addmm+argmin {lib:.4f}, bound {bnd:.4f} by {by})")
    return dict(name="vq_assign", route="cuda", source="vq_voice_swap_torch/csrc/vq_assign.cu",
                replaces="vq_voice_swap_tpu/ops/vq_pallas.py:88", launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib)


# ------------------------------------------------------------------ phase 3


def seed_weights(model: VQVAE, seed: int) -> None:
    """Seeded weights with every layer live: weights ~ N(0, 1/fan_in), the
    ResBlock output convs (zero-init in training) at 0.3 of that, norms
    near 1, small biases."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if name.endswith("dictionary"):
                p.copy_(noise)
            elif p.ndim >= 2:
                scale = 0.3 if ".conv_out." in name else 1.0
                p.copy_(noise * scale / math.sqrt(p[0].numel()))
            elif name.endswith("norm.weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)


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


def reset_counts():
    for fn in (vqa.vq_assign, gn.group_norm_stats, gn.group_norm_apply):
        fn.launches = 0


def read_counts():
    return {"vq_assign": vqa.vq_assign.launches,
            "group_norm_stats": gn.group_norm_stats.launches,
            "group_norm_apply": gn.group_norm_apply.launches}


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
        assert counts["group_norm_apply"] == GN_PER_PREDICTOR * steps
        assert counts["group_norm_stats"] == GN_PER_PREDICTOR * steps
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return ckpt, totals


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
    if name.startswith("stats_kernel"):
        return "groupnorm stats (Triton)"
    if name.startswith("apply_kernel"):
        return "groupnorm apply (Triton)"
    lowered = name.lower()
    if any(k in lowered for k in ("conv", "xmma", "gemm", "cudnn", "cutlass", "wgrad")):
        return "convolution / matmul (cuDNN, cuBLAS)"
    return "other (eager elementwise, copies, resize, concat)"


def profile_predictor(model: VQVAE, dev, name: str) -> None:
    """Device time by kernel class for one predictor call at BATCH, from
    torch.profiler, and the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(BATCH, SAMPLES, 1, generator=gen, device=dev)
        ts = torch.full((BATCH,), 0.5, device=dev)
        cond = torch.randn(BATCH, SAMPLES // 320, model.cond_channels,
                           generator=gen, device=dev)
        labels = torch.arange(BATCH, device=dev)
        model.predict_eps(x, ts, cond, labels)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.predict_eps(x, ts, cond, labels)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    by_class = {}
    for e in kernels:
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3
    print(f"profile {name} predictor call, batch {BATCH}: wall {wall_ms:.3f} ms, "
          f"device busy {total:.3f} ms ({100 * total / wall_ms:.1f}%), "
          f"{sum(e.count for e in kernels)} kernel launches")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {ms:.3f} ms ({100 * ms / max(total, 1e-9):.1f}%)")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"  top kernel {e.self_device_time_total / 1e3:.3f} ms x{e.count} "
              f"{e.key[:100]}")
    group_norm_glue(model, dev, name)


def _device_kernels(prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def group_norm_glue(model: VQVAE, dev, name: str) -> None:
    """What the torch ops around the two GroupNorm kernels (the chunk
    merge and the [N, C] affine/FiLM fold) add to one predictor call: their
    device launches and device time, counted by torch.profiler on one
    GroupNorm without and one with FiLM at the flagship's widest shape, and
    their host dispatch time, each scaled by how many of each the
    predictor runs."""
    from torch.profiler import ProfilerActivity, profile

    from vq_voice_swap_torch.models.layers import GroupNorm, ResBlock

    n_norms = sum(isinstance(m, GroupNorm) for m in model.predictor.modules())
    n_film = sum(isinstance(m, ResBlock) and m.cond_proj is not None
                 for m in model.predictor.modules())
    assert n_norms == GN_PER_PREDICTOR, n_norms
    dtype = torch.bfloat16 if name == "bfloat16" else torch.float32
    n, c, groups = BATCH, 64, 32
    x = torch.randn(n, c, SAMPLES, device=dev).to(dtype)
    w, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    film = tuple(torch.randn(n, c, device=dev).to(dtype) for _ in range(2))
    partials = torch.rand(3, n * groups, math.ceil(c // groups * SAMPLES / gn.STATS_CHUNK),
                          device=dev)
    launches = device_ms = host_ms = 0.0
    for f, count in ((None, n_norms - n_film), (film, n_film)):
        gn.group_norm(x, w, b, groups, 1e-5, True, f)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            gn.group_norm(x, w, b, groups, 1e-5, True, f)
            torch.cuda.synchronize()
        glue = [e for e in _device_kernels(prof)
                if not e.key.startswith(("stats_kernel", "apply_kernel"))]
        launches += count * sum(e.count for e in glue)
        device_ms += count * sum(e.self_device_time_total for e in glue) / 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            mean, var = gn.merge_partials(partials[0], partials[1], partials[2])
            gn.fold_affine(mean.view(n, groups), var.view(n, groups), w, b, 1e-5, f)
        host_ms += count * (time.perf_counter() - t0) * 1e3 / 100
        torch.cuda.synchronize()
    print(f"  groupnorm glue ({n_norms} GroupNorms, {n_film} with FiLM) per "
          f"predictor call: {launches:.0f} kernel launches, device {device_ms:.3f} ms, "
          f"host dispatch {host_ms:.3f} ms")


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

    t0 = time.perf_counter()
    log = cuda_build.build("vq_assign")
    if log is not None:
        print(f"built vq_assign in {time.perf_counter() - t0:.1f} s:\n{log.strip()}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = check_group_norm(dev, gen) + [check_vq(dev, gen)]
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for serving
    torch.cuda.empty_cache()

    clips = np.stack([speech_like(s, SAMPLES) for s in range(BATCH)])
    with tempfile.TemporaryDirectory() as workdir:
        ckpt, launches = main_path(dev, workdir, clips)
        for k in kernels:
            k["launches"] = launches[k["name"]]
        serving_time(dev, ckpt, clips, smi)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
