#!/usr/bin/env python3
"""Times of the PyTorch port's VQ-assign, GroupNorm-statistics and fused
ResBlock entry points in one source tree, under two timers, so that two
versions can be compared in one call on one card:

    python3 kernel_ab.py [TREE] [--only SECTION] [--reference OTHER_TREE]

TREE is the root of a checkout (default: here); SECTION one of vq,
groupnorm, backward, resblock, int8, int8call, conv, convcall (default:
all).

To compare a change with its parent, unpack the parent into a directory and
run parent, change, change, parent in one command, or pass it as
``--reference``: its package is then loaded beside this tree's under another
name and, in the groupnorm and int8 sections, timed in the same process in
turns (reference, this tree, this tree, reference). Each entry point is
printed beside one PyTorch call that computes the same work, with:

- device ms: the mean over a CUDA graph of ITERS calls, replayed, so host
  dispatch does not enter (``cuda_ms``, which chip_smoke.py uses too);
- eager ms: the mean over ITERS back-to-back calls between two CUDA events,
  what an eager caller sees: the larger of the host's dispatch time and the
  device's (``eager_ms``);
- host us: the wall time per call in Python and the launch, before the
  device is waited on.

Entry points (sections): VQ assign at B=3200 and B=200 rows against a 512 x 1024
codebook (with each code tile the tree's kernel offers), against
``addmm`` + ``argmin``; GroupNorm statistics at [16, 64, 64000] in float32
and bfloat16, against ``var_mean``: the group (mean, var), and the
statistics folded with the affine and a FiLM into the apply kernel's
(mean, a, b) (``group_norm_coeffs``, or in a tree without it,
``fold_affine`` of ``group_norm_stats``), with ``--reference`` OTHER_TREE's
beside them; the fused ResBlock pair at
[16, 64, 64000], 64 -> 64 with FiLM, dilation 2, in float32 and bfloat16:
``fused_resblock_stats``, ``fused_resblock_apply`` (called through the
tree's own ``_norm_in_affine``, ``_conv_weight`` and ``_norm_mid_affine``)
and the whole ``fused_resblock``, against the port's unfused ``ResBlock``
with cuDNN's TF32 off and on (no one PyTorch call computes a ResBlock);
the GroupNorm backward at [16, 32, 64000] in float32 and bfloat16, without
and with FiLM + GELU: the kernel alone from given group (mean, var)
(``_launch_bwd``), the wrapper as the guided paths call it (with the
forward's statistics where the tree saves them; else, as the older tree
did, after a statistics launch) and the wrapper alone (statistics
included), against ``native_group_norm_backward`` (dx; no FiLM, no GELU),
and in a tree with ``bwd_route`` the cluster route at each cluster size
that fits. The int8 serving path: the int8 GroupNorm statistics
(``group_norm_coeffs_int8``) at [16, 64, 64000] with a per-tensor scale and
at [16, 128, 64000] with a per-channel one (two halves 9x apart), with
``--reference`` OTHER_TREE's kernel in turns beside it and the largest
relative difference |mine - theirs| / |theirs| between the two trees'
(mean, a, b); one whole unet64 predictor call (seeded weights, batch 16 x
64000, bf16 and f32) with int8 activations at T >= 16000 beside the float
call (int8call; with ``--reference`` OTHER_TREE's model on the same
weights in turns); at [16, 64, 64000], ``conv1d_int8`` 64 ->
64, 3 taps, dilation 2, f32 and bf16 out, and each quantize site in f32
and bf16 (the GroupNorm apply on int8 codes, on a float input with FiLM,
the residual add with an int8 and a float skip), by the tree's unfused
route (its apply or the eager add, then its ``quantize``) and, where the
tree has them, its fused entry points (``quantize_group_norm``,
``quantize_residual``); with ``--reference``, OTHER_TREE's package is
loaded beside it under another name, its unfused route timed too and its
codes and scales held against the tree's fused ones on the same inputs
(the share of codes that differ). The bf16 serving convolution (conv): at
every shape of one swap predictor call (unet64, 1024-channel codes, 251
labels, batch 64 x 64000; the shapes read off the call by hooks, each with
its count a call), the hand-written kernel (``ops/conv1d.py``, launched
whether or not the route's rule takes the shape) against the call the
route replaces, ``F.conv1d`` of the bf16-cast weight and bias (cuDNN, its
layout transposes and aten's bias add), and the funnel
``models/layers.py`` ``conv1d`` as the model calls it, with the rule's
choice; convcall: one whole bf16 swap predictor call at batch 64, with
``--reference`` OTHER_TREE's model on the same weights in turns. Exits
non-zero without a card.
"""

import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ITERS = 50
PAIR_ITERS = 10  # the pair's calls take ~1 ms and a [16, 64, 64000] output each
BWD_ITERS = 20   # each backward call writes a [16, 32, 64000] dx
SECTIONS = ("vq", "groupnorm", "backward", "resblock", "int8", "int8call", "conv", "convcall")
CONV_ITERS = 10  # a call at the top level reads and writes ~1 GB


def cuda_ms(fn, iters: int = ITERS) -> float:
    """Mean device time of fn over iters warm calls: the calls are captured
    in one CUDA graph and its replay is timed with CUDA events, so the
    host's dispatch time (Python wrappers, eager ops) does not enter."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm on the capturing stream: compiles, per-stream scratch
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def eager_ms(fn, iters: int = ITERS):
    """(ms per call, host us per call) of iters back-to-back eager calls
    after a warm one: CUDA events around the calls, and the host's wall
    time until the last call returned."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_us


def timings(fn, iters: int = ITERS) -> str:
    ms, host_us = eager_ms(fn, iters)
    return f"device {cuda_ms(fn, iters):.4f} ms, eager {ms:.4f} ms, host {host_us:.1f} us"


def seed_weights(model: torch.nn.Module, seed: int) -> None:
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
            elif "norm" in name and name.endswith("weight"):  # GroupNorm, LayerNorm
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)


def time_fused_resblock(label: str, dev, gen) -> None:
    """The pair's entry points and the unfused block, per dtype."""
    from vq_voice_swap_torch.models.layers import ResBlock
    from vq_voice_swap_torch.ops import fused_resblock as frb
    from vq_voice_swap_torch.ops import group_norm as gn

    n, c, t, emb_ch = 16, 64, 64000, 256
    block = ResBlock(c, c, emb_ch, dilation=2)
    seed_weights(block, 99)  # the block chip_smoke.py times
    block = block.to(dev).eval()
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(n, c, t, generator=gen, device=dev).to(dtype)
        emb = torch.randn(n, emb_ch, generator=gen, device=dev).to(dtype)
        xs = (x,)
        name = f"{label} fused resblock [{n}, {c}, {t}] 64->64 FiLM d2 {str(dtype)[6:]}"
        with torch.no_grad():
            norm1 = frb._norm_in_affine(block, xs, gn.group_norm_coeffs)
            conv_in = frb._conv_weight(block.conv_in, dtype)
            conv_out = frb._conv_weight(block.conv_out, dtype)
            part = frb.fused_resblock_stats(xs, norm1, conv_in)
            norm2 = frb._norm_mid_affine(block, part, emb)
            print(f"{name} fused_resblock_stats: "
                  f"{timings(lambda: frb.fused_resblock_stats(xs, norm1, conv_in), PAIR_ITERS)}")
            print(f"{name} fused_resblock_apply: " + timings(
                lambda: frb.fused_resblock_apply(xs, norm1, conv_in, norm2, conv_out,
                                                 (None, None), 2), PAIR_ITERS))
            print(f"{name} fused_resblock (whole block): "
                  f"{timings(lambda: frb.fused_resblock(block, x, emb), PAIR_ITERS)}")
            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = tf32
                print(f"{name} unfused ResBlock, cuDNN TF32 {'on' if tf32 else 'off'}: "
                      f"{timings(lambda: block(x, emb), PAIR_ITERS)}")
            torch.backends.cudnn.allow_tf32 = False
        del x, part
        torch.cuda.empty_cache()


def time_group_norm_backward(label: str, gn, dev, gen) -> None:
    """The GroupNorm backward's kernel and wrappers, per dtype and flags."""
    n, c, t, groups = 16, 32, 64000, 32
    w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    b = 0.2 * torch.randn(c, generator=gen, device=dev)
    proj = 0.5 * torch.randn(n, 2 * c, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((n, c, t), generator=gen, device=dev).to(dtype)
        dy = torch.randn((n, c, t), generator=gen, device=dev).to(dtype)
        film = tuple(proj.to(dtype).chunk(2, dim=-1))
        mean, var = gn.group_norm_stats(x, groups)
        name = f"{label} groupnorm backward [{n}, {c}, {t}] {str(dtype)[6:]}"
        wl, bl = w.to(dtype), b.to(dtype)
        _, mu, rstd = torch.ops.aten.native_group_norm(x, wl, bl, n, c, t, groups, 1e-5)
        lib = timings(lambda: torch.ops.aten.native_group_norm_backward(
            dy, x, mu, rstd, wl, n, c, t, groups, [True, False, False]), BWD_ITERS)
        print(f"{name} native_group_norm_backward (dx): {lib}")
        saves = hasattr(gn, "bwd_route")
        for flags, f, g in (("no FiLM/GELU", None, False), ("FiLM + GELU", film, True)):
            kernel = timings(lambda: gn._launch_bwd(x, dy, groups, mean, var, w, b, 1e-5, g, f),
                             BWD_ITERS)
            alone = timings(lambda: gn.group_norm_backward(x, dy, groups, w, b, 1e-5, g, f),
                            BWD_ITERS)
            print(f"{name} {flags} kernel alone: {kernel}")
            print(f"{name} {flags} wrapper with its statistics launch: {alone}")
            if not saves:
                continue
            route = gn.bwd_route(x, groups)
            print(f"{name} {flags} wrapper from the forward's statistics ({route}): "
                  + timings(lambda: gn.group_norm_backward(x, dy, groups, w, b, 1e-5, g, f,
                                                           (mean, var)), BWD_ITERS))
            span = t * c // groups
            for k in (4, 8, 16):
                per_block = -(-span // k)
                chunk = -(-per_block // 8) * 8
                r = gn.BwdRoute("cluster", k, chunk)
                print(f"{name} {flags} cluster of {k} ({chunk} elements a block): " + timings(
                    lambda: gn._launch_bwd(x, dy, groups, mean, var, w, b, 1e-5, g, f, r),
                    BWD_ITERS))
        del x, dy
        torch.cuda.empty_cache()


def load_tree_as(tree: str, alias: str):
    """OTHER_TREE's package imported under ``alias`` (its modules import
    each other relatively), its kernels built in its own tree."""
    import importlib
    import importlib.util

    pkg = os.path.join(tree, "vq_voice_swap_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    importlib.import_module(alias + ".ops.cuda_build").build_all()
    return (importlib.import_module(alias + ".ops.qact"),
            importlib.import_module(alias + ".ops.group_norm"),
            importlib.import_module(alias + ".diffusion_model").DiffusionModel)


def int8_routes(qact, gn, dtype, dev, seed: int):
    """{site: (unfused call, fused call or None)} at [16, 64, 64000] on
    inputs made from ``seed``; coefficients from the plain statistics, so
    two trees see the same bits."""
    n, c, t = 16, 64, 64000
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 3.0 * torch.randn(n, c, t, generator=gen, device=dev) + 0.5
    scale = torch.clamp(x.abs().amax(), min=1e-12) / 127.0
    q = torch.round(x / scale).clamp_(-127, 127).to(torch.int8)
    codes = qact.QAct(q, scale, dtype)
    h = (torch.randn(n, c, t, generator=gen, device=dev) + 0.3).to(dtype)
    skip = (2.0 * torch.randn(n, c, t, generator=gen, device=dev)).to(dtype)
    w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    b = 0.2 * torch.randn(c, generator=gen, device=dev)
    film = tuple((0.5 * torch.randn(n, c, generator=gen, device=dev)).to(dtype) for _ in "ab")
    ci = gn.group_norm_coeffs_plain(q.float() * scale, 32, w, b, 1e-5)
    cf = gn.group_norm_coeffs_plain(h, 32, w, b, 1e-5, film)
    fused_gn = getattr(qact, "quantize_group_norm", None)
    fused_res = getattr(qact, "quantize_residual", None)
    return {
        "norm_in, int8 input": (
            lambda: qact.quantize(gn.group_norm_apply_int8(q, scale, *ci, True, dtype)),
            fused_gn and (lambda: fused_gn(codes, *ci, True))),
        "norm_mid, FiLM": (
            lambda: qact.quantize(gn.group_norm_apply(h, *cf, True)),
            fused_gn and (lambda: fused_gn(h, *cf, True))),
        "residual, int8 skip": (
            lambda: qact.quantize(qact.dequantize(codes, dtype) + h),
            fused_res and (lambda: fused_res(codes, h))),
        "residual, float skip": (
            lambda: qact.quantize(skip + h), fused_res and (lambda: fused_res(skip, h))),
        "no prologue": (lambda: qact.quantize(h), None),
    }


def int8_stats_inputs(dev, c: int, per_channel: bool, seed: int):
    """Codes [16, c, 64000], their scale (per-tensor, or per-channel: two
    halves 9x apart) and an affine, made in plain arithmetic from ``seed``
    so that two trees see the same bits."""
    n, t = 16, 64000
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, c, t, generator=gen, device=dev) + 0.5
    parts = (x[:, :c // 2], 9.0 * x[:, c // 2:]) if per_channel else (x,)
    codes, scales = [], []
    for part in parts:
        scale = torch.clamp(part.abs().amax(), min=1e-12) / 127.0
        codes.append(torch.round(part / scale).clamp_(-127, 127).to(torch.int8))
        scales.append(scale.expand(part.shape[1]))
    q = torch.cat(codes, dim=1).contiguous()
    scale = torch.cat(scales).contiguous() if per_channel else scales[0][0].clone()
    w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    b = 0.2 * torch.randn(c, generator=gen, device=dev)
    return q, scale, w, b


def time_int8_stats(label: str, gn, dev, reference) -> None:
    """The int8 GroupNorm statistics in both scale modes, with the
    reference tree's in turns and the two trees' largest relative gap."""
    trees = [(label, gn)]
    if reference is not None:
        ref = ("the reference tree", reference[1])
        trees = [ref, trees[0], trees[0], ref]
    for c, per_channel in ((64, False), (128, True)):
        q, scale, w, b = int8_stats_inputs(dev, c, per_channel, 17)
        name = (f"int8 groupnorm statistics [16, {c}, 64000] "
                f"{'per-channel' if per_channel else 'per-tensor'} scale")
        for tree, g in trees:
            print(f"{tree} {name}: "
                  f"{timings(lambda: g.group_norm_coeffs_int8(q, scale, 32, w, b, 1e-5))}")
        if reference is not None:
            mine = gn.group_norm_coeffs_int8(q, scale, 32, w, b, 1e-5)
            theirs = reference[1].group_norm_coeffs_int8(q, scale, 32, w, b, 1e-5)
            gap = max(((k - p).abs() / p.abs()).max().item() for k, p in zip(mine, theirs))
            print(f"{label} {name}: largest |this tree - reference| / |reference| of "
                  f"(mean, a, b) {gap:.3g}")
        del q
        torch.cuda.empty_cache()


def time_int8(label: str, dev, gen, reference) -> None:
    from vq_voice_swap_torch.ops import group_norm as gn
    from vq_voice_swap_torch.ops import qact

    time_int8_stats(label, gn, dev, reference)
    n, c, t = 16, 64, 64000
    x = torch.randn(n, c, t, generator=gen, device=dev)
    qa = qact.quantize(x)
    conv = torch.nn.Conv1d(c, c, 3, padding=2, dilation=2).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        q8 = qact.QAct(qa.q, qa.scale, dtype)
        print(f"{label} int8 conv [{n}, {c}, {t}] 64->64 d2, {str(dtype)[6:]} out: "
              f"{timings(lambda: qact.conv1d_int8(q8, conv.weight, conv.bias, dilation=2, conv=conv), 20)}")
    del x, qa
    for dtype in (torch.float32, torch.bfloat16):
        mine = int8_routes(qact, gn, dtype, dev, 16)
        theirs = int8_routes(*reference[:2], dtype, dev, 16) if reference else {}
        for site, (unfused, fused) in mine.items():
            name = f"{label} quantize {site} [{n}, {c}, {t}] {str(dtype)[6:]}"
            print(f"{name} unfused: {timings(unfused, 20)}")
            if fused is not None:
                print(f"{name} fused: {timings(fused, 20)}")
            if site in theirs:
                old = theirs[site][0]
                print(f"{name} the reference tree's unfused route: {timings(old, 20)}")
                got, want = (fused or unfused)(), old()
                torch.cuda.synchronize()
                gap = (got.q != want.q).float().mean().item()
                print(f"{name}: {'fused' if fused else 'unfused'} against the reference "
                      f"tree's unfused route: scale bits equal "
                      f"{torch.equal(got.scale, want.scale)} ({got.scale.item():.9g} / "
                      f"{want.scale.item():.9g}), codes that differ {gap:.6g}")
                del got, want
        del mine, theirs
        torch.cuda.empty_cache()


def time_int8_call(label: str, dev, reference) -> None:
    """One unet64 predictor call, batch 16 x 64000, on seeded weights, in
    bf16 and f32: with int8 activations at T >= 16000 (the sampling CLIs'
    --act-int8 16000) and float; with a reference tree, its model on the
    same weights in turns (reference, this tree, this tree, reference)."""
    from vq_voice_swap_torch.diffusion_model import DiffusionModel

    trees = [(label, DiffusionModel)]
    if reference is not None:
        ref = ("the reference tree", reference[2])
        trees = [ref, trees[0], trees[0], ref]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(16, 64000, 1, generator=gen, device=dev)
    ts = torch.full((16,), 0.5, device=dev)
    for dtype in ("bfloat16", None):
        for tree, cls in trees:
            for min_t in (16000, 0):
                model = cls("unet", 64, dtype=dtype, act_int8_min_t=min_t)
                seed_weights(model, 5)
                model = model.to(dev).eval()
                kind = f"int8 at T >= {min_t}" if min_t else "float"
                with torch.no_grad():
                    print(f"{tree} unet64 predictor call [16, 64000] {dtype or 'float32'}, "
                          f"{kind}: {timings(lambda: model.predict_eps(x, ts), 3)}")
                del model
                torch.cuda.empty_cache()


def swap_predictor(cls, dev):
    """The swap cell's predictor (unet64, 1024-channel codes, 251 labels) in
    bf16 on seeded weights, from a tree's ``DiffusionModel``."""
    model = cls("unet", 64, num_labels=251, cond_channels=1024, dtype="bfloat16")
    seed_weights(model, 5)
    return model.to(dev).eval()


def predictor_inputs(dev, n: int):
    gen = torch.Generator(device=dev).manual_seed(3)
    return (torch.randn(n, 64000, 1, generator=gen, device=dev),
            torch.full((n,), 0.5, device=dev),
            torch.randn(n, 200, 1024, generator=gen, device=dev),
            torch.arange(n, device=dev) % 251)


@torch.no_grad()  # the serving forward, the route's domain
def time_conv(label: str, dev) -> None:
    """Each convolution shape of one swap predictor call at batch 64: the
    kernel, the call it replaces and the funnel, device and eager."""
    from vq_voice_swap_torch.diffusion_model import DiffusionModel
    from vq_voice_swap_torch.models import layers
    from vq_voice_swap_torch.ops import conv1d as c1

    model = swap_predictor(DiffusionModel, dev)
    shapes = {}

    def hook(m, args):
        cout, cin, taps = m.conv.weight.shape
        key = (cin, cout, taps, m.conv.dilation[0], args[0].shape[2])
        shapes.setdefault(key, [m.conv, 0])[1] += 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, layers.Conv1d)]
    with torch.no_grad():
        model.predict_eps(*predictor_inputs(dev, 1))
    for h in handles:
        h.remove()
    n = 64
    gen = torch.Generator(device=dev).manual_seed(4)
    totals = {"kernel": 0.0, "cudnn": 0.0, "routed cudnn": 0.0, "routed kernel": 0.0}
    print(f"{label} conv: {sum(c for _, c in shapes.values())} convolutions a predictor call, "
          f"{len(shapes)} shapes, timed at batch {n}")
    for (cin, cout, taps, dil, t), (conv, count) in sorted(shapes.items(),
                                                           key=lambda kv: -kv[0][4]):
        x = torch.randn(n, cin, t, generator=gen, device=dev).to(torch.bfloat16)
        pad = conv.padding[0]
        takes = c1.routes("cuda", torch.bfloat16, False, x.shape, True, conv)
        name = (f"{label} conv [{n}, {cin}, {t}] {cin}->{cout} k{taps} d{dil} x{count} "
                f"(route: {'kernel' if takes else 'cuDNN'})")

        def cudnn():
            return F.conv1d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=pad,
                            dilation=dil)

        lib_ms = cuda_ms(cudnn, CONV_ITERS)
        lib_eager, lib_host = eager_ms(cudnn, CONV_ITERS)
        print(f"{name} F.conv1d + bias (today's call): device {lib_ms:.4f} ms, "
              f"eager {lib_eager:.4f} ms, host {lib_host:.1f} us")
        totals["cudnn"] += count * lib_ms
        if t % c1.T_ALIGN or taps not in (1, 3) or (taps - 1) * dil > c1.MAX_REACH:
            totals["kernel"] += count * lib_ms
            totals["routed cudnn"] += count * lib_ms
            print(f"{name} kernel: does not take the shape")
            continue
        layout, b32 = c1._prepare(conv.weight, conv.bias)
        out = torch.empty((n, cout, t), dtype=torch.bfloat16, device=dev)

        def kernel():
            assert c1._launch(x, layout, b32, out, dil, dev.index or 0) == 0

        k_ms = cuda_ms(kernel, CONV_ITERS)
        funnel_eager, funnel_host = eager_ms(lambda: layers.conv1d(x, conv), CONV_ITERS)
        print(f"{name} kernel: device {k_ms:.4f} ms ({lib_ms / k_ms:.2f}x); funnel eager "
              f"{funnel_eager:.4f} ms, host {funnel_host:.1f} us")
        totals["kernel"] += count * min(k_ms, lib_ms)
        totals["routed kernel" if takes else "routed cudnn"] += count * (k_ms if takes else lib_ms)
        del x, out
        torch.cuda.empty_cache()
    # The host's cost of a call, where the device's is small: the funnel
    # (routing, the kept weight, the launch) against today's call.
    conv = torch.nn.Conv1d(64, 64, 3, dilation=2, padding=2).to(dev)
    x = torch.randn(1, 64, 8000, generator=gen, device=dev).to(torch.bfloat16)

    def cudnn_funnel():
        routes = layers.routes
        layers.routes = lambda *args: False
        try:
            return layers.conv1d(x, conv)
        finally:
            layers.routes = routes
    for what, fn in (("F.conv1d + bias (today's call)",
                      lambda: F.conv1d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                                       padding=2, dilation=2)),
                     ("funnel, the cuDNN route (as before the kernel)", cudnn_funnel),
                     ("funnel, the kernel route", lambda: layers.conv1d(x, conv)),
                     ("the kernel's wrapper", lambda: c1.conv1d_bf16(x, conv.weight, conv.bias,
                                                                     2, conv))):
        ms, host_us = eager_ms(fn, 500)
        print(f"{label} conv host cost [1, 64, 8000] 64->64 k3 d2, {what}: {host_us:.2f} us a "
              f"call (eager {ms * 1e3:.1f} us)")
    print(f"{label} conv a predictor call at batch {n}: cuDNN + bias {totals['cudnn']:.3f} ms; "
          f"the route {totals['routed kernel'] + totals['routed cudnn']:.3f} ms (kernel "
          f"{totals['routed kernel']:.3f}, cuDNN {totals['routed cudnn']:.3f}); the faster of "
          f"the two at each shape {totals['kernel']:.3f} ms")


def time_conv_call(label: str, dev, reference) -> None:
    """One whole bf16 swap predictor call at batch 64; with a reference
    tree, its model on the same weights in turns."""
    from vq_voice_swap_torch.diffusion_model import DiffusionModel

    trees = [(label, DiffusionModel)]
    if reference is not None:
        ref = ("the reference tree", reference[2])
        trees = [ref, trees[0], trees[0], ref]
    inputs = predictor_inputs(dev, 64)
    for tree, cls in trees:
        model = swap_predictor(cls, dev)
        with torch.no_grad():
            print(f"{tree} swap predictor call [64, 64000] bf16: "
                  f"{timings(lambda: model.predict_eps(*inputs), 3)}")
        del model
        torch.cuda.empty_cache()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    only = SECTIONS
    if "--only" in argv:
        i = argv.index("--only")
        only = tuple(argv[i + 1].split(","))
        argv = argv[:i] + argv[i + 2:]
    reference = None
    if "--reference" in argv:
        i = argv.index("--reference")
        reference = os.path.abspath(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    tree = os.path.abspath(argv[0] if argv else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, tree)
    from vq_voice_swap_torch.ops import cuda_build
    from vq_voice_swap_torch.ops import group_norm as gn
    from vq_voice_swap_torch.ops import vq_assign as vqa

    assert gn.__file__.startswith(tree + os.sep), (gn.__file__, tree)
    cuda_build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    label = os.path.basename(tree)
    print(f"kernel_ab {label} ({tree}) on {smi}, {ITERS} calls per timing")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    d = torch.randn(512, 1024, generator=gen, device=dev)
    dn = torch.sum(d * d, dim=-1)
    tiles = getattr(vqa, "BLOCK_CODES", None)
    tiles = [None, *tiles] if isinstance(tiles, tuple) else [None]
    for b in (3200, 200) if "vq" in only else ():
        x = torch.randn(b, 1024, generator=gen, device=dev)
        lib = timings(lambda: torch.argmin(torch.addmm(dn, x, d.t(), alpha=-2.0), dim=1))
        print(f"{label} vq B={b} addmm+argmin: {lib}")
        for tile in tiles:
            if tile is None:
                t = timings(lambda: vqa.vq_assign(d, x))
            else:
                t = timings(lambda: vqa.vq_assign(d, x, tile))
            print(f"{label} vq B={b} vq_assign{'' if tile is None else f' {tile} codes'}: {t}")

    ref = load_tree_as(reference, "reference_port") if reference else None
    if ref is not None:
        print(f"{label}: reference tree {reference}")
    n, c, t, groups = 16, 64, 64000, 32
    w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    bias = 0.2 * torch.randn(c, generator=gen, device=dev)
    film = (0.5 * torch.randn(n, 2 * c, generator=gen, device=dev)).chunk(2, dim=-1)
    for dtype in (torch.float32, torch.bfloat16) if "groupnorm" in only else ():
        x = torch.randn((n, c, t), generator=gen, device=dev).to(dtype)
        f = tuple(v.to(dtype) for v in film)
        name = f"{label} groupnorm [{n}, {c}, {t}] {str(dtype)[6:]}"
        lib = timings(lambda: torch.var_mean(x.view(n * groups, -1), dim=1, correction=0))
        print(f"{name} var_mean: {lib}")
        trees = [("", gn)]
        if ref is not None:  # in turns: reference, this tree, this tree, reference
            trees = [(" (the reference tree)", ref[1]), ("", gn), ("", gn),
                     (" (the reference tree)", ref[1])]
        for tree, g in trees:
            print(f"{name}{tree} group_norm_stats (mean, var): "
                  f"{timings(lambda: g.group_norm_stats(x, groups))}")
            if hasattr(g, "group_norm_coeffs"):
                coeffs = timings(lambda: g.group_norm_coeffs(x, groups, w, bias, 1e-5, f))
            else:
                coeffs = timings(lambda: g.fold_affine(*g.group_norm_stats(x, groups), w,
                                                       bias, 1e-5, f))
            print(f"{name}{tree} statistics to (mean, a, b) with FiLM: {coeffs}")
        del x
    if "backward" in only:
        time_group_norm_backward(label, gn, dev, gen)
    if "resblock" in only:
        time_fused_resblock(label, dev, gen)
    if "int8" in only:
        time_int8(label, dev, gen, ref)
    if "int8call" in only:
        time_int8_call(label, dev, ref)
    if "conv" in only:
        time_conv(label, dev)
    if "convcall" in only:
        time_conv_call(label, dev, ref)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
