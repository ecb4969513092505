#!/usr/bin/env python3
"""Times of the PyTorch port's VQ-assign, GroupNorm-statistics and fused
ResBlock entry points in one source tree, under two timers, so that two
versions can be compared in one call on one card:

    python3 kernel_ab.py [TREE]    # TREE: the root of a checkout (default: here)

To compare a change with its parent, unpack the parent into a directory and
run parent, change, change, parent in one command. Each entry point is
printed beside one PyTorch call that computes the same work, with:

- device ms: the mean over a CUDA graph of ITERS calls, replayed, so host
  dispatch does not enter (``cuda_ms``, which chip_smoke.py uses too);
- eager ms: the mean over ITERS back-to-back calls between two CUDA events,
  what an eager caller sees: the larger of the host's dispatch time and the
  device's (``eager_ms``);
- host us: the wall time per call in Python and the launch, before the
  device is waited on.

Entry points: VQ assign at B=3200 and B=200 rows against a 512 x 1024
codebook (with each code tile the tree's kernel offers), against
``addmm`` + ``argmin``; GroupNorm statistics at [16, 64, 64000] in float32
and bfloat16, against ``var_mean``: the group (mean, var), and the
statistics folded with the affine and a FiLM into the apply kernel's
(mean, a, b) (``group_norm_coeffs``, or in a tree without it,
``fold_affine`` of ``group_norm_stats``); the fused ResBlock pair at
[16, 64, 64000], 64 -> 64 with FiLM, dilation 2, in float32 and bfloat16:
``fused_resblock_stats``, ``fused_resblock_apply`` (called through the
tree's own ``_norm_in_affine``, ``_conv_weight`` and ``_norm_mid_affine``)
and the whole ``fused_resblock``, against the port's unfused ``ResBlock``
with cuDNN's TF32 off and on (no one PyTorch call computes a ResBlock).
Exits non-zero without a card.
"""

import math
import os
import subprocess
import sys
import time

import torch

ITERS = 50
PAIR_ITERS = 10  # the pair's calls take ~1 ms and a [16, 64, 64000] output each


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
            elif name.endswith("norm.weight"):
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
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
    for b in (3200, 200):
        x = torch.randn(b, 1024, generator=gen, device=dev)
        lib = timings(lambda: torch.argmin(torch.addmm(dn, x, d.t(), alpha=-2.0), dim=1))
        print(f"{label} vq B={b} addmm+argmin: {lib}")
        for tile in tiles:
            if tile is None:
                t = timings(lambda: vqa.vq_assign(d, x))
            else:
                t = timings(lambda: vqa.vq_assign(d, x, tile))
            print(f"{label} vq B={b} vq_assign{'' if tile is None else f' {tile} codes'}: {t}")

    n, c, t, groups = 16, 64, 64000, 32
    w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    bias = 0.2 * torch.randn(c, generator=gen, device=dev)
    film = (0.5 * torch.randn(n, 2 * c, generator=gen, device=dev)).chunk(2, dim=-1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((n, c, t), generator=gen, device=dev).to(dtype)
        f = tuple(v.to(dtype) for v in film)
        name = f"{label} groupnorm [{n}, {c}, {t}] {str(dtype)[6:]}"
        lib = timings(lambda: torch.var_mean(x.view(n * groups, -1), dim=1, correction=0))
        print(f"{name} var_mean: {lib}")
        print(f"{name} group_norm_stats (mean, var): "
              f"{timings(lambda: gn.group_norm_stats(x, groups))}")
        if hasattr(gn, "group_norm_coeffs"):
            coeffs = timings(lambda: gn.group_norm_coeffs(x, groups, w, bias, 1e-5, f))
        else:
            coeffs = timings(lambda: gn.fold_affine(*gn.group_norm_stats(x, groups), w,
                                                    bias, 1e-5, f))
        print(f"{name} statistics to (mean, a, b) with FiLM: {coeffs}")
        del x
    time_fused_resblock(label, dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
