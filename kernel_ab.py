#!/usr/bin/env python3
"""Times of the PyTorch port's VQ-assign and GroupNorm-statistics entry
points in one source tree, under two timers, so that two versions can be
compared in one call on one card:

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
``fold_affine`` of ``group_norm_stats``). Exits non-zero without a card.
"""

import os
import subprocess
import sys
import time

import torch

ITERS = 50


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


def timings(fn) -> str:
    ms, host_us = eager_ms(fn)
    return f"device {cuda_ms(fn):.4f} ms, eager {ms:.4f} ms, host {host_us:.1f} us"


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(argv[0] if argv else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, tree)
    from vq_voice_swap_torch.ops import group_norm as gn
    from vq_voice_swap_torch.ops import vq_assign as vqa

    assert gn.__file__.startswith(tree + os.sep), (gn.__file__, tree)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    label = os.path.basename(tree)
    print(f"kernel_ab {label} ({tree}) on {smi}, {ITERS} calls per timing")
    torch.backends.cuda.matmul.allow_tf32 = False
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
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
