"""Training the VQ-VAE on a LibriSpeech-style directory: the program's own
loop (``VQVAETrainLoop``) with ``--steps-per-dispatch K``, fed by its
own loader (index, window cache, C gather, loader threads) from a
directory of seeded speech-like WAVs that set-up writes under TMPDIR.
The driver makes the calls that ``TrainLoop._loop_windows`` makes (K
batches from the loader through ``prepare_batch``, then ``_window``), so
that it can stop at the deadline and time the loader.

Set-up: the loop, its model overwritten in place with the seeded weights
(its EMAs too), the first 1 + K steps through ``_window`` (one window of
one step, which captures the step's CUDA graph, then one window of K, as
the timed windows run) and the program's readings of them.

End to end: ``samples_per_s``, the training windows consumed over the
wall seconds from the window's start to the last window's completion.

Correct: the plain float32 reference (``reference/model.py``, its own
AdamW) follows the first 1 + K steps from the same weights, batches and
draws:

- ``loss_err``: the relative L2 distance of the loss's parts, every row's
  diffusion MSE and each step's VQ loss over the 1 + K steps, from the
  reference's;
- ``grad_err``: the distance of each leaf of the first gradient (the
  program's worked out from AdamW's first moment after one step) from the
  reference's, in units of the same reference's gradient computed in
  bfloat16, the median over the leaves: the seeded model amplifies
  rounding by a factor that changes from seed to seed, and the ratio
  holds it out; the median, since a code that flips at a near tie moves
  a few leaves (the codebook's, the encoder's last) far more than
  rounding does;
- ``update_gap``: of the norm of the parameters' change after the 1 + K
  steps, by the worst leaf: the gap of the leaf's norms over the larger of
  the reference's leaf norm and its median leaf's, leaves whose reference
  gradient in the first step is under a thousandth of the median leaf's
  left out (they move under Adam by round-off alone);
- ``data_rows_bad``: the rows of those steps, and of the first timed
  window's, that are not a window of the audio of the speaker their label
  names.

Read and reported, not compared (no reading tells a sound run from its
control, ``PERF.md``): ``grad_gap``, the first gradient's norm by the
worst leaf; ``grad_err_whole``, ``grad_err`` of every leaf as one vector;
``usage_gap``, the share of codes whose usage count differs after the
1 + K steps."""

import math
import os
import shutil
import tempfile
import time
import wave
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

import counts
from harness import (SAMPLE_RATE, Context, Outcome, Window, full_float32, load_weights,
                     seeded_state, speech_batch, traced)
from reference.model import VQVAE as Reference
from reference.model import fp8_everywhere, loss_parts

BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
FIRST = 0  # the loop's first step number


def write_data(ctx: Context, root: str) -> Dict[int, List[np.ndarray]]:
    """<1000+s>/0/<1000+s>-0-<u>.wav for every speaker s and utterance u,
    seeded speech-like 16-bit audio; returns the PCM by speaker."""
    tr = ctx.cell.traffic
    spk, per = tr["speakers"], tr["utterances"]
    t = int(tr["utterance_seconds"] * SAMPLE_RATE)
    audio = speech_batch(spk * per, t, ctx.device, ctx.seed, "data")[..., 0]
    pcm = (audio.clamp(-1, 1) * (2**15 - 1)).to(torch.int16).cpu().numpy()
    files: Dict[int, List[np.ndarray]] = {}
    for s in range(spk):
        d = os.path.join(root, str(1000 + s), "0")
        os.makedirs(d, exist_ok=True)
        for u in range(per):
            clip = pcm[s * per + u]
            with wave.open(os.path.join(d, f"{1000 + s}-0-{u:04d}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SAMPLE_RATE)
                w.writeframes(clip.astype("<i2").tobytes())
            files.setdefault(s, []).append(clip)
    return files


def rows_not_found(files: Dict[int, List[np.ndarray]], batch: Dict[str, np.ndarray]) -> int:
    """Rows of a host batch that are not a window (16-bit PCM over 2^15)
    of a file of the speaker their label names."""
    bad = 0
    for row, label in zip(batch["samples"], batch["label"]):
        pcm = np.round(row * 2**15).astype(np.int64)
        found = False
        for clip in files.get(int(label), []):
            c = clip.astype(np.int64)
            for off in np.flatnonzero(c[:len(c) - len(pcm) + 1] == pcm[0]):
                if np.array_equal(c[off:off + len(pcm)], pcm):
                    found = True
                    break
            if found:
                break
        bad += not found
    return bad


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: the loop draws every step's
    random tensors from a generator seeded by (run seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]) >> 1


def loop_argv(ctx: Context, data_dir: str, out_dir: str) -> List[str]:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    m, opt = cfg["model"], cfg["train"]
    argv = [data_dir, "--predictor", m["pred_name"], "--base-channels", str(m["base_channels"]),
            "--encoder", m["enc_name"], "--cond-mult", str(m["cond_mult"]),
            "--dictionary-size", str(m["dictionary_size"]), "--dead-rate", str(m["dead_rate"]),
            "--schedule", m["schedule_name"], "--class-cond",
            "--lr", str(opt["lr"]), "--weight-decay", str(opt["weight_decay"]),
            "--ema-rate", opt["ema_rate"], "--commitment-coeff", str(opt["commitment_coeff"]),
            "--batch-size", str(tr["batch"]), "--steps-per-dispatch", str(tr["steps_per_dispatch"]),
            "--save-interval", str(10**9), "--output-dir", out_dir,
            "--seed", str(loop_seed(ctx)), "--device", str(ctx.device)]
    if cfg.get("dtype") == "bfloat16":
        argv.append("--bf16")
    return argv


def loop_seed(ctx: Context) -> int:
    return ctx.seed % 2**31


class Feed:
    """The loop's batches, as ``_loop_windows`` takes them."""

    def __init__(self, loop):
        from vq_voice_swap_torch.train.loops import repeat_dataset

        self.loop = loop
        self.it = iter(repeat_dataset(loop.data_loader))
        self.wait_s = 0.0

    def take(self, k: int, base: int) -> List[Dict[str, np.ndarray]]:
        t0 = time.perf_counter()
        out = []
        for j in range(k):
            self.loop.total_steps = base + j + self.loop.logger.start_step
            out.append(self.loop.prepare_batch(next(self.it)))
        self.wait_s += time.perf_counter() - t0
        return out

    def run(self, k: int, base: int) -> Tuple[List[Dict[str, np.ndarray]], List[Dict[str, Any]]]:
        """Steps base .. base+k-1 through the loop's window; their host
        batches and metrics."""
        batches = self.take(k, base)
        self.loop.loop_steps = base
        self.loop._window(batches, base)
        return batches, self.loop._pending[-1][1]

    def close(self) -> None:
        self.it.close()


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: v.float().norm().item() for k, v in tensors.items()}


def program_readings(loop, feed: Feed, state: Dict[str, torch.Tensor], k: int
                     ) -> Dict[str, Any]:
    """Step 1 through a window of one, then steps 2 .. k+1 through a window
    of k, as the timed windows run, and what they read."""
    params = dict(loop.model.named_parameters())
    b1, m1 = feed.run(1, FIRST)
    adam = loop.optimizer.adamw.state
    grads = {n: (adam[p]["exp_avg"] / (1.0 - BETAS[0])).cpu()
             for n, p in params.items() if p in adam}
    g1 = leaf_norms(grads)
    bk, mk = feed.run(k, FIRST + 1)
    with torch.no_grad():
        change = leaf_norms({n: p - state[n] for n, p in params.items()})
    parts = [torch.cat([m["mses"].float(), m["extra"]["vq_loss"].float().reshape(1)])
             for m in m1 + mk]
    return {"batches": b1 + bk, "parts": torch.cat(parts).cpu(), "g1": g1, "grads": grads,
            "change": change, "usage": loop.model.vq.usage_count.detach().cpu().clone()}


def reference_readings(ctx: Context, state, batches, fp8: bool = False,
                       dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """The reference's steps on ``batches`` from the same weights and draws;
    ``fp8`` rounds every stored activation and weight through float8 (the
    control); ``dtype`` computes in that type (and then only the first
    step's gradient is wanted)."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev, opt = ctx.device, cfg["train"]
    ref = Reference(**cfg["model"]).to(dev)
    load_weights(ref, state)
    ref.to(dtype)
    if fp8:
        fp8_everywhere(ref)
    params = dict(ref.named_parameters())
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    usage = ref.vq.usage_count.clone()
    parts, grads = [], None
    block = tr["reference_rows"]
    with full_float32():
        for step, batch in enumerate(batches):
            x = torch.from_numpy(batch["samples"]).to(dev)[..., None]
            labels = torch.from_numpy(batch["label"]).long().to(dev)
            n = x.shape[0]
            g = torch.Generator(device=dev).manual_seed(step_seed(loop_seed(ctx), FIRST + step))
            ts = torch.rand((n,), generator=g, device=dev)
            eps = torch.randn(x.shape, generator=g, device=dev)
            for p in params.values():
                p.grad = None
            mses, vq, used = [], 0.0, torch.zeros_like(usage, dtype=torch.bool)
            for i in range(0, n, block):
                w = min(block, n - i) / n
                total, rows, vq_loss, idxs = loss_parts(
                    ref, x[i:i + block], labels[i:i + block], ts[i:i + block],
                    eps[i:i + block], opt["commitment_coeff"])
                (total * w).backward()
                mses.append(rows)
                vq = vq + vq_loss * w
                used[idxs] = True
            parts.append(torch.cat(mses + [vq.reshape(1)]))
            if step == 0:
                grads = {k: p.grad.float().cpu() for k, p in params.items()}
                if dtype != torch.float32:
                    return {"grads": grads}
            t = step + 1
            with torch.no_grad():
                for k, p in params.items():
                    gr = p.grad
                    m[k].mul_(BETAS[0]).add_(gr, alpha=1 - BETAS[0])
                    v[k].mul_(BETAS[1]).addcmul_(gr, gr, value=1 - BETAS[1])
                    p.mul_(1 - opt["lr"] * opt["weight_decay"])
                    denom = (v[k] / (1 - BETAS[1] ** t)).sqrt() + ADAM_EPS
                    p.addcdiv_(m[k], denom, value=-opt["lr"] / (1 - BETAS[0] ** t))
                usage = torch.where(used, torch.full_like(usage, cfg["model"]["dead_rate"]),
                                    (usage - 1).clamp(0, cfg["model"]["dead_rate"]))
    with torch.no_grad():
        change = leaf_norms({k: p - state[k] for k, p in params.items()})
    return {"parts": torch.cat(parts).cpu(), "g1": leaf_norms(grads), "grads": grads,
            "change": change, "usage": usage.cpu()}


def leaf_gap(got: Dict[str, float], want: Dict[str, float], keep: List[str]) -> float:
    """The worst leaf's gap of norms over the larger of its reference norm
    and the median leaf's."""
    med = float(np.median([want[k] for k in keep]))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keep)


def grad_err(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             rounded: Dict[str, torch.Tensor], keep: List[str]) -> Tuple[float, float]:
    """The distance of the first gradient from the reference's, in units
    of the same reference's gradient computed in bfloat16: the median over
    the kept leaves of each leaf's ratio, and the ratio of the whole."""
    if set(got) != set(want):
        return math.inf, math.inf
    num = {k: (got[k] - want[k]).square().sum().item() for k in keep}
    den = {k: (rounded[k] - want[k]).square().sum().item() for k in keep}
    ratios = [math.sqrt(num[k] / den[k]) if den[k] else math.inf for k in keep]
    return float(np.median(ratios)), math.sqrt(sum(num.values()) / sum(den.values()))


def compare(got: Dict[str, Any], want: Dict[str, Any], rounded: Dict[str, Any],
            bad_rows: int) -> List[Tuple[str, float]]:
    """The numbers compared for ``correct`` (``loss_err``, ``grad_err``,
    ``update_gap``, ``data_rows_bad``) and, last, those only reported."""
    g_med = float(np.median(list(want["g1"].values())))
    keep = [k for k, g in want["g1"].items() if g >= 1e-3 * g_med]
    a, b = got["parts"], want["parts"]
    loss_err = ((a - b).norm() / b.norm()).item() if a.shape == b.shape else math.inf
    leaf_ratio, whole_ratio = grad_err(got["grads"], want["grads"], rounded["grads"], keep)
    return [("loss_err", loss_err), ("grad_err", leaf_ratio),
            ("update_gap", leaf_gap(got["change"], want["change"], keep)),
            ("data_rows_bad", float(bad_rows)),
            ("grad_gap", leaf_gap(got["g1"], want["g1"], keep)), ("grad_err_whole", whole_ratio),
            ("usage_gap", (got["usage"] != want["usage"]).float().mean().item())]


def layer_info(ctx: Context) -> Dict[str, Any]:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    n, t = tr["batch"], int(tr["clip_seconds"] * SAMPLE_RATE)
    model, dtype = cfg["model"], cfg.get("dtype") or "float32"
    layers = counts.encoder_layers(model, t) + counts.predictor_layers(model, t)
    gn = [x for x in layers if x["op"] == "group_norm"]
    return {"kind": "train", "n": n, "t": t, "dtype": dtype,
            "peak_s_per_step": 3 * counts.peak_time_s(layers, n, dtype),
            "group_norms_per_step": len(gn),
            "group_norm_bwd_bound_s_per_step": sum(
                counts.group_norm_bwd_bytes(n, x["c"], x["t"], dtype, x["film"])
                for x in gn) / counts.HBM_BYTES_PER_S}


def build(ctx: Context, root: str, stamp=lambda _: None):
    """The data directory, the loop and the seeded weights in it."""
    from vq_voice_swap_torch.train import VQVAETrainLoop

    files = write_data(ctx, os.path.join(root, "data"))
    stamp("data directory")
    loop = VQVAETrainLoop(VQVAETrainLoop.arg_parser().parse_args(
        loop_argv(ctx, os.path.join(root, "data"), os.path.join(root, "run"))))
    stamp("loop")
    with torch.device("meta"):
        shapes = Reference(**ctx.cell.config["model"])
    state = seeded_state(shapes, ctx.seed, ctx.device)
    with torch.no_grad():
        for model in [loop.model] + [e.model for e in loop.emas]:
            for name, p in model.named_parameters():
                p.copy_(state[name])
    return files, loop, state


def run(ctx: Context) -> Outcome:
    dev, tr = ctx.device, ctx.cell.traffic
    k = tr["steps_per_dispatch"]
    root = tempfile.mkdtemp(prefix="bench_train_")
    try:
        files, loop, state = build(ctx, root, ctx.stamp)
        feed = Feed(loop)
        # The judged steps warm every shape of the timed windows too.
        got = program_readings(loop, feed, state, k)
        ctx.stamp(f"first {1 + k} steps")
        step = FIRST + 1 + k
        ctx.setup_done()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        feed.wait_s = 0.0
        deadline = time.perf_counter() + ctx.seconds
        t_start = time.perf_counter()
        windows, timed_batches = 0, []
        while windows == 0 or time.perf_counter() < deadline:
            batches, _ = feed.run(k, step)
            if not windows:
                timed_batches = batches
            step += k
            windows += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        # Reserved, not allocated: the captured step's activations live in
        # the graph's private pool, which the allocated count leaves out.
        peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
        loop._flush_pending()
        info = layer_info(ctx)
        info.update(steps=windows * k, wall_s=wall, peak_bytes=peak,
                    data_wait_s=feed.wait_s)
        win = Window(info)
        if ctx.trace and dev.type == "cuda":
            count = tr["trace_windows"]

            def stretch():
                nonlocal step
                for _ in range(count):
                    feed.run(k, step)
                    step += k
                return count * k

            win.trace = traced(stretch)
            loop._flush_pending()
        feed.close()
        samples = windows * k * tr["batch"]
        del loop, feed
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        bad_rows = sum(rows_not_found(files, b) for b in got["batches"] + timed_batches)
        want = reference_readings(ctx, state, got["batches"])
        rounded = reference_readings(ctx, state, got["batches"][:1], dtype=torch.bfloat16)
        checks = compare(got, want, rounded, bad_rows)
        return Outcome({"samples_per_s": samples / wall}, samples, 0, checks, peak, win)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def control(ctx: Context) -> List[Tuple[str, float]]:
    """The cell's numbers for its control: the reference with every stored
    activation and weight through float8 (``fp8_everywhere``: the nearest
    precision below bfloat16; the program has no int8 or float8 training
    path) in the program's place, on the loop's first 1 + K batches."""
    root = tempfile.mkdtemp(prefix="bench_train_")
    try:
        files, loop, state = build(ctx, root)
        feed = Feed(loop)
        batches = feed.take(1 + ctx.cell.traffic["steps_per_dispatch"], FIRST)
        feed.close()
        del loop, feed
        got = reference_readings(ctx, state, batches, fp8=True)
        want = reference_readings(ctx, state, batches)
        rounded = reference_readings(ctx, state, batches[:1], dtype=torch.bfloat16)
        return compare(got, want, rounded, sum(rows_not_found(files, b) for b in batches))
    finally:
        shutil.rmtree(root, ignore_errors=True)
