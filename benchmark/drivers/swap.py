"""Voice swap as bulk conversion: a closed loop of back-to-back batches,
each ``batch`` fresh speech-like clips of ``clip_seconds`` with target
labels drawn uniformly, encoded (``VQVAE.encode``) and decoded
(``VQVAE.decode``, the mix's sampler and steps) by the program; the next
batch starts when the last one has finished, and only before the
deadline.

End to end: ``rtf``, the seconds of audio swapped over the wall seconds
from the window's start to the last batch's completion.

Correct: the window records, for ``keep_rows`` rows of every batch drawn
from the seed, the codes, every predictor call's input and output
(``predict_eps``) and the waveform. After the window ``check_clips`` of
those rows, drawn from the seed, are judged by the plain float32
reference (``reference/model.py``), stage by stage from the program's own
state, since a whole 10-step decode of seeded weights amplifies bfloat16
rounding past any precision control:

- ``code_gap``: the excess of the distances from the reference encoder's
  outputs to the program's codes over their distances to the nearest
  codes, summed over the frames, as a share of the nearest distances'
  sum (0 where every code is the nearest; a near tie adds little, a wrong
  code much);
- ``eps_err``: a clip's distance of the predictor outputs from the
  reference predictor's at the same inputs, grid times, codes and label,
  in units of the same reference's rounding in bfloat16 (``judge``); the
  largest over the clips;
- ``step_err``: the largest relative L2 distance of a sampler state (the
  next call's input, and last the waveform) from the reference's DPM++
  update of the program's previous state and output, the first state
  against the starting noise the benchmark drew."""

import copy
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

import counts
from harness import (SAMPLE_RATE, Context, Outcome, Window, full_float32, generator,
                     load_weights, seeded_state, speech_batch, traced)
from reference.model import VQVAE as Reference
from reference.model import (Quant, distances, dpmpp_sample, dpmpp_update, grid_time,
                             quantize_convs)


def sizes(ctx: Context) -> Tuple[int, int, int]:
    tr = ctx.cell.traffic
    return tr["batch"], int(tr["clip_seconds"] * SAMPLE_RATE), tr["steps"]


def batch_inputs(ctx: Context, index: int):
    """Clips [n, t, 1], labels [n] and starting noise [n, t, 1] of batch
    ``index``, from the seed."""
    n, t, _ = sizes(ctx)
    dev = ctx.device
    clips = speech_batch(n, t, dev, ctx.seed, "swap", index)
    labels = torch.randint(0, ctx.cell.config["model"]["num_labels"], (n,),
                           generator=generator(dev, ctx.seed, "labels", index), device=dev)
    x_T = torch.randn((n, t, 1), generator=generator(dev, ctx.seed, "noise", index), device=dev)
    return clips, labels, x_T


def reference_model(ctx: Context, state: Dict[str, torch.Tensor]) -> Reference:
    ref = Reference(**ctx.cell.config["model"]).to(ctx.device)
    load_weights(ref, state)
    return ref.eval()


def make_weights(ctx: Context) -> Dict[str, torch.Tensor]:
    """Seeded weights with a trained model's scales where the seed alone
    gives none: the encoder's output convolution is scaled and shifted so
    that each channel of its output over a few seeded clips has mean 0 and
    variance 1, and the codebook is centred on those outputs at their
    spread over time, so that the clips pick many codes. (Left as drawn,
    the encoder's channels sit at means of some tens with a spread of a
    few, and the predictor's conditioning then swamps its input.)"""
    n, t, _ = sizes(ctx)
    with torch.device("meta"):
        shapes = Reference(**ctx.cell.config["model"])
    state = seeded_state(shapes, ctx.seed, ctx.device)
    encoder = shapes.encoder.to_empty(device=ctx.device)
    encoder.load_state_dict({k[len("encoder."):]: v for k, v in state.items()
                             if k.startswith("encoder.")})
    with torch.no_grad(), full_float32():
        enc = encoder(speech_batch(min(n, 16), t, ctx.device, ctx.seed, "centre"))
        mean, std = enc.mean(dim=(0, 1)), enc.std(dim=(0, 1))
        w, b = "encoder.out_conv.conv.weight", "encoder.out_conv.conv.bias"
        state[w] = state[w] / std[:, None, None]
        state[b] = (state[b] - mean) / std
        enc = (enc - mean) / std
        d = state["vq.dictionary"]
        state["vq.dictionary"] = enc.mean(dim=(0, 1)) + d * enc.std(dim=1).mean()
    return state


def program_model(ctx: Context, state: Dict[str, torch.Tensor]):
    from vq_voice_swap_torch.vq_vae import VQVAE

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    with torch.device(ctx.device):
        model = VQVAE(**cfg["model"], dtype=cfg.get("dtype"),
                      act_int8_min_t=tr.get("act_int8_min_t", 0))
    load_weights(model, state)
    return model.eval().requires_grad_(False)


def swap(ctx: Context, model, clips, labels, x_T):
    tr = ctx.cell.traffic
    with torch.no_grad():
        codes = model.encode(clips)
        out = model.decode(codes, labels=labels, steps=tr["steps"], sampler=tr["sampler"],
                           constrain=tr["constrain"], x_T=x_T)
    return codes, out


def kept_rows(ctx: Context, index: int) -> List[int]:
    n, _, _ = sizes(ctx)
    g = torch.Generator().manual_seed(ctx.seed % (2**62) + 7919 * index)
    return torch.randperm(n, generator=g)[:ctx.cell.traffic["keep_rows"]].tolist()


def pick(x: torch.Tensor, rows: List[int]) -> Optional[torch.Tensor]:
    """Copies of x's rows, stacked: views by integer index and one copy on
    the device, so that the host never waits for the card (a list index
    would copy the index to the card and wait)."""
    return torch.stack([x[r] for r in rows]) if rows else None


class Recorder:
    """Wraps the model's ``predict_eps`` (the sampler's predictor call) to
    keep the input and output rows of the batch's kept rows."""

    def __init__(self, model):
        self.rows: List[int] = []
        self.calls: List[Tuple[List[int], List[int], Any, Any]] = []
        orig = model.predict_eps

        def recorded(x, ts, *args, **kw):
            out = orig(x, ts, *args, **kw)
            rows = [r for r in self.rows if r < x.shape[0]]
            self.calls.append((self.rows, rows, pick(x, rows), pick(out, rows)))
            return out

        model.predict_eps = recorded

    def take(self) -> Dict[int, List]:
        """{row: [x_0, eps_0, x_1, eps_1, ...]} of the calls since the last
        take; a row that a call lacked gets None there."""
        seq: Dict[int, List] = {r: [] for r in self.rows}
        for want, rows, x, eps in self.calls:
            for r in want:
                at = rows.index(r) if r in rows else None
                seq[r] += [None, None] if at is None else [x[at], eps[at]]
        self.calls = []
        return seq


def one_batch(ctx: Context, model, recorder: Recorder, index: int, bad: torch.Tensor,
              kept: Dict) -> None:
    """Swap batch ``index``; count its rows that are not finite in ``bad``
    and keep its kept rows' codes, calls and waveform in ``kept``."""
    recorder.rows = kept_rows(ctx, index)
    codes, out = swap(ctx, model, *batch_inputs(ctx, index))
    bad += (~torch.isfinite(out).reshape(out.shape[0], -1).all(dim=1)).sum()
    for r, seq in recorder.take().items():
        kept[(index, r)] = (codes[r] if r < codes.shape[0] else None,
                            seq + [out[r].clone() if r < out.shape[0] else None])


def window(ctx: Context, model, recorder: Recorder, deadline: float,
           kept: Dict) -> Dict[str, Any]:
    """Batches from 0 on, each started before ``deadline``; keeps every
    batch's kept rows' codes, calls and waveform in ``kept``."""
    bad = torch.zeros((), dtype=torch.long, device=ctx.device)
    index = 0
    t_start = time.perf_counter()
    while index == 0 or time.perf_counter() < deadline:
        one_batch(ctx, model, recorder, index, bad, kept)
        index += 1
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    return {"batches": index, "wall_s": wall, "failed": int(bad)}


def check_items(ctx: Context, kept: Dict) -> List[Tuple[int, int]]:
    """(batch, row) pairs to judge: ``check_clips`` of the kept rows, drawn
    from the seed."""
    items = sorted(kept)
    g = torch.Generator().manual_seed(ctx.seed % (2**62) + 1)
    chosen = torch.randperm(len(items), generator=g)[:ctx.cell.traffic["check_clips"]]
    return sorted(items[i] for i in chosen.tolist())


def gather_inputs(ctx: Context, items: Sequence[Tuple[int, int]]):
    clips, labels, noise = [], [], []
    for b, r in items:
        c, lab, x = batch_inputs(ctx, b)
        clips.append(c[r])
        labels.append(lab[r])
        noise.append(x[r])
    return torch.stack(clips), torch.stack(labels), torch.stack(noise)


def rel(got: Optional[torch.Tensor], want: torch.Tensor) -> float:
    if got is None or got.shape != want.shape:
        return math.inf
    return ((got - want).norm() / want.norm()).item()


def judge(ctx: Context, ref: Reference, items, outputs: Dict) -> List[Tuple[str, float]]:
    """``code_gap``, ``eps_err`` and ``step_err`` of the recorded outputs
    ({(batch, row): (codes, [x_0, eps_0, ..., x_steps])}) of ``items``.

    ``eps_err`` is in units of rounding: a clip's distance of the program's
    predictor outputs from the float32 reference's, over the distance of
    the same reference run in bfloat16 (its weights and activations) from
    it, over the clip's calls. The seeded UNet amplifies rounding by a
    factor that changes from seed to seed (2-5x between seeds of the
    same width); the ratio holds it out, so one limit fits every seed."""
    tr = ctx.cell.traffic
    steps = tr["steps"]
    clips, labels, x_T = gather_inputs(ctx, items)
    low = copy.deepcopy(ref).to(torch.bfloat16)
    excess = nearest = eps_err = step_err = 0.0
    inf = [("code_gap", math.inf), ("eps_err", math.inf), ("step_err", math.inf)]
    d = ref.vq.dictionary
    with torch.no_grad(), full_float32():
        for k, item in enumerate(items):
            codes, seq = outputs[item]
            if codes is None or len(seq) != 2 * steps + 1 or any(v is None for v in seq):
                return inf
            dist = distances(d, ref.encoder(clips[k:k + 1]))[0]
            best = dist.min(dim=-1).values
            gaps = dist.gather(-1, codes[:, None])[:, 0] - best
            excess += gaps.sum().item()
            nearest += best.sum().item()
            cond = d[codes][None]
            step_err = max(step_err, rel(seq[0], x_T[k]))
            prev, num, den = None, 0.0, 0.0
            for i in range(steps):
                x, eps, nxt = seq[2 * i], seq[2 * i + 1], seq[2 * i + 2]
                ts = torch.full((1,), grid_time(i, steps), device=x.device)
                want = ref.predictor(x[None], ts, cond, labels[k:k + 1])[0]
                rounded = low.predictor(x[None].bfloat16(), ts, cond.bfloat16(),
                                        labels[k:k + 1])[0].float()
                num += (eps - want).square().sum().item()
                den += (rounded - want).square().sum().item()
                upd, prev = dpmpp_update(i, steps, x[None], eps[None], prev, tr["constrain"])
                step_err = max(step_err, rel(nxt, upd[0]))
            eps_err = max(eps_err, math.sqrt(num / den))
    return [("code_gap", excess / nearest), ("eps_err", eps_err), ("step_err", step_err)]


def layer_info(ctx: Context) -> Dict[str, Any]:
    """Work of one batch and of one predictor call, from the shapes."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    n, t, steps = sizes(ctx)
    model, dtype = cfg["model"], cfg.get("dtype") or "float32"
    min_t = tr.get("act_int8_min_t", 0)
    enc = counts.encoder_layers(model, t)
    pred = counts.predictor_layers(model, t, min_t)
    vq_flops = counts.vq_flops(model, t)
    peak_s = (counts.peak_time_s(enc, n, dtype) + n * vq_flops / counts.PEAK["tf32"]
              + steps * counts.peak_time_s(pred, n, dtype))
    gn = [x for x in pred if x["op"] == "group_norm"]
    gn_bytes = [counts.group_norm_bytes(n, x["c"], x["t"], dtype, x["film"], x["x"], x["apply"])
                for x in gn]
    gn_int8 = [b["stats"] for x, b in zip(gn, gn_bytes) if x["x"] != "float"]
    quant = [x for x in pred if x["op"] == "quantize"]
    int8 = [x for x in pred if x.get("int8")]
    hbm = counts.HBM_BYTES_PER_S
    return {"kind": "swap", "n": n, "t": t, "steps": steps, "dtype": dtype,
            "audio_s_per_batch": n * t / SAMPLE_RATE,
            "peak_s_per_batch": peak_s,
            "group_norm_stats_per_call": len(gn) - len(gn_int8),
            "group_norm_stats_int8_per_call": len(gn_int8),
            "group_norm_applies_per_call": sum("apply" in b for b in gn_bytes),
            "group_norm_bound_s_per_call": sum(sum(b.values()) for b in gn_bytes) / hbm,
            "group_norm_stats_int8_bound_s_per_call": sum(gn_int8) / hbm,
            "quantize_launches_per_call": 2 * len(quant),
            "quantize_bound_s_per_call": sum(counts.quantize_bytes(n, x, dtype)
                                             for x in quant) / hbm,
            "int8_convs_per_call": len(int8),
            "int8_conv_bound_s_per_call": sum(counts.conv_int8_bound_s(n, x, dtype)
                                              for x in int8)}


def setup(ctx: Context, stamp):
    torch.zeros(1, device=ctx.device)
    stamp("imports and the device's context")
    state = make_weights(ctx)
    stamp("weights")
    model = program_model(ctx, state)
    recorder = Recorder(model)
    stamp("model")
    # Warm every shape of the window: one batch as the window runs it
    # (kernel builds, Triton compiles, cuDNN plans, the quantized weights).
    one_batch(ctx, model, recorder, -1, torch.zeros((), dtype=torch.long, device=ctx.device), {})
    stamp("warm batch")
    return state, model, recorder


def run(ctx: Context) -> Outcome:
    dev = ctx.device
    state, model, recorder = setup(ctx, ctx.stamp)
    ctx.setup_done()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kept: Dict[Tuple[int, int], Any] = {}
    done = window(ctx, model, recorder, time.perf_counter() + ctx.seconds, kept)
    peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    info = layer_info(ctx)
    info.update(done, peak_bytes=peak)
    win = Window(info)
    if ctx.trace and dev.type == "cuda":
        first = done["batches"]
        batches = ctx.cell.traffic["trace_batches"]

        def stretch():
            # The window's own batches, recorded as it records; then let go.
            bad = torch.zeros((), dtype=torch.long, device=dev)
            for i in range(batches):
                one_batch(ctx, model, recorder, first + i, bad, {})
            return batches * info["steps"]

        win.trace = traced(stretch)
    e2e = {"rtf": done["batches"] * info["audio_s_per_batch"] / done["wall_s"]}
    items = check_items(ctx, kept)
    outputs = {i: kept[i] for i in items}
    del model, recorder, kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(ctx, reference_model(ctx, state), items, outputs)
    return Outcome(e2e, done["batches"] * info["n"], done["failed"], checks, peak, win)


def reference_outputs(ctx: Context, ref: Reference, items, quant: Quant, state_dtype):
    """The reference in the program's place: its own codes and sampler
    sequence for ``items``."""
    tr = ctx.cell.traffic
    clips, labels, x_T = gather_inputs(ctx, items)
    out = {}
    with torch.no_grad(), full_float32():
        for k, item in enumerate(items):
            codes = distances(ref.vq.dictionary, ref.encoder(clips[k:k + 1]))[0].argmin(dim=-1)
            cond = ref.vq.dictionary[codes][None]

            def pred(x, ts, cond=cond, lab=labels[k:k + 1]):
                return ref.predictor(x, ts, cond, lab, q=quant)

            seq = dpmpp_sample(x_T[k:k + 1], pred, tr["steps"], tr["constrain"], state_dtype)
            out[item] = (codes, [s[0] for s in seq])
    return out


def control(ctx: Context) -> List[Tuple[str, float]]:
    """Each of the cell's numbers for its control, the nearest precision
    below the one its stage runs in, in the program's place (the mix's
    ``control``): the codes of the reference encoder with every
    convolution at ``encoder_bits``; the predictor outputs of the program
    with its int8 activation path at ``act_int8_min_t``, or of the
    reference at ``reference_bits`` where the program stores int8; the
    sampler's states rounded to ``state_dtype``."""
    spec, tr = ctx.cell.traffic["control"], ctx.cell.traffic
    n, _, _ = sizes(ctx)
    items = [(0, r) for r in range(min(n, tr["check_clips"]))]
    state = make_weights(ctx)
    ref = reference_model(ctx, state)
    min_t = tr.get("act_int8_min_t", 0)
    low_enc = reference_model(ctx, state)
    quantize_convs(low_enc.encoder, spec["encoder_bits"])
    coded = reference_outputs(ctx, low_enc, items, Quant(), None)
    del low_enc
    stepped = reference_outputs(ctx, ref, items, Quant(), getattr(torch, spec["state_dtype"]))
    if "act_int8_min_t" in spec:
        ctx.cell.traffic = dict(tr, act_int8_min_t=spec["act_int8_min_t"], keep_rows=n)
        _, model, recorder = setup(ctx, lambda _: None)
        kept: Dict[Tuple[int, int], Any] = {}
        window(ctx, model, recorder, 0.0, kept)
        ctx.cell.traffic = tr
        del model, recorder
        predicted = {i: kept[i] for i in items}
    else:
        predicted = reference_outputs(ctx, ref, items, Quant(spec["reference_bits"], min_t), None)
    return [(name, dict(judge(ctx, ref, items, outputs))[name]) for name, outputs in
            (("code_gap", coded), ("eps_err", predicted), ("step_err", stepped))]
