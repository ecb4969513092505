"""Quality of the voice swap at eval scale (counterpart of the JAX
package's ``scripts/swap_eval.py``).

Source clips come from the tones set (3 sine "speakers" at 300, 500 and
1000 Hz); each is encoded, decoded with the x0 constraint as the NEXT
speaker, and re-encoded. Per clip: the check-vq agreement (the share of
codes a re-encode keeps), whether the output's FFT peak is nearest the
target speaker's tone (target hit) and whether it stayed at the source's
(source leak). The converted clips are written as ``sample_%06d.wav``, for
``stat_generate --sample-dir``, and each batch's metrics as
``metrics_%05d.json``, both atomically; batch b draws from a generator
seeded from (--seed, b), so a rerun skips the finished batches and gives
the same bits for the rest. ``report.json`` aggregates every batch. Runs
on CUDA unless --device names another device.

Example:
    python -m vq_voice_swap_torch.swap_eval --num-samples 10000 --sample-steps 5 \\
        --sampler dpmpp --bf16 model.npz swap_dpmpp5
"""

import argparse
import json
import math
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .data import ChunkWriter
from .data.datasets import ToneDataset
from .util import resolve_device, step_generator
from .vq_vae import VQVAE

SAMPLE_RATE = 16000
CLIP_LEN = 64000


def swap(model: VQVAE, audio: torch.Tensor, labels: torch.Tensor, args,
         generator: Optional[torch.Generator] = None, x_T: Optional[torch.Tensor] = None):
    """(converted audio [N, T, 1] float32, per-clip check-vq agreement [N])."""
    codes = model.encode(audio)
    out = model.decode(codes, labels=labels, steps=args.sample_steps, sampler=args.sampler,
                       eta=args.eta, constrain=True, x_T=x_T, generator=generator).float()
    agreement = (model.encode(out) == codes).float().mean(dim=-1)
    return out, agreement


def tone_metrics(out: np.ndarray, src: np.ndarray, tgt: np.ndarray,
                 freqs: np.ndarray) -> Dict[str, list]:
    """Target hit and source leak of each clip [N, T] from its FFT peak's
    nearest tone."""
    spec = np.abs(np.fft.rfft(out, axis=-1))
    peak_hz = np.argmax(spec, axis=-1) * (SAMPLE_RATE / CLIP_LEN)
    pred = np.argmin(np.abs(peak_hz[:, None] - freqs[None, :]), axis=-1)
    return {"target_hit": (pred == tgt).tolist(), "source_leak": (pred == src).tolist(),
            "peak_hz": peak_hz.tolist()}


@torch.inference_mode()
def main(argv: Optional[Sequence[str]] = None) -> None:
    args = arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.sample_path, exist_ok=True)

    model = VQVAE.load(args.checkpoint_path, dtype="bfloat16" if args.bf16 else None,
                       device=device)
    if model.num_labels is None:
        raise SystemExit("swap eval needs a class-conditional VQ-VAE")

    dataset = ToneDataset(phases=int(math.ceil(args.num_samples / 3)))
    freqs = np.asarray(dataset.speaker_ids, dtype=np.float64)
    n_speakers = len(freqs)

    num_batches = int(math.ceil(args.num_samples / args.batch_size))
    for b in range(num_batches):
        lo = b * args.batch_size
        hi = min(lo + args.batch_size, args.num_samples)
        metrics_path = os.path.join(args.sample_path, f"metrics_{b:05}.json")
        wav_paths = [os.path.join(args.sample_path, f"sample_{c:06}.wav")
                     for c in range(lo, hi)]
        if os.path.exists(metrics_path) and all(os.path.exists(p) for p in wav_paths):
            continue

        # Sources cycle through the speakers; the target is the next one.
        idxs = np.arange(lo, hi)
        src = idxs % n_speakers
        tgt = (src + 1) % n_speakers
        audio = np.stack([dataset[i]["samples"] for i in idxs])[..., None]
        out, agree = swap(model, torch.from_numpy(audio).to(device),
                          torch.from_numpy(tgt).to(device), args,
                          generator=step_generator(args.seed, b, device))
        out = out.cpu().numpy()
        if not np.isfinite(out).all():
            raise SystemExit(f"batch {b}: the decoder produced non-finite samples")

        for seq, path in zip(out, wav_paths):
            write_wav(path, seq[:, 0])
        write_json(metrics_path, {"agreement": agree.cpu().tolist(),
                                  **tone_metrics(out[:, :, 0], src, tgt, freqs)})
        print(f"converted {hi}/{args.num_samples}", flush=True)

    report = aggregate(args.sample_path, num_batches)
    write_json(os.path.join(args.sample_path, "report.json"), report)
    print(json.dumps(report))


def aggregate(sample_path: str, num_batches: int) -> Dict[str, float]:
    agree, hit, leak = [], [], []
    for b in range(num_batches):
        with open(os.path.join(sample_path, f"metrics_{b:05}.json")) as f:
            m = json.load(f)
        agree += m["agreement"]
        hit += m["target_hit"]
        leak += m["source_leak"]
    return {
        "n": len(agree),
        "check_vq_agreement": float(np.mean(agree)),
        "target_tone_acc": float(np.mean(hit)),
        "source_tone_leak": float(np.mean(leak)),
    }


def write_wav(path: str, samples: np.ndarray) -> None:
    tmp = path + ".tmp.wav"
    with ChunkWriter(tmp, SAMPLE_RATE) as writer:
        writer.write(np.clip(np.asarray(samples).reshape(-1), -1, 1))
    os.replace(tmp, path)


def write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--num-samples", type=int, default=10000)
    parser.add_argument("--batch-size", type=int, default=20)
    parser.add_argument("--sample-steps", type=int, default=50)
    parser.add_argument("--sampler", type=str, default="ddpm",
                        choices=("ddpm", "ddim", "dpmpp"))
    parser.add_argument("--eta", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on; never falls back")
    parser.add_argument("checkpoint_path", type=str)
    parser.add_argument("sample_path", type=str)
    return parser


if __name__ == "__main__":
    main()
