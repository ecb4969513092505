"""Speaker conversion: encode a clip with the VQ-VAE, decode it as a target
speaker.

Reads up to --seconds of a .wav, encodes it to VQ codes (or raw encoder
output with --no-vq), decodes with --label and the x0 constraint, and
optionally reports how many codes survive a re-encode (--check-vq). Runs on
CUDA unless --device names another device.

Example:
    python -m vq_voice_swap_torch.sample_vqvae --label 3 --sample-steps 10 \
        --sampler dpmpp --input-file speech.wav model.npz converted.wav
"""

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from .data import ChunkWriter, read_audio_input
from .util import resolve_device
from .vq_vae import VQVAE


def convert(args, model: VQVAE, in_seq: torch.Tensor, generator: torch.Generator):
    """Encode -> decode with the target label; returns (audio, codes)."""
    encoded = model.encode_raw(in_seq) if args.no_vq else model.encode(in_seq)
    labels = (
        torch.tensor([args.label], dtype=torch.long, device=in_seq.device)
        if model.num_labels is not None
        else None
    )
    audio = model.decode(
        encoded,
        labels=labels,
        steps=args.sample_steps,
        constrain=True,
        sampler=args.sampler,
        eta=args.eta,
        generator=generator,
    )
    return audio, encoded


@torch.no_grad()
def main(argv: Optional[Sequence[str]] = None) -> None:
    args = arg_parser().parse_args(argv)
    if args.check_vq and args.no_vq:
        raise SystemExit("--check-vq requires VQ codes; incompatible with --no-vq")
    device = resolve_device(args.device)

    print("loading model from checkpoint...")
    model = VQVAE.load(args.checkpoint_path, device=device)
    if model.num_labels is not None and not 0 <= args.label < model.num_labels:
        raise SystemExit(f"label {args.label} out of range [0, {model.num_labels})")

    print(f"loading waveform from {args.input_file}...")
    chunk = read_audio_input(
        args.input_file, args.sample_rate, args.seconds, args.encoding
    )
    in_seq = torch.from_numpy(chunk).to(device)[None, :, None]

    print("encoding and decoding...")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    sample, encoded = convert(args, model, in_seq, generator)

    if args.check_vq:
        agreement = (model.encode(sample) == encoded).float().mean().item()
        print(f"fraction of consistent VQ codes: {agreement}")

    out = sample.reshape(-1).cpu().numpy()
    if not np.isfinite(out).all():
        raise SystemExit("the decoder produced non-finite samples")
    print(f"saving result to {args.output_file}...")
    with ChunkWriter(
        args.output_file, sample_rate=args.sample_rate, encoding=args.encoding
    ) as writer:
        writer.write(np.clip(out, -1, 1))


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("--sample-rate", type=int, default=16000)
    parser.add_argument("--sample-steps", type=int, default=100)
    parser.add_argument("--seconds", type=int, default=4)
    parser.add_argument("--label", type=int, required=True)
    parser.add_argument("--input-file", type=str, required=True)
    parser.add_argument("--encoding", type=str, default="linear")
    parser.add_argument("--no-vq", action="store_true")
    parser.add_argument("--check-vq", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sampler", type=str, default="ddpm",
                        choices=("ddpm", "ddim", "dpmpp"),
                        help="ddim / dpmpp allow far fewer steps; dpmpp = "
                             "DPM-Solver++(2M), second-order")
    parser.add_argument("--eta", type=float, default=0.0,
                        help="DDIM stochasticity (0 = deterministic)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on; never falls back")
    parser.add_argument("checkpoint_path", type=str)
    parser.add_argument("output_file", type=str)
    return parser


if __name__ == "__main__":
    main()
