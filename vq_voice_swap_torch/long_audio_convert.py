"""Minutes-long speaker conversion with the waveform's time axis sharded
over the ranks (``parallel/sequence.py``): encode, VQ and the diffusion
decode run on each rank's contiguous slice of the clip; convolutions
exchange halos with the neighbouring ranks and GroupNorm statistics merge
over them. Audio length scales with the ranks; on one rank it is the
one-device conversion of the whole clip.

    python -m vq_voice_swap_torch.long_audio_convert --checkpoint-path vqvae.npz \\
        --input long.wav --label 2 --output converted.wav --steps 50

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m vq_voice_swap_torch.long_audio_convert --checkpoint-path vqvae.npz ...

Rank 0 reads the clip (WAV, or through ffmpeg where it exists),
truncated to a multiple of the model's downsample rate times the ranks,
and writes the result. Needs a VQ-VAE with a UNet- or WaveGrad-family
encoder. Runs on CUDA unless --device names another device; the fused
ResBlock kernels, tensor parallelism and FSDP are refused on this path.
"""

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .data import ChunkReader, ChunkWriter
from .parallel import broadcast_from_primary, create_seq_mesh, init_distributed, is_primary
from .parallel.sequence import gather_sequence, seq_parallel_vqvae_convert, shard_sequence
from .vq_vae import VQVAE

SAMPLE_RATE = 16000
REFUSED = ("tensor_parallel", "fsdp", "fuse_levels")


def _read_clip(args, quantum: int) -> torch.Tensor:
    """Rank 0's clip, truncated to a multiple of ``quantum``, on every rank
    (float32, CPU)."""
    length = torch.zeros(1, dtype=torch.long)
    wav = None
    if is_primary():
        limit = int(args.max_seconds * SAMPLE_RATE) if args.max_seconds else 1 << 62
        with ChunkReader(args.input, SAMPLE_RATE, encoding=args.encoding) as reader:
            wav = reader.read(limit)
        if wav is not None:
            length[0] = len(wav) // quantum * quantum
    broadcast_from_primary([length])
    n = int(length[0])
    if wav is None and is_primary():
        raise SystemExit(f"could not decode any audio from {args.input!r} (missing file, "
                         "unsupported codec, or empty stream)")
    if not n:
        raise SystemExit(f"input too short: fewer samples than one quantum ({quantum})")
    clip = torch.from_numpy(np.ascontiguousarray(wav[:n], np.float32)) if is_primary() \
        else torch.empty(n, dtype=torch.float32)
    broadcast_from_primary([clip])
    return clip


@torch.no_grad()
def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """Convert the clip; returns the converted float samples (every rank)."""
    args = arg_parser().parse_args(argv)
    for name in REFUSED:
        if getattr(args, name):
            raise ValueError(f"--{name.replace('_', '-')} is refused on the sequence-parallel "
                             "path")
    device = init_distributed(args.device)
    model = VQVAE.load(args.checkpoint_path, device=device)
    if model.num_labels is not None and not 0 <= args.label < model.num_labels:
        raise SystemExit(f"--label {args.label} out of range for a model with "
                         f"{model.num_labels} speakers")
    mesh = create_seq_mesh()
    quantum = model.downsample_rate * mesh.size
    clip = _read_clip(args, quantum)
    seconds = len(clip) / SAMPLE_RATE
    if is_primary():
        print(f"converting {seconds:.1f}s of audio over {mesh.size} rank(s), "
              f"{args.steps} steps")
    x = shard_sequence(mesh, clip.to(device)[None, :, None])
    labels = (torch.tensor([args.label], device=device)
              if model.num_labels is not None else None)
    for run in range(max(1, args.repeat)):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        start = time.perf_counter()
        generator = torch.Generator(device=device).manual_seed(args.seed)
        local = seq_parallel_vqvae_convert(mesh, model, x, generator, labels=labels,
                                           steps=args.steps, constrain=True,
                                           sampler=args.sampler, eta=args.eta)
        out = gather_sequence(mesh, local).reshape(-1).cpu().numpy()
        elapsed = time.perf_counter() - start
        if is_primary():
            tag = " (incl. warm-up)" if run == 0 else ""
            print(f"decoded in {elapsed:.3f}s ({seconds / elapsed:.4f}x real time){tag}")
    if not np.isfinite(out).all():
        raise SystemExit("the decoder produced non-finite samples")
    if is_primary():
        with ChunkWriter(args.output, SAMPLE_RATE, encoding=args.encoding) as writer:
            writer.write(np.clip(out, -1, 1))
        print(f"wrote {args.output}")
    return out


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--checkpoint-path", type=str, required=True)
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--label", type=int, required=True, help="target speaker id")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--sampler", type=str, default="ddpm", choices=("ddpm", "ddim", "dpmpp"))
    parser.add_argument("--eta", type=float, default=0.0)
    parser.add_argument("--encoding", type=str, default="linear")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-seconds", type=float, default=None,
                        help="truncate the input to this many seconds")
    parser.add_argument("--repeat", type=int, default=1,
                        help="run the conversion N times and report each run's RTF: run 1 "
                             "pays the process's one-off warm-up (kernel builds and the "
                             "Triton compile)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda:LOCAL_RANK under torchrun); "
                             "never falls back")
    for flag in REFUSED:
        parser.add_argument("--" + flag.replace("_", "-"), type=int, nargs="?", const=1,
                            default=0, help=argparse.SUPPRESS)
    return parser


if __name__ == "__main__":
    main()
