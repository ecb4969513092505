"""Rank a VQ-VAE's speaker labels by how well each reconstructs a clip
("which voice is this?"; counterpart of the JAX package's
``voice_search_vqvae.py``).

The clip is encoded once; then every (label, t) pair, t over
linspace(0, 1, --num-timesteps), is noised with each of --num-seeds fixed
noises and scored by the predictor's eps-MSE, --batch-size pairs a call
(the last batch padded). Each label's mean is printed for the --top-k
lowest. The noises come from a generator seeded from --seed. Runs on CUDA
unless --device names another device.

Example:
    python -m vq_voice_swap_torch.voice_search_vqvae --input-file clip.wav model.npz
"""

import argparse
from typing import List, Optional, Sequence

import torch

from .data import read_audio_input
from .util import resolve_device
from .vq_vae import VQVAE


def label_losses(model: VQVAE, target: torch.Tensor, epsilons: torch.Tensor,
                 num_timesteps: int, batch_size: int) -> List[float]:
    """Each label's mean eps-MSE for the clip ``target`` [1, T, 1] over
    ``num_timesteps`` timesteps and the noises ``epsilons`` [S, 1, T, 1]."""
    dev = target.device
    encoded = model.embed_codes(model.encode(target))
    labels = torch.arange(model.num_labels, device=dev).repeat_interleave(num_timesteps)
    ts = torch.linspace(0.0, 1.0, num_timesteps, device=dev).repeat(model.num_labels)
    seeds = epsilons.shape[0]
    results = []
    for i in range(0, len(labels), batch_size):
        mb_labels, mb_ts = labels[i:i + batch_size], ts[i:i + batch_size]
        real = len(mb_labels)
        if real < batch_size:  # the tail is padded, as every batch is one shape
            pad = batch_size - real
            mb_labels = torch.cat([mb_labels, mb_labels.new_zeros(pad)])
            mb_ts = torch.cat([mb_ts, mb_ts.new_zeros(pad)])
        # Every seed's noise in one predictor call: [S * n, T, 1].
        eps = epsilons.expand(seeds, batch_size, *target.shape[1:]).reshape(
            seeds * batch_size, *target.shape[1:])
        ts_all, labels_all = mb_ts.repeat(seeds), mb_labels.repeat(seeds)
        noised = model.diffusion.sample_q(target.expand_as(eps), ts_all, epsilon=eps)
        pred = model.predict_eps(noised, ts_all, cond=encoded.expand(len(eps), -1, -1),
                                 labels=labels_all)
        mses = torch.square(pred - eps).reshape(seeds, batch_size, -1).mean(dim=2)
        results.append(mses.mean(dim=0)[:real])
        print(f"  {i + real}/{len(labels)}")
    return torch.cat(results).reshape(-1, num_timesteps).mean(dim=1).tolist()


@torch.inference_mode()
def main(argv: Optional[Sequence[str]] = None) -> None:
    args = arg_parser().parse_args(argv)
    device = resolve_device(args.device)

    print("loading model from checkpoint...")
    model = VQVAE.load(args.checkpoint_path, device=device)
    if model.num_labels is None:
        raise SystemExit("voice search needs a class-conditional VQ-VAE")

    print(f"loading waveform from {args.input_file}...")
    chunk = read_audio_input(args.input_file, args.sample_rate, args.seconds, args.encoding)
    target = torch.from_numpy(chunk).to(device)[None, :, None]
    generator = torch.Generator(device=device).manual_seed(args.seed)
    epsilons = torch.randn((args.num_seeds, *target.shape), generator=generator,
                           device=device)

    print("evaluating all losses...")
    losses = label_losses(model, target, epsilons, args.num_timesteps, args.batch_size)

    print(f"top {min(args.top_k, len(losses))} sorted losses")
    print("-------")
    for label, loss in sorted(enumerate(losses), key=lambda x: x[1])[:args.top_k]:
        print(f"{label}\t\t{loss:.6f}")


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--sample-rate", type=int, default=16000)
    parser.add_argument("--seconds", type=int, default=4)
    parser.add_argument("--encoding", type=str, default="linear")
    parser.add_argument("--num-timesteps", type=int, default=16)
    parser.add_argument("--num-seeds", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--top-k", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--input-file", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on; never falls back")
    parser.add_argument("checkpoint_path", type=str)
    return parser


if __name__ == "__main__":
    main()
