"""Speaker conversion with classifier-free guidance (counterpart of the JAX
package's ``sample_vqvae_uncond.py``).

Encodes up to --seconds of a .wav (or takes the raw encoder output with
--no-vq) and decodes it as speaker --label with the x0 constraint through
``VQVAE.decode_uncond_guidance``: one predictor call per step on a stacked
batch, guided away from the prediction without the codes by
--guide-vq-scale and from the one without the label by
--guide-label-scale. The model is one fine-tuned with an unconditional
label (0; speakers are offset by 1) and zeroed codes. --schedule names a
time warp. Runs on CUDA unless --device names another device.

Launched by ``torchrun``, ``--tensor-parallel T`` cuts the model's
weights over groups of T ranks (``parallel/tensor.py``); the one clip is
converted on every data row and rank 0 alone writes the output.

--act-int8 MIN_T serves the decoder with int8-stored activations at the
UNet levels whose time axis is at least MIN_T (``ops/qact.py``; 0 keeps
the checkpoint's setting).

Example:
    python -m vq_voice_swap_torch.sample_vqvae_uncond --label 3 \\
        --guide-label-scale 1 --sampler dpmpp --sample-steps 10 \\
        --input-file speech.wav model.npz converted.wav
"""

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from .data import ChunkWriter, read_audio_input
from .diffusion import make_warp
from .parallel import init_distributed, init_grid, is_primary, shard_model_tp
from .vq_vae import VQVAE


@torch.no_grad()
def main(argv: Optional[Sequence[str]] = None) -> None:
    args = arg_parser().parse_args(argv)
    warp = make_warp(args.schedule)
    if args.check_vq and args.no_vq:
        raise SystemExit("--check-vq requires VQ codes; incompatible with --no-vq")
    device = init_distributed(args.device)
    init_grid(args.tensor_parallel, device)

    print("loading model from checkpoint...")
    model = VQVAE.load(args.checkpoint_path, device=device,
                       act_int8_min_t=args.act_int8 or None)
    # Label 0 is the unconditional token, so speaker l is label l + 1.
    if model.num_labels is None or not 0 <= args.label < model.num_labels - 1:
        raise SystemExit(f"label {args.label} out of range for a model with "
                         f"{model.num_labels} labels (the first is unconditional)")
    if args.tensor_parallel > 1:
        shard_model_tp(model)

    print(f"loading waveform from {args.input_file}...")
    chunk = read_audio_input(args.input_file, args.sample_rate, args.seconds, args.encoding)
    in_seq = torch.from_numpy(chunk).to(device)[None, :, None]

    print("encoding audio sequence...")
    encoded = model.encode_raw(in_seq) if args.no_vq else model.encode(in_seq)

    print("decoding audio samples...")
    sample = model.decode_uncond_guidance(
        encoded,
        labels=torch.tensor([args.label], dtype=torch.long, device=device),
        steps=args.sample_steps,
        constrain=True,
        label_scale=args.guide_label_scale,
        vq_scale=args.guide_vq_scale,
        sampler=args.sampler,
        eta=args.eta,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        warp=warp,
    )

    if args.check_vq:
        agreement = (model.encode(sample) == encoded).float().mean().item()
        print(f"fraction of consistent VQ codes: {agreement}")

    if not is_primary():
        return
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
    parser.add_argument("--schedule", default="linear", type=str,
                        help="named time warp: linear|quadratic|sqrt|pow:X")
    parser.add_argument("--guide-label-scale", type=float, default=1.0)
    parser.add_argument("--guide-vq-scale", type=float, default=0.0)
    parser.add_argument("--sampler", type=str, default="ddpm",
                        choices=("ddpm", "ddim", "dpmpp"),
                        help="ddim / dpmpp allow far fewer steps; dpmpp = "
                             "DPM-Solver++(2M), second-order")
    parser.add_argument("--eta", type=float, default=0.0,
                        help="DDIM stochasticity (0 = deterministic)")
    parser.add_argument("--no-vq", action="store_true")
    parser.add_argument("--check-vq", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--act-int8", default=0, type=int, metavar="MIN_T",
                        help="serve the decoder with int8-stored "
                             "activations at UNet levels with T >= MIN_T "
                             "(0 = off)")
    parser.add_argument("--tensor-parallel", type=int, default=1,
                        help="model-axis size of a 2-D data x model grid of the ranks of "
                             "a launched run; weights shard on their output-feature axis "
                             "(the world size must be divisible)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda:LOCAL_RANK under torchrun); "
                             "never falls back")
    parser.add_argument("checkpoint_path", type=str)
    parser.add_argument("output_file", type=str)
    return parser


if __name__ == "__main__":
    main()
