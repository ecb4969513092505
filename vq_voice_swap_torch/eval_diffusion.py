"""A diffusion model's held-out eps-MSE by timestep quantile (counterpart
of the JAX package's ``eval_diffusion.py``).

One epoch of the data loader: each batch is noised at uniform timesteps
through ``DiffusionModel.losses``, the training loss, and a
``LossTracker`` prints the running mean of each quantile of t. A
class-conditional model gets the true labels. Batch i draws its t and
noise from a generator seeded from (--seed, i). Runs on CUDA unless
--device names another device.

Example:
    python -m vq_voice_swap_torch.eval_diffusion --batch-size 16 model.npz \\
        /data/LibriSpeech/dev-clean
"""

import argparse
from typing import Optional, Sequence, Tuple

import torch

from .data import create_data_loader
from .diffusion_model import DiffusionModel
from .observe import LossTracker
from .util import resolve_device, step_generator


def eval_batch(model: DiffusionModel, samples: torch.Tensor, labels: torch.Tensor,
               generator: Optional[torch.Generator] = None, ts: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ts, per-element eps-MSE) of a [N, T] batch; ts and noise ([N, T, 1])
    are drawn from ``generator`` unless given."""
    lab = labels if model.num_labels is not None else None
    losses, ts = model.losses(samples[..., None], labels=lab, ts=ts, noise=noise,
                              generator=generator)
    return ts, losses


@torch.inference_mode()
def main(argv: Optional[Sequence[str]] = None) -> None:
    args = arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    data_loader, _ = create_data_loader(args.data_dir, batch_size=args.batch_size,
                                        encoding=args.encoding)

    print("loading model from checkpoint...")
    model = DiffusionModel.load(args.checkpoint_path, device=device)

    tracker = LossTracker(avg_size=1_000_000)
    num_samples = 0
    for i, batch in enumerate(data_loader):
        ts, losses = eval_batch(model, torch.from_numpy(batch["samples"]).to(device),
                                torch.from_numpy(batch["label"]).long().to(device),
                                step_generator(args.seed, i, device))
        tracker.add(ts.cpu(), losses.cpu())
        num_samples += len(batch["samples"])
        msg = " ".join(f"{k}={v:.06f}" for k, v in tracker.log_dict().items())
        print(f"{num_samples} samples: {msg}")


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--encoding", type=str, default="linear",
                        help="waveform encoding the model was trained with")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on; never falls back")
    parser.add_argument("checkpoint_path", type=str)
    parser.add_argument("data_dir", type=str)
    return parser


if __name__ == "__main__":
    main()
