"""How much a trained VQ-VAE leans on its speaker labels (counterpart of
the JAX package's ``eval_vqvae.py``).

One epoch of the data loader: each batch is encoded (``encode_raw``, then
the VQ's straight-through output) and noised at uniform timesteps; the
predictor's eps-MSE is taken with the true labels and with random ones,
and the conditioning's standard deviation per clip. Each goes into a
``LossTracker`` of its own (``cond_``, ``rand_``, ``cond_std_``), by
timestep quantile. The model's labels must be the dataset's. Batch i
draws from a generator seeded from (--seed, i). Runs on CUDA unless
--device names another device.

Example:
    python -m vq_voice_swap_torch.eval_vqvae --batch-size 16 model.npz \\
        /data/LibriSpeech/dev-clean
"""

import argparse
from typing import Dict, Optional, Sequence

import torch

from .data import create_data_loader
from .observe import LossTracker
from .util import resolve_device, step_generator
from .vq import vq_forward
from .vq_vae import VQVAE


def eval_batch(model: VQVAE, samples: torch.Tensor, labels: torch.Tensor,
               generator: Optional[torch.Generator] = None, ts: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               rand_labels: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """"ts", "cond" and "rand" (per-element eps-MSE with the true and with
    random labels) and "cond_std" of a [N, T] batch. ts [N], noise
    [N, T, 1] and rand_labels [N] are drawn from ``generator`` in that
    order unless given."""
    x = samples[..., None]
    n, dev = x.shape[0], x.device
    if ts is None:
        ts = torch.rand((n,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=dev)
    if rand_labels is None:
        rand_labels = torch.randint(0, model.num_labels, (n,), generator=generator,
                                    device=dev)
    noised = model.diffusion.sample_q(x, ts, epsilon=noise)
    cond = vq_forward(model.vq.dictionary, model.encode_raw(x))["passthrough"]

    def mses_for(lab: torch.Tensor) -> torch.Tensor:
        pred = model.predict_eps(noised, ts, cond=cond, labels=lab)
        return torch.square(noise - pred).reshape(n, -1).mean(dim=1)

    return {"ts": ts, "cond": mses_for(labels), "rand": mses_for(rand_labels),
            "cond_std": cond.reshape(n, -1).std(dim=1, unbiased=False)}


@torch.inference_mode()
def main(argv: Optional[Sequence[str]] = None) -> None:
    args = arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    data_loader, num_labels = create_data_loader(args.data_dir, batch_size=args.batch_size,
                                                 encoding=args.encoding)

    print("loading model from checkpoint...")
    model = VQVAE.load(args.checkpoint_path, device=device)
    if model.num_labels != num_labels:
        raise SystemExit(f"model has {model.num_labels} labels, dataset has {num_labels}")

    trackers = {name: LossTracker(avg_size=1_000_000, prefix=f"{name}_")
                for name in ("cond", "rand", "cond_std")}
    num_samples = 0
    for i, batch in enumerate(data_loader):
        out = eval_batch(model, torch.from_numpy(batch["samples"]).to(device),
                         torch.from_numpy(batch["label"]).long().to(device),
                         step_generator(args.seed, i, device))
        ts = out["ts"].cpu()
        for name, tracker in trackers.items():
            tracker.add(ts, out[name].cpu())
        num_samples += len(batch["samples"])
        log = {}
        for tracker in trackers.values():
            log.update(tracker.log_dict())
        msg = " ".join(f"{k}={v:.06f}" for k, v in log.items())
        print(f"{num_samples} samples: {msg}")


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--encoding", type=str, default="linear",
                        help="waveform encoding the model was trained with (ulaw for the "
                             "conv-mfcc-ulaw recipes)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on; never falls back")
    parser.add_argument("checkpoint_path", type=str)
    parser.add_argument("data_dir", type=str)
    return parser


if __name__ == "__main__":
    main()
