"""Sample an unconditional or class-conditional diffusion model and write
.wav files (counterpart of the JAX package's ``sample_diffusion.py``).

One sample goes to --sample-path; with --num-samples, --sample-path is a
directory of sample_NNNNNN.wav files written --batch-size at a time. Each
batch draws its x_T, labels and noise from generators seeded from
(--seed, batch index), so a rerun skips the batches whose files all exist
and reproduces the rest exactly; files are written atomically (temp file,
then rename), so an existing file is a complete one. --schedule names a
time warp (quadratic is the t = s^2 recipe). --fuse-levels K runs the
same-resolution ResBlocks of the UNet's first K levels through the fused
ResBlock kernels. --classifier-path guides every step with the gradient
of a noised-audio classifier's log-probability of the sample's class,
scaled by --classifier-scale; an unconditional model then samples its
classes from the classifier's labels. Runs on CUDA unless --device names
another device.

Launched by ``torchrun`` (``python -m torch.distributed.run
--nproc-per-node N -m vq_voice_swap_torch.sample_diffusion ...``), the
ranks form N / T data rows of ``--tensor-parallel T`` model columns
(``parallel/tensor.py`` cuts the model's weights over each row's T
ranks). Every rank draws a batch's x_T, labels and noise as the
one-process run does; where the data rows divide the batch, each predictor
(and classifier) call runs on its data row's rows (row d + D*j of D) and
the results are gathered over the data rows, else every row runs the
whole batch. Rank 0 writes the one-process run's files, so which batches
are complete and skipped is what rank 0 finds, broadcast to every rank (a
rank on another host need not see the directory). The classifier stays
whole.

--act-int8 MIN_T serves the UNet with int8-stored activations at the
levels whose time axis is at least MIN_T (``ops/qact.py``; 0 keeps the
checkpoint's setting). Its amax covers the whole batch, so under
--tensor-parallel with --act-int8 every data row runs the whole batch
rather than its rows: the samples then match the one-process run's.
--act-int8 with --fuse-levels raises (the fused kernels are float only).

Example:
    python -m vq_voice_swap_torch.sample_diffusion --checkpoint-path model.npz \\
        --sampler dpmpp --sample-steps 10 --schedule quadratic --bf16 \\
        --fuse-levels 2 --num-samples 64 --batch-size 16 --sample-path samples
"""

import argparse
import math
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .classifier_model import ClassifierModel
from .data import ChunkWriter
from .diffusion import make_warp
from .diffusion_model import DiffusionModel
from .parallel import (broadcast_from_primary, data_rank, data_size, gather_data_rows,
                       init_distributed, init_grid, is_primary, shard_model_tp)

SAMPLE_LEN = 64000
SAMPLE_RATE = 16000


def _generators(seed: int, batch_index: int, device: torch.device) -> List[torch.Generator]:
    """Three generators (x_T, labels, sampler noise) for one batch, seeded
    from (seed, batch_index) alone."""
    states = np.random.SeedSequence([seed, batch_index]).generate_state(3, np.uint64)
    return [torch.Generator(device=device).manual_seed(int(s) >> 1) for s in states]


def num_classes(model: DiffusionModel, classifier: Optional[ClassifierModel]) -> Optional[int]:
    """The classes samples are drawn for: the model's, or the classifier's
    when the model is unconditional; None for neither."""
    if model.num_labels is None and classifier is not None:
        return classifier.num_labels
    return model.num_labels


def sample_batch(args, model: DiffusionModel, warp, batch: int, batch_index: int,
                 device: torch.device,
                 classifier: Optional[ClassifierModel] = None) -> torch.Tensor:
    """[batch, SAMPLE_LEN, 1] float32 samples of one batch, guided by
    ``classifier`` towards each sample's class when given."""
    gen_x, gen_labels, gen_noise = _generators(args.seed, batch_index, device)
    x_T = torch.randn((batch, SAMPLE_LEN, 1), generator=gen_x, device=device)
    labels = None
    classes = num_classes(model, classifier)
    if classes is not None:
        if args.target_class is not None:
            labels = torch.full((batch,), args.target_class, dtype=torch.long,
                                device=device)
        else:
            labels = torch.randint(0, classes, (batch,), generator=gen_labels,
                                   device=device)
    model_labels = labels if model.num_labels is not None else None
    rows = slice(None)
    # An int8 predictor's quantization scales span the whole batch: split
    # over data rows, each row would take its own.
    if data_size() > 1 and batch % data_size() == 0 and not model.act_int8_min_t:
        rows = slice(data_rank(), None, data_size())

    def on_rows(fn):
        """fn(x, ts) of the batch, run on this data row's rows and gathered."""
        if rows == slice(None):
            return fn
        return lambda x, ts: gather_data_rows(fn(x[rows], ts[rows]))

    cond_fn = None
    if classifier is not None:
        cond_fn = on_rows(classifier.cond_fn(labels[rows], args.classifier_scale))

    @on_rows
    def pred(xs, ts):
        return model.predict_eps(xs, ts,
                                 labels=None if model_labels is None else model_labels[rows])

    diffusion = model.diffusion
    kw = dict(constrain=args.constrain, warp=warp, cond_fn=cond_fn)
    if args.sampler == "ddim":
        return diffusion.ddim_sample(x_T, pred, args.sample_steps, generator=gen_noise,
                                     eta=args.eta, **kw)
    if args.sampler == "dpmpp":
        return diffusion.dpmpp_sample(x_T, pred, args.sample_steps, **kw)
    return diffusion.ddpm_sample(x_T, pred, args.sample_steps, generator=gen_noise, **kw)


def write_wav(path: str, samples: np.ndarray, encoding: str) -> None:
    """Write atomically: encode to a temp .wav, then rename, so an existing
    file is always a complete one (the resume path relies on it)."""
    if not np.isfinite(samples).all():
        raise SystemExit("the sampler produced non-finite samples")
    tmp = path + ".tmp.wav"
    with ChunkWriter(tmp, SAMPLE_RATE, encoding=encoding) as writer:
        writer.write(samples.reshape(-1))
    os.replace(tmp, path)


@torch.no_grad()
def main(argv: Optional[Sequence[str]] = None) -> None:
    args = arg_parser().parse_args(argv)
    warp = make_warp(args.schedule)
    device = init_distributed(args.device)
    init_grid(args.tensor_parallel, device)
    model = DiffusionModel.load(
        args.checkpoint_path, dtype="bfloat16" if args.bf16 else None,
        device=device, fuse_levels=args.fuse_levels, act_int8_min_t=args.act_int8 or None,
    )
    if args.tensor_parallel > 1:
        shard_model_tp(model)
    classifier = None
    if args.classifier_path:
        classifier = ClassifierModel.load(args.classifier_path, device=device)
    classes = num_classes(model, classifier)
    if args.target_class is not None:
        if classes is None:
            raise SystemExit("--target-class needs a class-conditional model or a "
                             "classifier")
        if not 0 <= args.target_class < classes:
            raise SystemExit(f"--target-class {args.target_class} out of range for a "
                             f"{classes}-class model")

    if args.num_samples is None:
        sample = sample_batch(args, model, warp, 1, 0, device, classifier)
        if is_primary():
            write_wav(args.sample_path, sample[0, :, 0].cpu().numpy(), args.encoding)
            print(f"wrote {args.sample_path}")
        return

    if is_primary():
        os.makedirs(args.sample_path, exist_ok=True)
    num_batches = int(math.ceil(args.num_samples / args.batch_size))
    paths = [[os.path.join(args.sample_path, f"sample_{c:06}.wav")
              for c in range(lo, min(lo + args.batch_size, args.num_samples))]
             for lo in range(0, args.num_samples, args.batch_size)]
    complete = torch.tensor([all(os.path.exists(p) for p in batch_paths)
                             for batch_paths in paths])
    broadcast_from_primary([complete])
    complete = complete.tolist()
    for i in range(num_batches):
        if complete[i]:
            continue
        samples = sample_batch(args, model, warp, args.batch_size, i, device, classifier)
        if is_primary():
            for seq, path in zip(samples.cpu().numpy(), paths[i]):
                write_wav(path, seq[:, 0], args.encoding)
            print(f"generated {i * args.batch_size + len(paths[i])}/{args.num_samples}")


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("--checkpoint-path", default="model_diffusion.npz", type=str)
    parser.add_argument("--sample-steps", default=100, type=int)
    parser.add_argument("--batch-size", default=1, type=int)
    parser.add_argument("--constrain", action="store_true")
    parser.add_argument("--sample-path", default="sample.wav", type=str)
    parser.add_argument("--num-samples", default=None, type=int)
    parser.add_argument("--classifier-path", default=None, type=str,
                        help="ClassifierModel checkpoint guiding every step")
    parser.add_argument("--classifier-scale", default=1.0, type=float)
    parser.add_argument("--target-class", default=None, type=int,
                        help="class of every sample (class-conditional models, or "
                             "the classifier's classes); random per sample when unset")
    parser.add_argument("--schedule", default="linear", type=str,
                        help="named time warp: linear|quadratic|sqrt|pow:X")
    parser.add_argument("--encoding", default="linear", type=str)
    parser.add_argument("--sampler", default="ddpm", type=str,
                        choices=("ddpm", "ddim", "dpmpp"),
                        help="ddim / dpmpp allow far fewer steps; dpmpp = "
                             "DPM-Solver++(2M), second-order")
    parser.add_argument("--eta", default=0.0, type=float,
                        help="DDIM stochasticity (0 = deterministic)")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--bf16", action="store_true",
                        help="compute in bfloat16 (params stay float32)")
    parser.add_argument("--fuse-levels", default=0, type=int,
                        help="run the same-resolution ResBlocks of the UNet's first "
                             "K levels through the fused ResBlock kernels")
    parser.add_argument("--act-int8", default=0, type=int, metavar="MIN_T",
                        help="serve with int8-stored activations at UNet "
                             "levels whose time axis is >= MIN_T (0 = off; "
                             "e.g. 16000 quantizes the top three levels of "
                             "a 4-s 16 kHz clip). Quality-gated by the 10k "
                             "Frechet protocol")
    parser.add_argument("--tensor-parallel", type=int, default=1,
                        help="model-axis size of a 2-D data x model grid of the ranks of "
                             "a launched run; weights shard on their output-feature axis "
                             "(the world size must be divisible)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda:LOCAL_RANK under torchrun); "
                             "never falls back")
    return parser


if __name__ == "__main__":
    main()
