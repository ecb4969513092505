"""Train the noised-audio speaker classifier of classifier guidance
(counterpart of the JAX package's ``train_classifier.py``; see
``train/loops.py`` for the run directory and the flags; --grad-checkpoint
is taken and, as in the JAX package, not applied to the classifier). Clips
are diffused to timesteps u ** power, the power annealed from
--curriculum-start to 1 over --curriculum-steps. --pretrained-path
warm-starts the stem from a diffusion model's UNet down path. Runs on
CUDA unless --device names another device.

Under ``torchrun`` it is one rank of a data-parallel run, with --fsdp and
--tensor-parallel T (see ``train/loops.py``).

Examples:
    python -m vq_voice_swap_torch.train_classifier --curriculum-start 30 \\
        --curriculum-steps 50000 tones:40
    python -m vq_voice_swap_torch.train_classifier --device cpu --base-channels 4 \\
        --batch-size 2 --max-steps 3 tones
"""

from typing import Optional, Sequence

from .train import ClassifierTrainLoop


def main(argv: Optional[Sequence[str]] = None) -> None:
    loop_cls = ClassifierTrainLoop
    loop_cls(loop_cls.arg_parser().parse_args(argv)).loop()


if __name__ == "__main__":
    main()
