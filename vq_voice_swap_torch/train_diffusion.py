"""Train an unconditional or class-conditional diffusion model on
waveforms on one device (counterpart of the JAX package's
``train_diffusion.py``; see ``train/loops.py`` for the run directory and
the flags). Runs on CUDA unless --device names another device.

Under ``torchrun`` it is one rank of a data-parallel run, with --fsdp and
--tensor-parallel T (see ``train/loops.py``).

Examples:
    python -m vq_voice_swap_torch.train_diffusion tones
    python -m vq_voice_swap_torch.train_diffusion --class-cond --base-channels 64 \\
        --batch-size 16 --bf16 tones:40
    python -m vq_voice_swap_torch.train_diffusion --device cpu --base-channels 4 \\
        --batch-size 2 --max-steps 3 --save-interval 3 tones
"""

from typing import Optional, Sequence

from .train import DiffusionTrainLoop


def main(argv: Optional[Sequence[str]] = None) -> None:
    DiffusionTrainLoop(DiffusionTrainLoop.arg_parser().parse_args(argv)).loop()


if __name__ == "__main__":
    main()
