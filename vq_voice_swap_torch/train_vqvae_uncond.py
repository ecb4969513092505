"""Fine-tune a trained VQ-VAE for classifier-free guidance (counterpart of
the JAX package's ``train_vqvae_uncond.py``; see ``train/loops.py`` for the
run directory and the flags): labels move up by one, and each
row's label drops to the new unconditional label 0 with probability
--no-class-prob and its codes to zero with probability --no-vq-prob.
Sample with ``sample_vqvae_uncond`` afterwards. Runs on CUDA unless
--device names another device.

Under ``torchrun`` it is one rank of a data-parallel run, with --fsdp and
--tensor-parallel T (see ``train/loops.py``).

Examples:
    python -m vq_voice_swap_torch.train_vqvae_uncond --class-cond \\
        --no-class-prob 0.1 --no-vq-prob 0.1 \\
        --pretrained-path ckpt_vqvae/model.npz tones:40
    python -m vq_voice_swap_torch.train_vqvae_uncond --device cpu --class-cond \\
        --pretrained-path run/model.npz --batch-size 2 --max-steps 3 tones
"""

from typing import Optional, Sequence

from .train import VQVAEUncondTrainLoop


def main(argv: Optional[Sequence[str]] = None) -> None:
    loop_cls = VQVAEUncondTrainLoop
    loop_cls(loop_cls.arg_parser().parse_args(argv)).loop()


if __name__ == "__main__":
    main()
