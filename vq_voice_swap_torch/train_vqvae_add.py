"""Grow a trained VQ-VAE's label space with new speakers and train only
their label embeddings, everything else frozen (counterpart of the JAX
package's ``train_vqvae_add.py``; see ``train/loops.py`` for the run
directory and the flags). The dataset's labels follow the
pretrained model's; the new rows start standard normal. Runs on CUDA
unless --device names another device.

Under ``torchrun`` it is one rank of a data-parallel run, with --fsdp and
--tensor-parallel T (see ``train/loops.py``).

Examples:
    python -m vq_voice_swap_torch.train_vqvae_add --class-cond \\
        --pretrained-path ckpt_vqvae/model.npz tones:40
    python -m vq_voice_swap_torch.train_vqvae_add --device cpu --class-cond \\
        --pretrained-path run/model.npz --batch-size 2 --max-steps 3 tones
"""

from typing import Optional, Sequence

from .train import VQVAEAddClassesTrainLoop


def main(argv: Optional[Sequence[str]] = None) -> None:
    loop_cls = VQVAEAddClassesTrainLoop
    loop_cls(loop_cls.arg_parser().parse_args(argv)).loop()


if __name__ == "__main__":
    main()
