"""Train the speaker-conversion VQ-VAE (encoder, VQ codebook, diffusion
decoder) on one device (counterpart of the JAX package's
``train_vqvae.py``; see ``train/loops.py`` for the run directory and the
flags). The codebook's usage counts and the revival of dead codes run in
every step. Runs on CUDA unless --device names another device.

Under ``torchrun`` it is one rank of a data-parallel run, with --fsdp and
--tensor-parallel T (see ``train/loops.py``).

Examples:
    python -m vq_voice_swap_torch.train_vqvae --class-cond tones
    python -m vq_voice_swap_torch.train_vqvae tones:40 --predictor unet \\
        --base-channels 64 --encoder unet128 --class-cond --bf16 \\
        --batch-size 16 --max-steps 1000 --output-dir run_vqvae
    python -m vq_voice_swap_torch.train_vqvae --class-cond --bf16 --batch-size 16 \\
        --steps-per-dispatch 4 --grad-checkpoint=convs --async-save \\
        /data/LibriSpeech/train-clean-100
    python -m vq_voice_swap_torch.train_vqvae --device cpu --base-channels 4 \\
        --batch-size 2 --max-steps 3 --save-interval 3 tones
"""

from typing import Optional, Sequence

from .train import VQVAETrainLoop


def main(argv: Optional[Sequence[str]] = None) -> None:
    VQVAETrainLoop(VQVAETrainLoop.arg_parser().parse_args(argv)).loop()


if __name__ == "__main__":
    main()
