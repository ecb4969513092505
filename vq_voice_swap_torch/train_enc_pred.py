"""Train an encoder predictor: it predicts a frozen VQ-VAE's codes of a
clip from the clip diffused to a curriculum timestep, and its gradient
guides ``sample_vqvae --enc-pred-path`` (counterpart of the JAX package's
``train_enc_pred.py``; see ``train/loops.py`` for the run directory and
the flags; --grad-checkpoint is taken and, as in the JAX package, not
applied to the encoder predictor). Runs on CUDA unless --device names another device.

Under ``torchrun`` it is one rank of a data-parallel run, with --fsdp and
--tensor-parallel T (see ``train/loops.py``).

Examples:
    python -m vq_voice_swap_torch.train_enc_pred \\
        --vq-vae-path ckpt_vqvae/model.npz tones:40
    python -m vq_voice_swap_torch.train_enc_pred --device cpu --base-channels 4 \\
        --vq-vae-path run/model.npz --batch-size 2 --max-steps 3 tones
"""

from typing import Optional, Sequence

from .train import EncoderPredictorTrainLoop


def main(argv: Optional[Sequence[str]] = None) -> None:
    loop_cls = EncoderPredictorTrainLoop
    loop_cls(loop_cls.arg_parser().parse_args(argv)).loop()


if __name__ == "__main__":
    main()
