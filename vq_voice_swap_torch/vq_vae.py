"""VQ-VAE with a diffusion decoder, for speaker conversion (counterpart of
``vq_voice_swap_tpu/vq_vae.py``: encode, embed, and decode with the DDPM,
DDIM and DPM++ samplers; classifier-free and encoder-predictor guidance
and the training losses come in later slices)."""

import math
from typing import Any, Dict, Optional

import torch

from .diffusion_model import DiffusionModel
from .model_base import register_model
from .models import make_encoder
from .vq import Codebook, vq_forward

__all__ = ["VQVAE"]


@register_model
class VQVAE(DiffusionModel):
    """A waveform VQ-VAE whose decoder is the diffusion model."""

    def __init__(
        self,
        base_channels: int,
        enc_name: str = "unet",
        cond_mult: int = 16,
        dictionary_size: int = 512,
        dead_rate: int = 100,
        **kwargs: Any,
    ):
        kwargs["cond_channels"] = base_channels * cond_mult
        super().__init__(base_channels=base_channels, **kwargs)
        self.enc_name = enc_name
        self.cond_mult = cond_mult
        self.dictionary_size = dictionary_size
        self.dead_rate = dead_rate
        self.encoder = make_encoder(
            enc_name,
            base_channels=base_channels,
            cond_mult=cond_mult,
            dtype=self.compute_dtype,
        )
        self.vq = Codebook(dictionary_size, self.cond_channels, dead_rate)

    def save_kwargs(self) -> Dict[str, Any]:
        res = super().save_kwargs()
        del res["cond_channels"]  # derived from cond_mult
        res.update(
            enc_name=self.enc_name,
            cond_mult=self.cond_mult,
            dictionary_size=self.dictionary_size,
            dead_rate=self.dead_rate,
        )
        return res

    @property
    def downsample_rate(self) -> int:
        """LCM of the predictor's and the encoder's rates."""
        x, y = self.predictor.downsample_rate, self.encoder.downsample_rate
        return x * y // math.gcd(x, y)

    # -------------------------------------------------------------- compute

    def encode_raw(self, inputs: torch.Tensor) -> torch.Tensor:
        """Encoder output before quantization: [N, T, 1] -> [N, T1, C]."""
        return self.encoder(inputs)

    def encode(self, inputs: torch.Tensor) -> torch.Tensor:
        """Waveform [N, T, 1] -> integer codes [N, T1]."""
        return vq_forward(self.vq.dictionary, self.encode_raw(inputs))["idxs"]

    def embed_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """[N, T1] int codes -> [N, T1, C] codebook embeddings."""
        return self.vq.dictionary[codes]

    def decode(
        self,
        codes: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        steps: int = 100,
        constrain: bool = False,
        sampler: str = "ddpm",
        eta: float = 0.0,
        x_T: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Sample audio [N, T, 1] for codes ([N, T1] ints, or [N, T1, C]
        embeddings as --no-vq passes them) and labels. ``x_T`` is the
        starting noise; when omitted it is drawn from ``generator``, as is
        every later draw of the DDPM (and DDIM eta > 0) sampler."""
        if codes.ndim == 2:
            cond_seq = self.embed_codes(codes)
        elif codes.ndim == 3:
            cond_seq = codes
        else:
            raise ValueError(f"unsupported codes shape: {tuple(codes.shape)}")
        if x_T is None:
            x_len = cond_seq.shape[1] * self.encoder.downsample_rate
            x_T = torch.randn(
                (cond_seq.shape[0], x_len, 1), generator=generator,
                dtype=torch.float32, device=cond_seq.device,
            )

        def pred_fn(xs, ts):
            return self.predict_eps(xs, ts, cond=cond_seq, labels=labels)

        if sampler == "ddim":
            return self.diffusion.ddim_sample(
                x_T, pred_fn, steps, generator=generator, eta=eta,
                constrain=constrain,
            )
        if sampler == "dpmpp":
            return self.diffusion.dpmpp_sample(
                x_T, pred_fn, steps, constrain=constrain
            )
        if sampler != "ddpm":
            raise ValueError(f"unknown sampler {sampler!r}")
        return self.diffusion.ddpm_sample(
            x_T, pred_fn, steps, generator=generator, constrain=constrain
        )
