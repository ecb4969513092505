"""The guidance networks as saveable models (counterpart of
``vq_voice_swap_tpu/classifier_model.py``): ``ClassifierModel``, the
noised-audio speaker classifier of classifier guidance, and
``EncoderPredictorModel``, the VQ-code predictor of encoder-predictor
guidance. Each is its module and a ``ModelBase`` at once, so its
parameters sit at the JAX checkpoint's paths (``stem/...``, ``head/...``;
``unet/...``, ``out_proj/...``).

``load`` returns a frozen model (``requires_grad_(False)``) unless asked
for a trainable one (``frozen=False``, as the train loops resume): guidance
differentiates it with respect to its input only, so its GroupNorms take
the backward kernel for dx alone. It always loads unfused, since the fused
ResBlock pair has no backward. ``ClassifierModel.load_from_predictor``
warm-starts a classifier's stem from a diffusion predictor's down path.
"""

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from .diffusion.process import CondFn, input_grad
from .model_base import ModelBase, register_model
from .models.classifier import Classifier
from .models.encoder_predictor import EncoderPredictor

__all__ = ["ClassifierModel", "EncoderPredictorModel"]

_CHANNEL_MULT = (1, 1, 2, 2, 2, 4, 4, 8, 8)


class _GuidanceModel(ModelBase):
    """Loads frozen unless ``frozen=False``; always unfused."""

    @classmethod
    def load(cls, path: str, dtype: Optional[str] = None, device=None,
             frozen: bool = True) -> "ModelBase":
        return super().load(path, dtype=dtype, device=device, frozen=frozen)


@register_model
class ClassifierModel(Classifier, _GuidanceModel):
    """Noised-audio speaker classifier: ``self(x, ts)`` gives [N, num_labels]
    float32 logits for x [N, T, 1] and ts [N]."""

    def __init__(
        self,
        num_labels: int,
        base_channels: int = 32,
        channel_mult: Sequence[int] = _CHANNEL_MULT,
        output_mult: int = 16,
        depth_mult: int = 2,
        dtype: Optional[str] = None,
    ):
        super().__init__(num_labels, base_channels, tuple(channel_mult), output_mult,
                         depth_mult, getattr(torch, dtype) if dtype else None)
        self.num_labels = num_labels
        self.base_channels = base_channels
        self.channel_mult = tuple(channel_mult)
        self.output_mult = output_mult
        self.depth_mult = depth_mult
        self.dtype_name = dtype

    def save_kwargs(self) -> Dict[str, Any]:
        return dict(
            num_labels=self.num_labels,
            base_channels=self.base_channels,
            channel_mult=list(self.channel_mult),
            output_mult=self.output_mult,
            depth_mult=self.depth_mult,
            dtype=self.dtype_name,
        )

    def load_from_predictor(self, predictor: torch.nn.Module) -> int:
        """Warm-start the stem from a UNet predictor's down path (the JAX
        package's ``load_from_predictor``): its ``in_conv``, ``time_embed``
        and ``time_embed_extra``, and ``down_blocks.i`` as ``block.i`` while
        the stem has that block. A shape that differs raises. Returns the
        number of scalars copied."""
        dst = self.state_dict()
        copied = {}
        for name, value in predictor.state_dict().items():
            head, _, rest = name.partition(".")
            if head in ("in_conv", "time_embed", "time_embed_extra"):
                path = f"stem.{name}"
            elif head == "down_blocks":
                path = f"stem.block.{rest}"
            else:
                continue
            if path not in dst:
                continue  # the predictor's down path is longer than the stem
            if value.shape != dst[path].shape:
                raise ValueError(
                    f"predictor parameter {path} has shape {tuple(value.shape)} but the "
                    f"classifier stem expects {tuple(dst[path].shape)}; do the "
                    f"--base-channels/--channel-mult match the pretrained predictor?")
            copied[path] = value
        self.load_state_dict(copied, strict=False)
        return sum(v.numel() for v in copied.values())

    def cond_fn(self, labels: torch.Tensor, scale: float) -> CondFn:
        """Classifier guidance: scale * d/dx sum_i log p(labels_i | x_i, t)
        (the JAX package's ``sample_diffusion.py`` cond_fn)."""

        def cond_fn(x: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
            def logprob_sum(xx: torch.Tensor) -> torch.Tensor:
                logp = F.log_softmax(self(xx, ts), dim=-1)
                return torch.gather(logp, -1, labels[:, None]).sum()

            return input_grad(logprob_sum, x) * scale

        return cond_fn


@register_model
class EncoderPredictorModel(EncoderPredictor, _GuidanceModel):
    """Guidance model predicting a clip's VQ codes from noised audio:
    ``self(x, ts)`` gives [N, T // downsample_rate, num_latents] logits."""

    def __init__(
        self,
        base_channels: int,
        downsample_rate: int,
        num_latents: int,
        bottleneck_dim: int = 64,
        channel_mult: Sequence[int] = _CHANNEL_MULT,
        depth_mult: int = 2,
        dtype: Optional[str] = None,
    ):
        super().__init__(base_channels, downsample_rate, num_latents, bottleneck_dim,
                         tuple(channel_mult), depth_mult,
                         getattr(torch, dtype) if dtype else None)
        self.base_channels = base_channels
        self.num_latents = num_latents
        self.bottleneck_dim = bottleneck_dim
        self.channel_mult = tuple(channel_mult)
        self.depth_mult = depth_mult
        self.dtype_name = dtype

    def save_kwargs(self) -> Dict[str, Any]:
        return dict(
            base_channels=self.base_channels,
            downsample_rate=self.downsample_rate,
            num_latents=self.num_latents,
            bottleneck_dim=self.bottleneck_dim,
            channel_mult=list(self.channel_mult),
            depth_mult=self.depth_mult,
            dtype=self.dtype_name,
        )

    def cond_fn(self, targets: torch.Tensor, scale: float) -> CondFn:
        """Encoder-predictor guidance: -scale * d/dx of the summed
        cross-entropy against targets [N, T1] (the JAX package's
        ``VQVAE.decode`` cond_fn)."""

        def cond_fn(x: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
            def total_loss(xx: torch.Tensor) -> torch.Tensor:
                return torch.sum(self.losses(xx, ts, targets) * targets.shape[-1])

            return -scale * input_grad(total_loss, x)

        return cond_fn
