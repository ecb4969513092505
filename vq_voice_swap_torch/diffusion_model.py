"""DiffusionModel: an epsilon-predictor bundled with its diffusion process
(counterpart of ``vq_voice_swap_tpu/diffusion_model.py``; label surgery
comes in a later slice)."""

from typing import Any, Dict, Optional, Tuple, Union

import torch

from .diffusion import Diffusion, make_schedule
from .model_base import ModelBase, register_model
from .models import make_predictor

__all__ = ["DiffusionModel"]


@register_model
class DiffusionModel(ModelBase):
    """The predictor module plus the diffusion process it is sampled with.

    ``dropout`` and ``remat`` are training settings, kept so checkpoints
    round-trip between the packages; this serving port runs neither.
    ``act_int8_min_t`` (int8 activation storage) is not ported.
    """

    def __init__(
        self,
        pred_name: str,
        base_channels: int,
        schedule_name: str = "exp",
        num_labels: Optional[int] = None,
        cond_channels: Optional[int] = None,
        dropout: float = 0.0,
        dtype: Optional[str] = None,
        remat: Union[bool, str] = False,
        act_int8_min_t: int = 0,
    ):
        super().__init__()
        if act_int8_min_t:
            raise NotImplementedError(
                "int8 activation storage is not ported yet"
            )
        self.pred_name = pred_name
        self.base_channels = base_channels
        self.schedule_name = schedule_name
        self.num_labels = num_labels
        self.cond_channels = cond_channels
        self.dropout = dropout
        self.dtype_name = dtype
        self.remat = remat
        self.compute_dtype = getattr(torch, dtype) if dtype else None
        self.predictor = make_predictor(
            pred_name,
            base_channels=base_channels,
            cond_channels=cond_channels,
            num_labels=num_labels,
            dtype=self.compute_dtype,
        )
        self.diffusion = Diffusion(make_schedule(schedule_name))

    def save_kwargs(self) -> Dict[str, Any]:
        return dict(
            pred_name=self.pred_name,
            base_channels=self.base_channels,
            schedule_name=self.schedule_name,
            num_labels=self.num_labels,
            cond_channels=self.cond_channels,
            dropout=self.dropout,
            dtype=self.dtype_name,
            remat=self.remat,
            act_int8_min_t=0,
        )

    @property
    def downsample_rate(self) -> int:
        return self.predictor.downsample_rate

    def predict_eps(
        self,
        x: torch.Tensor,
        ts: torch.Tensor,
        cond: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        return self.predictor(x, ts, cond=cond, labels=labels)

    def losses(
        self,
        x: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        ts: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-element diffusion MSE; returns (losses, ts). ``ts``/``noise``
        are drawn from ``generator`` when not given."""
        if ts is None:
            ts = torch.rand(
                (x.shape[0],), generator=generator, device=x.device
            )
        losses = self.diffusion.ddpm_losses(
            x,
            lambda s, t: self.predict_eps(s, t, labels=labels),
            ts=ts,
            noise=noise,
            generator=generator,
        )
        return losses, ts
