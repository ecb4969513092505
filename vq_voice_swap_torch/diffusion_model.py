"""DiffusionModel: an epsilon-predictor bundled with its diffusion process
(counterpart of ``vq_voice_swap_tpu/diffusion_model.py``), with the label
surgery that grows a class-conditional model's label space."""

import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from .diffusion import Diffusion, make_schedule
from .model_base import ModelBase, register_model
from .models import make_predictor
from .models.layers import Dropout, draw_keep_mask
from .models.unet import set_remat
from .observe import span

__all__ = ["DiffusionModel", "add_labels_to_params", "label_param_paths"]

# Parameter names that end in a per-label embedding table.
_LABEL_LEAF_SUFFIXES = ("class_embed.weight",  # UNetPredictor
                        "label_emb.weight")  # WaveGrad FiLM layers


def label_param_paths(names: Iterable[str]) -> List[str]:
    """The label-embedding tables among parameter names (flax
    ``class_embed/embedding`` and ``label_emb/embedding``)."""
    return [n for n in names
            if any(n == s or n.endswith("." + s) for s in _LABEL_LEAF_SUFFIXES)]


def add_labels_to_params(
    state: Dict[str, torch.Tensor],
    n: int,
    end: bool = True,
    generator: Optional[torch.Generator] = None,
    new_rows: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Grow every label-embedding table of a state dict by n rows, after the
    existing rows (end=True) or before them (end=False). The new rows are
    ``new_rows[name]`` where given, else standard normal from ``generator``
    (a CPU generator), which defaults to fresh OS entropy, as the JAX
    package's does: two surgeries must not give two new speakers the same
    rows."""
    targets = label_param_paths(state)
    if not targets:
        raise ValueError("model has no label embeddings to grow")
    if generator is None:
        generator = torch.Generator().manual_seed(int.from_bytes(os.urandom(8), "little") >> 1)
    out = dict(state)
    for name in targets:
        table = state[name]
        if new_rows is not None:
            rows = new_rows[name]
        else:
            rows = torch.randn((n, table.shape[-1]), generator=generator, dtype=table.dtype)
        rows = rows.to(table.device, table.dtype)
        out[name] = torch.cat([table, rows] if end else [rows, table])
    return out


@register_model
class DiffusionModel(ModelBase):
    """The predictor module plus the diffusion process it is sampled with.

    ``dropout`` is the predictor's dropout rate in a training forward
    (``train=True``). ``remat`` rematerialises the UNet ResBlocks in a
    training backward ("full" or "convs", ``models.layers.remat_policy``).
    ``act_int8_min_t`` > 0 serves the UNet predictor with int8-stored
    activations at the levels whose time axis is at least that long
    (``ops/qact.py``); saved with the kwargs, as the JAX package saves it,
    and overridden at load time (``ModelBase.load``). A training forward
    of such a model raises. ``fuse_levels`` is a serving option of the
    UNet predictor (see ``UNetPredictor``), set at load time and never
    saved.
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
        fuse_levels: int = 0,
    ):
        super().__init__()
        self.pred_name = pred_name
        self.base_channels = base_channels
        self.schedule_name = schedule_name
        self.num_labels = num_labels
        self.cond_channels = cond_channels
        self.dropout = dropout
        self.dtype_name = dtype
        self.remat = remat
        self.act_int8_min_t = act_int8_min_t
        self.compute_dtype = getattr(torch, dtype) if dtype else None
        self.predictor = make_predictor(
            pred_name,
            base_channels=base_channels,
            cond_channels=cond_channels,
            num_labels=num_labels,
            dropout=dropout,
            dtype=self.compute_dtype,
            fuse_levels=fuse_levels,
            remat=remat,
            act_int8_min_t=act_int8_min_t,
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
            act_int8_min_t=self.act_int8_min_t,
        )

    @property
    def downsample_rate(self) -> int:
        return self.predictor.downsample_rate

    def set_remat(self, remat: Union[bool, str, None]) -> None:
        """Switch the UNet ResBlocks' remat policy (a training setting,
        saved with the kwargs like the JAX package's ``remat``)."""
        set_remat(self, remat)  # raises on an unknown policy
        self.remat = remat or False

    def dropout_draws(self, n: int, t: int, generator: Optional[torch.Generator], device,
                      train: bool) -> Optional[List[torch.Tensor]]:
        """The keep-masks a training forward of n x t samples draws, in
        ResBlock call order (None without dropout)."""
        if not (train and self.dropout):
            return None
        keep_prob = 1.0 - self.dropout
        return [draw_keep_mask(shape, keep_prob, generator, device)
                for shape in self.predictor.dropout_shapes(n, t)]

    def loss_draws(self, x: torch.Tensor, generator: Optional[torch.Generator],
                   train: bool = False) -> Dict[str, Any]:
        """Every random draw of ``losses(x, ...)``, in the order and shapes
        it draws them: ``ts``, ``noise``, then the dropout masks."""
        n = x.shape[0]
        draws: Dict[str, Any] = {
            "ts": torch.rand((n,), generator=generator, device=x.device),
            "noise": torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device),
        }
        masks = self.dropout_draws(n, x.shape[1], generator, x.device, train)
        if masks is not None:
            draws["dropout_masks"] = masks
        return draws

    def predict_eps(
        self,
        x: torch.Tensor,
        ts: torch.Tensor,
        cond: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """A training forward (``train``) of a model with dropout draws its
        masks from ``generator``, or takes ``dropout_masks`` (one bool
        keep-mask per ResBlock, [N, C, T], in call order)."""
        dropout = None
        if train and self.dropout:
            dropout = Dropout(self.dropout, generator, dropout_masks)
        with span("vvs.predict"):
            return self.predictor(x, ts, cond=cond, labels=labels, dropout=dropout)

    def losses(
        self,
        x: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        ts: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        train: bool = False,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-element diffusion MSE; returns (losses, ts). ``ts``, ``noise``
        and, in a training forward, the dropout masks are drawn from
        ``generator`` when not given."""
        if ts is None:
            ts = torch.rand(
                (x.shape[0],), generator=generator, device=x.device
            )
        losses = self.diffusion.ddpm_losses(
            x,
            lambda s, t: self.predict_eps(s, t, labels=labels, train=train,
                                          generator=generator,
                                          dropout_masks=dropout_masks),
            ts=ts,
            noise=noise,
            generator=generator,
        )
        return losses, ts

    # ------------------------------------------------------- label surgery

    def add_labels(
        self,
        n: int,
        end: bool = True,
        generator: Optional[torch.Generator] = None,
        new_rows: Optional[Dict[str, torch.Tensor]] = None,
    ) -> "DiffusionModel":
        """A copy of this class-conditional model with n more labels, its
        label tables grown by ``add_labels_to_params``, on the same device."""
        if self.num_labels is None:
            raise ValueError("model must be class-conditional")
        kwargs = self.save_kwargs()
        kwargs["num_labels"] = self.num_labels + n
        grown = type(self)(**kwargs)
        grown.load_state_dict(add_labels_to_params(self.state_dict(), n, end=end,
                                                   generator=generator, new_rows=new_rows))
        return grown.to(next(self.parameters()).device)

    def label_parameter_paths(self) -> List[str]:
        """The names of the predictor's label-embedding tables."""
        return label_param_paths(name for name, _ in self.named_parameters())
