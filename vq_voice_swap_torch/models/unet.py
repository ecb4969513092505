"""1-D UNet epsilon-predictor and encoder (counterpart of
``vq_voice_swap_tpu/models/unet.py``). ``remat``
("full", "convs" or off; see ``layers.remat_policy``) rematerialises every
ResBlock in a training backward, as the JAX package's ``remat`` does.

Public inputs and outputs are channel-last [N, T, C]; the blocks run on
[N, C, T]. ``dtype`` is the compute dtype (None = float32): inputs are cast
to it, parameters stay float32 and are cast per op, and the output is
float32.

``UNetPredictor(fuse_levels=K)`` is the counterpart of the JAX package's
``attic/packed_unet.py::packed_unet_predict(pack_levels=0, fuse_levels=K)``:
the same-resolution ResBlocks of the first K pyramid levels run through
the fused ResBlock kernel pair (``ops/fused_resblock.py``). The TPU layout
trick of that module (packing 64 channels into 128 lanes) has no
counterpart here.

``act_int8_min_t`` > 0 (a serving-only option, as in the JAX package)
stores the activations of every level whose time axis is at least that
long as int8 (``ops/qact.py``): the stem's output is quantized, the
ResBlocks quantize their convolutions' inputs and their outputs, the up
path concatenates the int8 skips with ``qact_concat`` and ``out_norm``
reads int8. A forward with grad enabled or with dropout raises, and so do
``fuse_levels`` (the fused pair is float only) and sequence parallelism.
"""

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops.fused_resblock import fusable, fused_resblock
from ..ops.qact import QAct, qact_concat
from ..parallel.sequence import active_mesh
from .layers import (
    Conv1d,
    Dropout,
    GroupNorm,
    ResBlock,
    TimeEmbedding,
    adaptive_group_count,
    channels_first,
    embedding,
    gelu,
    linear,
    maybe_quantize,
    nearest_resize_1d,
    remat_policy,
)

# Routes of a block in UNetPredictor.forward.
_PLAIN, _FUSED, _FUSED_TWO_INPUTS = "plain", "fused", "fused, two inputs"

__all__ = ["UNetPredictor", "UNetEncoder", "set_remat", "check_int8_forward"]


def set_remat(module: nn.Module, remat: Union[bool, str, None]) -> None:
    """Set every ResBlock under ``module`` to one remat policy."""
    policy = remat_policy(remat)
    for m in module.modules():
        if isinstance(m, ResBlock):
            m.remat = policy


def check_int8_forward(min_t: int, dropout=None) -> None:
    """Refuse what the int8 activation path does not serve: a training
    forward (grad enabled, or dropout) and sequence parallelism."""
    if not min_t:
        return
    if dropout is not None or torch.is_grad_enabled():
        raise ValueError("int8 activation storage is a serving-only knob: run the forward "
                         "under torch.no_grad() and without dropout")
    if active_mesh() is not None:
        raise ValueError("sequence parallelism has no int8 activation path")


class UNetPredictor(nn.Module):
    """The flagship epsilon predictor.

    x: [N, T, in_channels]; ts: [N] in [0, 1]; cond (iff cond_channels):
    [N, T1, cond_channels]; labels (iff num_labels): [N] ints.
    Output: [N, T, out_channels] float32.

    ``fuse_levels`` (a serving option; parameters are the same for every
    value) routes the same-resolution down and up blocks of pyramid levels
    below it, and the middle blocks when the deepest level is below it,
    through the fused ResBlock kernels where their dilation fits the
    kernels' halo. An up block takes its skip as a second input when the
    concat boundary falls on a GroupNorm group edge, else on the
    materialised concat. Resize blocks and the in/out layers never fuse.
    """

    def __init__(
        self,
        base_channels: int,
        channel_mult: Sequence[int] = (1, 1, 2, 2, 2, 4, 4, 8, 8),
        middle_dilations: Sequence[int] = (4, 8, 16, 32),
        depth_mult: int = 2,
        cond_channels: Optional[int] = None,
        num_labels: Optional[int] = None,
        in_channels: int = 1,
        out_channels: int = 1,
        dtype: Optional[torch.dtype] = None,
        fuse_levels: int = 0,
        remat: Union[bool, str, None] = None,
        act_int8_min_t: int = 0,
    ):
        super().__init__()
        if act_int8_min_t and fuse_levels:
            raise ValueError("int8 activation storage does not compose with fuse_levels: "
                             "the fused ResBlock kernels are float only")
        ch = base_channels
        embed_dim = ch * 4
        self.act_int8_min_t = act_int8_min_t
        self.channel_mult = tuple(channel_mult)
        self.depth_mult = depth_mult
        self.cond_channels = cond_channels
        self.num_labels = num_labels
        self.dtype = dtype
        self.fuse_levels = fuse_levels
        last = len(self.channel_mult) - 1

        def route(block: ResBlock, depth: int) -> str:
            return _FUSED if depth < fuse_levels and fusable(block) else _PLAIN

        self.time_embed = TimeEmbedding(embed_dim)
        self.time_embed_extra = nn.Linear(embed_dim, embed_dim)
        if num_labels is not None:
            self.class_embed = nn.Embedding(num_labels, embed_dim)
        if cond_channels is not None:
            self.cond_proj = Conv1d(cond_channels, ch, 3)
        self.in_conv = Conv1d(in_channels, ch, 3)

        skip_chs = [ch]
        cur = ch
        down = []
        self.routes: List[str] = []  # down, middle, up blocks in order
        for depth, mult in enumerate(self.channel_mult):
            for _ in range(depth_mult):
                down.append(ResBlock(cur, mult * ch, embed_dim, act_int8_min_t=act_int8_min_t))
                self.routes.append(route(down[-1], depth))
                cur = mult * ch
                skip_chs.append(cur)
            if depth != last:
                down.append(ResBlock(cur, emb_channels=embed_dim, scale_factor=0.5,
                                     act_int8_min_t=act_int8_min_t))
                self.routes.append(_PLAIN)
                skip_chs.append(cur)
        self.down_blocks = nn.ModuleList(down)

        self.middle_blocks = nn.ModuleList(
            ResBlock(cur, emb_channels=embed_dim, dilation=d, act_int8_min_t=act_int8_min_t)
            for d in middle_dilations
        )
        self.routes += [route(b, last) for b in self.middle_blocks]

        up = []
        for depth, mult in list(enumerate(self.channel_mult))[::-1]:
            for _ in range(depth_mult + 1):
                cin = cur + skip_chs.pop()
                up.append(ResBlock(cin, mult * ch, embed_dim, act_int8_min_t=act_int8_min_t))
                r = route(up[-1], depth)
                if r == _FUSED and cur % (cin // adaptive_group_count(cin)) == 0:
                    r = _FUSED_TWO_INPUTS
                self.routes.append(r)
                cur = mult * ch
            if depth:
                up.append(ResBlock(cur, emb_channels=embed_dim, scale_factor=2.0,
                                   act_int8_min_t=act_int8_min_t))
                self.routes.append(_PLAIN)
        self.up_blocks = nn.ModuleList(up)

        self.out_norm = GroupNorm(cur, use_gelu=True)
        self.out_conv = Conv1d(cur, out_channels, 3)
        set_remat(self, remat)

    @property
    def downsample_rate(self) -> int:
        return 2 ** (len(self.channel_mult) - 1)

    def dropout_shapes(self, n: int, t: int) -> List[Tuple[int, int, int]]:
        """The [N, C, T] shape of each ResBlock's dropout keep-mask, in call
        order, for an input of n x t samples."""
        shapes = []
        for b in (*self.down_blocks, *self.middle_blocks, *self.up_blocks):
            t = b.out_length(t)
            shapes.append((n, b.out_channels, t))
        return shapes

    def forward(
        self,
        x: torch.Tensor,
        ts: torch.Tensor,
        cond: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        dropout: Optional[Dropout] = None,
    ) -> torch.Tensor:
        """``dropout`` (a training forward's draws) runs in every block,
        which must then all be unfused."""
        if (labels is None) != (self.num_labels is None):
            raise ValueError("pass labels iff the model is class-conditional")
        if (cond is None) != (self.cond_channels is None):
            raise ValueError("pass a cond sequence iff the model is conditional")
        if dropout is not None and self.fuse_levels:
            raise ValueError("dropout runs only unfused (fuse_levels=0)")
        check_int8_forward(self.act_int8_min_t, dropout)
        dtype = self.dtype or torch.float32

        emb = linear(gelu(self.time_embed(ts, dtype)), self.time_embed_extra)
        if labels is not None:
            emb = emb + embedding(labels, self.class_embed).to(dtype)

        h = self.in_conv(channels_first(x, dtype))
        if cond is not None:
            c = self.cond_proj(channels_first(cond, dtype))
            h = h + nearest_resize_1d(c, h.shape[-1])
        h = maybe_quantize(h, self.act_int8_min_t)

        def run(b: ResBlock, r: str, h: torch.Tensor) -> torch.Tensor:
            return b(h, emb, dropout) if r == _PLAIN else fused_resblock(b, h, emb)

        routes = iter(self.routes)
        skips = [h]
        for b in self.down_blocks:
            h = run(b, next(routes), h)
            skips.append(h)
        for b in self.middle_blocks:
            h = run(b, next(routes), h)
        for i, b in enumerate(self.up_blocks):
            r = next(routes)
            # Upsampling blocks (every depth_mult+2-th) take no skip concat.
            if i % (self.depth_mult + 2) == self.depth_mult + 1:
                h = run(b, r, h)
            elif r == _FUSED_TWO_INPUTS:
                h = fused_resblock(b, h, emb, x2=skips.pop())
            else:
                h = run(b, r, _concat(h, skips.pop()))

        h = self.out_conv(self.out_norm(h))
        return h.transpose(1, 2).float()


def _concat(h, s):
    """The up path's channel concat of h and a skip: both int8 or both
    float (the time axis decides the quantization, and concat partners
    share it)."""
    if isinstance(h, QAct) != isinstance(s, QAct):
        raise ValueError("a skip concat mixes int8 and float activations")
    if isinstance(h, QAct):
        return qact_concat(h, s)
    return torch.cat([h, s], dim=1)


class UNetEncoder(nn.Module):
    """Down-only UNet stack used as a VQ-VAE encoder, with optional
    trailing dilated blocks. x: [N, T, in_channels] -> [N, T1, out_channels].
    ``act_int8_min_t`` as in ``UNetPredictor``."""

    def __init__(
        self,
        base_channels: int,
        channel_mult: Sequence[int] = (1, 1, 2, 2, 2, 4, 4, 8, 8),
        out_dilations: Sequence[int] = (),
        depth_mult: int = 2,
        in_channels: int = 1,
        out_channels: int = 512,
        dtype: Optional[torch.dtype] = None,
        remat: Union[bool, str, None] = None,
        act_int8_min_t: int = 0,
    ):
        super().__init__()
        ch = base_channels
        self.channel_mult = tuple(channel_mult)
        self.dtype = dtype
        self.act_int8_min_t = act_int8_min_t
        self.in_conv = Conv1d(in_channels, ch, 3)
        blocks = []
        cur = ch
        q = dict(act_int8_min_t=act_int8_min_t)
        for depth, mult in enumerate(self.channel_mult):
            for _ in range(depth_mult):
                blocks.append(ResBlock(cur, mult * ch, **q))
                cur = mult * ch
            if depth != len(self.channel_mult) - 1:
                blocks.append(ResBlock(cur, scale_factor=0.5, **q))
        for d in out_dilations:
            blocks.append(ResBlock(cur, dilation=d, **q))
        self.blocks = nn.ModuleList(blocks)
        self.out_norm = GroupNorm(cur, use_gelu=True)
        self.out_conv = Conv1d(cur, out_channels, 3)
        set_remat(self, remat)

    @property
    def downsample_rate(self) -> int:
        return 2 ** (len(self.channel_mult) - 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_int8_forward(self.act_int8_min_t)
        h = self.in_conv(channels_first(x, self.dtype or torch.float32))
        h = maybe_quantize(h, self.act_int8_min_t)
        for b in self.blocks:
            h = b(h)
        h = self.out_conv(self.out_norm(h))
        return h.transpose(1, 2).float()
