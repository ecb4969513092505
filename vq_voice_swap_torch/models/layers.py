"""Shared building blocks of the 1-D audio models, on [N, C, T] activations.

Counterpart of ``vq_voice_swap_tpu/models/layers.py``. Submodules carry
the flax names (``conv``, ``norm``, ``proj``, ``cond_proj``, ...) so
checkpoints map by rule
(``convert/from_jax.py``). Parameters stay float32; a module computes in
its input's dtype and casts each parameter per op, as flax does with a
compute ``dtype``. GroupNorm statistics are float32 whatever the dtype.

``conv1d`` runs a bf16 convolution on the card that autograd does not
record (the serving forward) through the hand-written kernel of
``ops/conv1d.py`` where its shape fits (``routes``), with the bias in its
epilogue; every other convolution runs ``F.conv1d`` (cuDNN on the card).

A ResBlock's ``remat`` policy (the counterpart of the JAX package's
``remat``, ``vq_voice_swap_tpu/models/unet.py:38-63``) rematerialises it in
a training backward: "full" saves the block's inputs alone and reruns the
block; "convs" also saves ``conv_in``'s output and reruns only the norm,
GELU and FiLM chains, never a convolution.

Under tensor parallelism (``parallel/tensor.py``) the funnels ``conv1d``
and ``linear`` run a layer whose weight was cut over the model group
column-parallel, and ``GroupNorm`` and ``embedding`` gather their cut
leaves whole at use; a model that was not cut runs as before. Under
sequence parallelism (``parallel/sequence.py``'s ``sequence_parallel``)
the activations are shards of the time axis: ``conv1d`` exchanges halos
with the neighbouring ranks, ``GroupNorm`` merges its statistics over
them and ``nearest_resize_1d`` repeats within the shard; pooling and
upsampling are shard-local as they are.

int8 activation storage (``ResBlock(act_int8_min_t=M)``, a serving-only
option): a ResBlock quantizes (``ops/qact.py``) the inputs of its
convolutions and its output where their time axis is at least M long, as
the JAX package's ``_maybe_quantize`` does; ``conv1d``/``Conv1d`` and
``GroupNorm`` take such a ``QAct`` and run the int8 convolution and the
int8 GroupNorm kernels, pooling and upsampling stay int8. A GroupNorm
output or a residual sum that is stored as int8 is never written in
float: the quantize kernels recompute it from its inputs
(``GroupNorm.quantized``, ``quantize_residual``). The int8 convolution goes through
the same column-parallel funnel under tensor parallelism; sequence
parallelism has no int8 path (the models refuse it).
"""

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.conv1d import conv1d_bf16, routes
from ..ops.group_norm import group_norm, group_norm_coeffs, group_norm_coeffs_int8
from ..ops.qact import (QAct, conv1d_int8, dequantize, qact_avg_pool, qact_group_norm,
                        qact_upsample, quantize, quantize_group_norm, quantize_residual)
from ..parallel.sequence import (active_mesh, seq_sharded_conv1d, seq_sharded_group_norm,
                                 seq_sharded_resize)
from ..parallel.tensor import column_parallel, cut_axis, whole

__all__ = [
    "gelu",
    "adaptive_group_count",
    "channels_first",
    "conv1d",
    "embedding",
    "linear",
    "Conv1d",
    "GroupNorm",
    "sinusoidal_time_features",
    "TimeEmbedding",
    "avg_pool_1d",
    "nearest_upsample_1d",
    "nearest_resize_1d",
    "ResBlock",
    "Dropout",
    "remat_policy",
    "maybe_quantize",
]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU."""
    return F.gelu(x)


def adaptive_group_count(ch: int, max_groups: int = 32) -> int:
    """Largest power-of-two group count <= max_groups dividing ch."""
    g = max_groups
    while ch % g:
        g //= 2
    return g


def channels_first(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[N, T, C] -> contiguous [N, C, T] in dtype. Always a copy: with C=1
    a transposed view passes is_contiguous(), yet conv1d then returns a
    channels-last result, which the GroupNorm kernels do not take."""
    return x.to(dtype).transpose(1, 2).clone(memory_format=torch.contiguous_format)


def conv1d(x: Union[torch.Tensor, QAct], conv: nn.Conv1d) -> torch.Tensor:
    """Run ``conv`` on [N, C, T] in x's dtype (column-parallel when its
    weight was cut over the model group; on a time shard with its halos
    under sequence parallelism). A ``QAct`` runs the int8 convolution, its
    output in the activation's compute dtype."""
    mesh = active_mesh()
    if isinstance(x, QAct):
        if mesh is not None:
            raise ValueError("sequence parallelism has no int8 activation path")

        def run_int8(q):
            return conv1d_int8(QAct(q, x.scale, x.dtype), conv.weight, conv.bias,
                               stride=conv.stride[0], dilation=conv.dilation[0], conv=conv)

        if cut_axis(conv, "weight") is not None:
            return column_parallel(run_int8, x.q, 1)
        return run_int8(x.q)
    if mesh is not None:
        if cut_axis(conv, "weight") is not None:
            raise ValueError("sequence parallelism does not compose with tensor parallelism")
        return seq_sharded_conv1d(mesh, x, conv.weight, conv.bias, stride=conv.stride[0],
                                  dilation=conv.dilation[0])

    def run(x):
        w, b = conv.weight, conv.bias
        recording = torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad or (b is not None and b.requires_grad))
        if routes(x.device.type, x.dtype, recording, x.shape,
                  x.is_contiguous() and x.data_ptr() % 16 == 0, conv):
            return conv1d_bf16(x, w, b, conv.dilation[0], conv)
        bias = None if b is None else b.to(x.dtype)
        return F.conv1d(
            x, conv.weight.to(x.dtype), bias, stride=conv.stride,
            padding=conv.padding, dilation=conv.dilation,
        )

    if cut_axis(conv, "weight") is not None:
        return column_parallel(run, x, 1)
    return run(x)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """Run ``lin`` in x's dtype (column-parallel when its weight was cut
    over the model group)."""
    def run(x):
        return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))

    if cut_axis(lin, "weight") is not None:
        return column_parallel(run, x, -1)
    return run(x)


def embedding(labels: torch.Tensor, table: nn.Embedding) -> torch.Tensor:
    """Look ``labels`` up in ``table`` (its columns gathered whole at use
    when they were cut over the model group)."""
    return F.embedding(labels, whole(table, "weight"))


class Conv1d(nn.Module):
    """1-D convolution with 'SAME'-style padding (k-1)*dilation//2."""

    def __init__(
        self, in_channels: int, features: int, kernel_size: int = 3,
        dilation: int = 1,
    ):
        super().__init__()
        self.conv = nn.Conv1d(
            in_channels, features, kernel_size, dilation=dilation,
            padding=(kernel_size - 1) * dilation // 2,
        )

    def forward(self, x: Union[torch.Tensor, QAct]) -> torch.Tensor:
        return conv1d(x, self.conv)


class GroupNorm(nn.Module):
    """GroupNorm over the channels of [N, C, T] with the adaptive group
    count, eps 1e-5, float32 statistics, optionally followed by a FiLM
    h*(ca+1)+cb and exact GELU — all one stats and one apply kernel on the
    card (ops/group_norm.py). With grad enabled and an input that requires
    it, the card runs it through ``GroupNormFunction``, whose backward is
    the hand-written backward kernel. A ``QAct`` input (no FiLM) runs the
    int8 GroupNorm kernels, its output in the activation's compute dtype.
    ``norm`` holds the affine weight and bias."""

    def __init__(
        self, channels: int, max_groups: int = 32, eps: float = 1e-5,
        use_gelu: bool = False,
    ):
        super().__init__()
        self.norm = nn.GroupNorm(
            adaptive_group_count(channels, max_groups), channels, eps=eps
        )
        self.use_gelu = use_gelu

    def forward(
        self,
        x: Union[torch.Tensor, QAct],
        film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        if isinstance(x, QAct):
            if film is not None:
                raise ValueError("the int8 GroupNorm takes no FiLM")
            return qact_group_norm(x, whole(self.norm, "weight"), whole(self.norm, "bias"),
                                   self.norm.num_groups, self.norm.eps, self.use_gelu)
        mesh = active_mesh()
        if mesh is not None:
            return seq_sharded_group_norm(mesh, x, whole(self.norm, "weight"),
                                          whole(self.norm, "bias"), self.norm.num_groups,
                                          self.norm.eps, self.use_gelu, film)
        return group_norm(
            x, whole(self.norm, "weight"), whole(self.norm, "bias"), self.norm.num_groups,
            self.norm.eps, self.use_gelu, film,
        )

    def quantized(
        self,
        x: Union[torch.Tensor, QAct],
        film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> QAct:
        """The forward's output stored as int8: the statistics kernel, then
        ``quantize_group_norm``, whose passes recompute the apply, so the
        float output is never written. The int8 serving path only (no
        sequence parallelism)."""
        w, b = whole(self.norm, "weight"), whole(self.norm, "bias")
        groups, eps = self.norm.num_groups, self.norm.eps
        if isinstance(x, QAct):
            if film is not None:
                raise ValueError("the int8 GroupNorm takes no FiLM")
            coeffs = group_norm_coeffs_int8(x.q, x.scale, groups, w, b, eps)
        else:
            coeffs = group_norm_coeffs(x, groups, w, b, eps, film)
        return quantize_group_norm(x, *coeffs, self.use_gelu)


def sinusoidal_time_features(ts: torch.Tensor, channels: int) -> torch.Tensor:
    """[N] ts in [0, 1] -> [N, channels] cos/sin features with frequencies
    geometric in [0.1, 100]."""
    if channels % 2:
        raise ValueError("time-embedding channels must be even")
    half = channels // 2
    min_coeff, max_coeff = 0.1, 100.0
    exponents = torch.arange(half, dtype=torch.float32, device=ts.device) / (
        half - 1
    )
    freqs = max_coeff * torch.exp(-math.log(max_coeff / min_coeff) * exponents)
    args = ts.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimeEmbedding(nn.Module):
    """Sinusoidal timestep features followed by a linear projection."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        self.proj = nn.Linear(channels, channels)

    def forward(self, ts: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        emb = sinusoidal_time_features(ts, self.channels).to(dtype)
        return linear(emb, self.proj)


def avg_pool_1d(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Non-overlapping average pooling over the T axis of [N, C, T]."""
    n, c, t = x.shape
    if t % factor:
        raise ValueError(f"length {t} not divisible by pool factor {factor}")
    return x.reshape(n, c, t // factor, factor).mean(dim=-1)


def nearest_upsample_1d(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsampling over the T axis of [N, C, T]."""
    return torch.repeat_interleave(x, factor, dim=-1)


def nearest_resize_1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Nearest-neighbour resize of [N, C, T] to [N, C, out_len], with the
    source index floor(i * (T / out_len)) computed in float32 as the JAX
    package computes it. Under sequence parallelism, a per-shard repeat
    (an integer factor)."""
    mesh = active_mesh()
    if mesh is not None:
        return seq_sharded_resize(mesh, x, out_len)
    t = x.shape[-1]
    if t == out_len:
        return x
    pos = torch.arange(out_len, dtype=torch.float32, device=x.device) * (
        t / out_len
    )
    return torch.index_select(x, -1, torch.floor(pos).long())


def maybe_quantize(h: torch.Tensor, min_t: int) -> Union[torch.Tensor, QAct]:
    """h stored as int8 (``quantize``) when int8 storage is on (min_t > 0)
    and h's time axis is at least min_t long; else h."""
    return quantize(h) if min_t and h.shape[-1] >= min_t else h


class Dropout:
    """The dropout of one training forward, in ResBlock call order: each
    call keeps an element where its uniform draw from ``generator`` is
    below 1 - rate (as flax's ``nn.Dropout`` keeps it) and scales the kept
    ones by 1 / (1 - rate). ``masks`` (bool keep-masks of each call's
    shape, in call order) replace the draws."""

    def __init__(self, rate: float, generator: Optional[torch.Generator] = None,
                 masks: Optional[Sequence[torch.Tensor]] = None):
        if not 0.0 < rate < 1.0:
            raise ValueError(f"dropout rate must be in (0, 1), got {rate}")
        self.keep_prob = 1.0 - rate
        self.generator = generator
        self.masks = None if masks is None else iter(masks)

    def keep_mask(self, shape: Sequence[int], device) -> torch.Tensor:
        """The next call's bool keep-mask: the next of ``masks``, or drawn."""
        if self.masks is not None:
            return next(self.masks).to(device)
        return draw_keep_mask(shape, self.keep_prob, self.generator, device)

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        return apply_keep_mask(h, self.keep_mask(h.shape, h.device), self.keep_prob)


def draw_keep_mask(shape: Sequence[int], keep_prob: float,
                   generator: Optional[torch.Generator], device) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, device=device) < keep_prob


def apply_keep_mask(h: torch.Tensor, keep: torch.Tensor, keep_prob: float) -> torch.Tensor:
    return torch.where(keep, h / keep_prob, torch.zeros_like(h))


def remat_policy(remat: Union[bool, str, None]) -> Optional[str]:
    """The rematerialisation policy a ``remat`` setting names: None (off),
    "full" (True or "full") or "convs"; a ValueError on anything else, so a
    typo does not fall back to another policy."""
    if not remat:
        return None
    if remat is True or remat == "full":
        return "full"
    if remat == "convs":
        return "convs"
    raise ValueError(f"unknown remat policy {remat!r}; expected True/'full' or 'convs'")


def _save_first_conv():
    """Selective-checkpoint contexts that save the region's first
    convolution's output (``conv_in``) and recompute every other op. The
    kernels' output buffers (``torch.empty``) are recomputed too, so a
    recomputed GroupNorm writes fresh statistics into fresh buffers."""
    seen = {False: 0, True: 0}

    def policy(ctx, op, *args, **kwargs):
        if op is torch.ops.aten.convolution.default:
            first = seen[ctx.is_recompute] == 0
            seen[ctx.is_recompute] += 1
            if first:
                return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


class ResBlock(nn.Module):
    """The UNet residual block: [GroupNorm+GELU, resize, conv3, GroupNorm]
    -> optional FiLM h*(a+1)+b from an embedding -> [GELU, dilated conv3];
    the skip path resizes and 1x1-projects when channels change.
    scale_factor 1.0 = identity, 0.5 = avg-pool x2, 2.0 = nearest x2 up.

    ``norm_mid`` carries the GELU that follows the FiLM, so norm, FiLM and
    GELU are one apply kernel; a training forward's ``Dropout`` follows it,
    before ``conv_out``. Its keep-mask is taken before the block runs, so a
    rematerialised block reruns with the same mask.

    ``act_int8_min_t`` > 0 stores the inputs of ``conv_in`` and
    ``conv_out`` and the block output as int8 (``QAct``) where their time
    axis is at least that long (JAX ``ResBlock._maybe_quantize``); the
    quantization of ``conv_out``'s input follows ``norm_mid``'s apply, which
    carries the FiLM and GELU. The block then takes a ``QAct`` input too. A
    serving-only option: a forward with dropout raises. A quantized value
    whose producer is a GroupNorm (``norm_in`` with no avg pool after it,
    ``norm_mid``) or the residual add is quantized by kernels that
    recompute it, so it is never written in float; after a nearest
    upsample, ``norm_in``'s output is quantized first and its codes are
    repeated (the amax and the codes commute with the repetition).

    ``remat`` ("full", "convs" or None, see ``remat_policy``) applies when
    grad is enabled. "convs" checkpoints the main path alone: in the
    port's models the skip path's 1x1 projection exists only where the
    block keeps its length, so its input is the block input that the
    checkpoint saves anyway; the backward's recompute stops when it has
    rebuilt ``conv_out``'s input, before that convolution runs.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        emb_channels: Optional[int] = None,
        scale_factor: float = 1.0,
        dilation: int = 2,
        remat: Union[bool, str, None] = None,
        act_int8_min_t: int = 0,
    ):
        super().__init__()
        out_ch = out_channels or in_channels
        self.scale_factor = scale_factor
        self.act_int8_min_t = act_int8_min_t
        self.out_channels = out_ch
        self.remat = remat_policy(remat)
        self.norm_in = GroupNorm(in_channels, use_gelu=True)
        self.conv_in = Conv1d(in_channels, out_ch, 3)
        self.norm_mid = GroupNorm(out_ch, use_gelu=True)
        self.cond_proj = (
            nn.Linear(emb_channels, out_ch * 2) if emb_channels else None
        )
        self.conv_out = Conv1d(out_ch, out_ch, 3, dilation=dilation)
        self.skip_proj = (
            Conv1d(in_channels, out_ch, 1) if in_channels != out_ch else None
        )

    def _resize(self, x: Union[torch.Tensor, QAct]) -> Union[torch.Tensor, QAct]:
        if self.scale_factor == 1.0:
            return x
        if self.scale_factor < 1.0:
            factor = int(round(1.0 / self.scale_factor))
            return qact_avg_pool(x, factor) if isinstance(x, QAct) else avg_pool_1d(x, factor)
        factor = int(round(self.scale_factor))
        if isinstance(x, QAct):
            return qact_upsample(x, factor)
        return nearest_upsample_1d(x, factor)

    def out_length(self, t: int) -> int:
        if self.scale_factor == 1.0:
            return t
        if self.scale_factor < 1.0:
            return t // int(round(1.0 / self.scale_factor))
        return t * int(round(self.scale_factor))

    def forward(
        self, x: torch.Tensor, emb: Optional[torch.Tensor] = None,
        dropout: Optional[Dropout] = None,
    ) -> torch.Tensor:
        if (emb is not None) != (self.cond_proj is not None):
            raise ValueError("pass an embedding iff the block was built with one")
        if self.act_int8_min_t and dropout is not None:
            raise ValueError("int8 activation storage is serving-only: no dropout")
        keep, keep_prob = None, 1.0
        if dropout is not None:
            n, _, t = x.shape
            keep = dropout.keep_mask((n, self.out_channels, self.out_length(t)), x.device)
            keep_prob = dropout.keep_prob
        if self.remat is None or not torch.is_grad_enabled():
            return self._block(x, emb, keep, keep_prob)
        if self.remat == "full":
            return checkpoint(self._block, x, emb, keep, keep_prob, use_reentrant=False,
                              preserve_rng_state=False)
        h = checkpoint(self._main, x, emb, keep, keep_prob, use_reentrant=False,
                       preserve_rng_state=False, context_fn=_save_first_conv)
        return self._skip(x) + h

    def _int8(self, t: int) -> bool:
        """Whether an activation of length t is stored as int8."""
        return bool(self.act_int8_min_t) and t >= self.act_int8_min_t

    def _block(self, x, emb, keep, keep_prob):
        h = self._main(x, emb, keep, keep_prob)
        if self._int8(h.shape[-1]):
            return quantize_residual(self._skip_input(x), h)
        return self._skip(x) + h

    def _main(self, x, emb, keep, keep_prob):
        t = (x.q if isinstance(x, QAct) else x).shape[-1]
        if self._int8(self.out_length(t)) and self.scale_factor >= 1.0:
            h = self._resize(self.norm_in.quantized(x))
        else:
            h = maybe_quantize(self._resize(self.norm_in(x)), self.act_int8_min_t)
        h = self.conv_in(h)
        film = None
        if emb is not None:
            cond_a, cond_b = linear(gelu(emb), self.cond_proj).chunk(2, dim=-1)
            film = (cond_a, cond_b)
        if self._int8(h.shape[-1]):  # no dropout: the int8 path is serving-only
            return self.conv_out(self.norm_mid.quantized(h, film))
        h = self.norm_mid(h, film)
        if keep is not None:
            h = apply_keep_mask(h, keep, keep_prob)
        return self.conv_out(h)

    def _skip_input(self, x):
        """The skip path's value before the residual add: x resized, and
        projected where the channels change (an int8 x stays int8 unless
        projected)."""
        skip = self._resize(x)
        if self.skip_proj is not None:
            skip = self.skip_proj(skip)
        return skip

    def _skip(self, x):
        skip = self._skip_input(x)
        if isinstance(skip, QAct):
            skip = dequantize(skip, skip.dtype)
        return skip
