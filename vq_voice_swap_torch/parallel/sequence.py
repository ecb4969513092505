"""Sequence (time-axis) parallelism for the 1-D audio models on
``torch.distributed`` (counterpart of the JAX package's
``parallel/sequence.py``): the waveform's time axis is cut into equal
contiguous shards, rank r holding samples [r * T / R, (r + 1) * T / R) of
every row, so audio longer than one card holds (or one card converts in
time) runs over R ranks.

Activations stay [N, C, T] with T local. Only three things talk across the
ranks, each over the sequence group (a ``SeqMesh``):

- a convolution of width k and dilation d receives (k - 1) * d // 2
  samples from each neighbour (``halo_exchange``: one ``all_gather`` of
  every rank's edge columns; zeros beyond the ends, so a SAME convolution
  is exact), then runs VALID on the padded shard (cuDNN); its backward
  sends the halos' gradients back onto the senders' edges;
- a GroupNorm launches the statistics kernel on its shard, to the group
  (mean, var), all-gathers the [2, N, G] pairs and merges them
  (``merge_partials``, equal counts), folds the affine and FiLM
  (``fold_affine``) and launches the apply kernel on its shard. Its
  backward launches the split backward: the reduce kernel's per-row S1,
  S2 of the shard, one all-reduce of the [2, N, C] sums, then the dx
  kernel with the group's element count over all shards;
- the samplers' x0 constraint takes its per-sequence mean over the whole
  time axis (one all-reduce), and every noise draw is the whole [N, T]
  drawn from the seeded generator, each rank keeping its slice, so a
  sharded run draws the one-device run's noise.

Pooling, nearest upsampling, WaveGrad's LayerNorm over channels, the
time and class embeddings and the VQ assignment are per-timestep or
per-row and stay shard-local.

The models run as they are: ``sequence_parallel(mesh)`` makes the funnels
of ``models/layers.py`` (``conv1d``, ``GroupNorm``, ``nearest_resize_1d``)
and the samplers of ``diffusion/process.py`` take the sharded routes
above, so ``seq_parallel_*`` are the port's own modules under that
context. The fused ResBlock pair, tensor parallelism and FSDP do not
compose with it (refused). Every collective is a plain ``all_gather`` or
``all_reduce`` on tensors, which gloo takes for CUDA tensors too (two
ranks sharing one card must run gloo); ``COLLECTIVES`` counts them and
their bytes by kind.
"""

import collections
import contextlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..ops.group_norm import (fold_affine, group_norm_apply, group_norm_bwd_dx,
                              group_norm_bwd_reduce, group_norm_param_grads, group_norm_stats,
                              merge_partials)

__all__ = [
    "SEQ_AXIS",
    "SeqMesh",
    "COLLECTIVES",
    "create_seq_mesh",
    "sequence_parallel",
    "active_mesh",
    "halo_exchange",
    "seq_sharded_conv1d",
    "seq_sharded_group_norm",
    "seq_sharded_avg_pool",
    "seq_sharded_upsample",
    "seq_sharded_resize",
    "seq_row_mean",
    "draw_normal",
    "shard_sequence",
    "gather_sequence",
    "seq_parallel_unet_encoder",
    "seq_parallel_unet_predictor",
    "seq_parallel_wavegrad_encoder",
    "seq_parallel_wavegrad_predictor",
    "seq_parallel_predictor",
    "seq_parallel_ddpm_sample",
    "seq_parallel_sample",
    "seq_parallel_vqvae_convert",
    "seq_parallel_ddpm_losses",
    "make_seq_parallel_train_step",
]

SEQ_AXIS = "seq"

# {kind: calls} and {kind + " bytes": bytes a rank sends} of the collectives.
COLLECTIVES: collections.Counter = collections.Counter()


@dataclass(frozen=True)
class SeqMesh:
    """The ranks that share one sequence, all ranks of the default process
    group: ``size`` of them, this one ``rank`` among them (at size 1 no
    collective runs)."""

    size: int
    rank: int


def create_seq_mesh(num_devices: Optional[int] = None) -> SeqMesh:
    """The sequence mesh of every rank of the process group (a mesh of one
    without a group); ``num_devices``, if given, must be that many."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    if num_devices not in (None, size):
        raise ValueError(f"a sequence mesh spans all {size} rank(s), not {num_devices}")
    return SeqMesh(size, dist.get_rank() if size > 1 else 0)


_ACTIVE: List[SeqMesh] = []


@contextlib.contextmanager
def sequence_parallel(mesh: SeqMesh) -> Iterator[SeqMesh]:
    """Run the models' funnels and the samplers sharded over ``mesh`` in
    the body (see the module's docstring)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh() -> Optional[SeqMesh]:
    """The mesh of the innermost ``sequence_parallel`` body, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _all_gather(mesh: SeqMesh, t: torch.Tensor, kind: str) -> List[torch.Tensor]:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t)
    COLLECTIVES[kind] += 1
    COLLECTIVES[kind + " bytes"] += t.numel() * t.element_size()
    return parts


def _all_reduce(mesh: SeqMesh, t: torch.Tensor, kind: str) -> torch.Tensor:
    dist.all_reduce(t)
    COLLECTIVES[kind] += 1
    COLLECTIVES[kind + " bytes"] += t.numel() * t.element_size()
    return t


# ----------------------------------------------------------------- blocks


class _HaloExchange(torch.autograd.Function):
    """The shard padded with its neighbours' edge columns; the backward
    adds the halos' gradients onto the edges they were taken from."""

    @staticmethod
    def forward(ctx, x, left, right, mesh):
        ctx.left, ctx.right, ctx.mesh, ctx.t = left, right, mesh, x.shape[-1]
        t, r = x.shape[-1], mesh.rank
        parts = _all_gather(mesh, torch.cat([x[..., t - left:], x[..., :right]], -1), "halo")
        zeros = x.new_zeros(x.shape[:-1] + (max(left, right),))
        from_left = parts[r - 1][..., :left] if r > 0 else zeros[..., :left]
        from_right = parts[r + 1][..., left:] if r < mesh.size - 1 else zeros[..., :right]
        return torch.cat([from_left, x, from_right], -1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        left, right, mesh, t = ctx.left, ctx.right, ctx.mesh, ctx.t
        r = mesh.rank
        parts = _all_gather(mesh, torch.cat([g[..., :left], g[..., left + t:]], -1),
                            "halo backward")
        dx = g[..., left:left + t].clone(memory_format=torch.contiguous_format)
        if r < mesh.size - 1 and left:  # the right neighbour's left halo is this tail
            dx[..., t - left:] += parts[r + 1][..., :left]
        if r > 0 and right:  # the left neighbour's right halo is this head
            dx[..., :right] += parts[r - 1][..., left:]
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, left: int, right: int,
                  mesh: Optional[SeqMesh] = None) -> torch.Tensor:
    """Pad a local [N, C, Tl] shard with ``left`` samples of its left
    neighbour's end and ``right`` of its right neighbour's start (zeros at
    the ends of the sequence), over ``mesh`` (default: the active one).
    Differentiable; a ValueError when a halo exceeds the local block (the
    exchange reaches the immediate neighbours only)."""
    mesh = mesh or active_mesh()
    if mesh is None:
        raise ValueError("halo_exchange needs a sequence mesh")
    if max(left, right) > x.shape[-1]:
        raise ValueError(
            f"halo {max(left, right)} exceeds local block {x.shape[-1]}: the sharded sequence "
            "is too short for this dilation/mesh combination (halo exchange only reaches "
            "immediate neighbors)")
    if not (left or right):
        return x
    if mesh.size == 1:
        return F.pad(x, (left, right))
    return _HaloExchange.apply(x, left, right, mesh)


def seq_sharded_conv1d(
    mesh: SeqMesh,
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """SAME conv1d of a T-sharded [N, Cin, Tl] with ``weight`` [Cout, Cin,
    K] (replicated): the halos, then a VALID convolution, in x's dtype. The
    local T must be divisible by ``stride``."""
    halo = (weight.shape[-1] - 1) * dilation // 2
    x = halo_exchange(x, halo, halo, mesh)
    return F.conv1d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                    stride=stride, dilation=dilation)


class _SeqGroupNorm(torch.autograd.Function):
    """GroupNorm of a T-sharded input: forward statistics kernel, merge,
    fold, apply kernel; backward reduce kernel, all-reduce, dx kernel."""

    @staticmethod
    def forward(ctx, x, weight, bias, ca, cb, num_groups, eps, use_gelu, mesh):
        film = None if ca is None else (ca, cb)
        n, c, t = x.shape
        mean, var = group_norm_stats(x, num_groups)
        if mesh.size > 1:
            both = torch.stack(_all_gather(mesh, torch.stack([mean, var]), "group_norm"), -1)
            count = torch.full((n * num_groups, mesh.size), float(c // num_groups * t),
                               device=x.device)
            mean, var = merge_partials(count, both[0].reshape(count.shape),
                                       both[1].reshape(count.shape) * count)
            mean, var = mean.view(n, num_groups), var.view(n, num_groups)
        ctx.save_for_backward(x, weight, bias, ca, cb, mean, var)
        ctx.num_groups, ctx.eps, ctx.use_gelu, ctx.mesh = num_groups, eps, use_gelu, mesh
        mean_c, a, b = fold_affine(mean, var, weight, bias, eps, film)
        return group_norm_apply(x, mean_c, a, b, use_gelu)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, ca, cb, mean, var = ctx.saved_tensors
        film = None if ca is None else (ca, cb)
        mesh = ctx.mesh
        args = (x, dy.contiguous(), ctx.num_groups, mean, var, weight, bias, ctx.eps,
                ctx.use_gelu, film)
        s1, s2 = group_norm_bwd_reduce(*args)
        sums = torch.stack([s1, s2])
        if mesh.size > 1:
            _all_reduce(mesh, sums, "group_norm backward")
        count = x.shape[1] // ctx.num_groups * x.shape[2] * mesh.size
        dx = group_norm_bwd_dx(*args, sums[0], sums[1], count)
        grads = [dx if ctx.needs_input_grad[0] else None, None, None, None, None]
        if any(ctx.needs_input_grad[1:5]):
            # This shard's share: the train step sums parameter gradients
            # over the ranks, as it does every other leaf's.
            params = (weight, bias, ca, cb)
            for i, g in enumerate(group_norm_param_grads(s1, s2, weight, bias, film), 1):
                if ctx.needs_input_grad[i]:
                    grads[i] = g.to(params[i - 1].dtype)
        return (*grads, None, None, None, None)


def seq_sharded_group_norm(
    mesh: SeqMesh,
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    use_gelu: bool = False,
    film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """GroupNorm of a T-sharded [N, C, Tl] (then FiLM h*(ca+1)+cb and exact
    GELU, as ``ops.group_norm.group_norm``): each shard's two-pass float32
    statistics merged over the ranks, so a group's statistics are the
    whole sequence's. Differentiable."""
    ca, cb = film or (None, None)
    return _SeqGroupNorm.apply(x, scale, bias, ca, cb, num_groups, eps, use_gelu, mesh)


def seq_sharded_avg_pool(mesh: SeqMesh, x: torch.Tensor, factor: int) -> torch.Tensor:
    """Non-overlapping average pool over the local T (divisible by
    ``factor``, so windows never straddle shards)."""
    from ..models.layers import avg_pool_1d

    return avg_pool_1d(x, factor)


def seq_sharded_upsample(mesh: SeqMesh, x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsample over the local T."""
    from ..models.layers import nearest_upsample_1d

    return nearest_upsample_1d(x, factor)


def seq_sharded_resize(mesh: SeqMesh, x: torch.Tensor, out_len: int) -> torch.Tensor:
    """``models.layers.nearest_resize_1d`` of a shard to ``out_len`` local
    samples: a per-shard repeat, which needs an integer factor."""
    t = x.shape[-1]
    if out_len % t:
        raise ValueError("T must be an integer multiple of the cond length for the "
                         f"sequence-parallel predictor (local {out_len} against {t})")
    return x if out_len == t else seq_sharded_upsample(mesh, x, out_len // t)


def seq_row_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of each row of x [N, ...] over its other axes, keepdim,
    over the whole sequence under the active mesh (one all-reduce)."""
    dims = tuple(range(1, x.ndim))
    mesh = active_mesh()
    if mesh is None or mesh.size == 1:
        return x.mean(dim=dims, keepdim=True)
    total = _all_reduce(mesh, x.sum(dim=dims, keepdim=True), "row mean")
    return total / (x[0].numel() * mesh.size)


def draw_normal(shape: Sequence[int], generator: Optional[torch.Generator],
                dtype: torch.dtype, device) -> torch.Tensor:
    """Standard normal noise of a local [N, Tl, ...] shape: under the
    active mesh the whole [N, Tl * R, ...] is drawn and this rank keeps
    its slice, so every rank draws what one device draws."""
    mesh = active_mesh()
    if mesh is None or mesh.size == 1:
        return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)
    n, tl, *rest = shape
    full = torch.randn((n, tl * mesh.size, *rest), generator=generator, dtype=dtype,
                       device=device)
    return full[:, mesh.rank * tl:(mesh.rank + 1) * tl].contiguous()


def shard_sequence(mesh: SeqMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous shard of the whole sequence x [N, T, ...]
    (T divisible by the mesh's size) along axis 1."""
    if x.shape[1] % mesh.size:
        raise ValueError(f"length {x.shape[1]} does not split into {mesh.size} shards")
    tl = x.shape[1] // mesh.size
    return x[:, mesh.rank * tl:(mesh.rank + 1) * tl].contiguous()


@torch.no_grad()
def gather_sequence(mesh: SeqMesh, x: torch.Tensor) -> torch.Tensor:
    """The whole sequence on every rank: the ranks' shards x [N, Tl, ...]
    concatenated along axis 1 (one all-gather)."""
    if mesh.size == 1:
        return x
    return torch.cat(_all_gather(mesh, x, "gather"), dim=1)


# ------------------------------------------------------------------ models


def _check_module(module, kinds, what: str) -> None:
    from .tensor import cut_axes

    if not isinstance(module, kinds):
        raise TypeError(f"sequence parallelism supports {what}, got {type(module).__name__}")
    if getattr(module, "fuse_levels", 0):
        raise ValueError("the sequence-parallel path runs unfused: build the predictor "
                         "with fuse_levels=0")
    if cut_axes(module):
        raise ValueError("sequence parallelism does not compose with tensor parallelism")


def _under(mesh: SeqMesh, module, *args, **kwargs):
    with sequence_parallel(mesh):
        return module(*args, **kwargs)


def seq_parallel_unet_encoder(mesh: SeqMesh, encoder, x: torch.Tensor) -> torch.Tensor:
    """A ``models.unet.UNetEncoder`` over a time-sharded waveform: x [N, Tl,
    1] -> [N, Tl / downsample_rate, C] float32. Tl must stay divisible
    through the pooling pyramid and wider than the widest halo."""
    from ..models.unet import UNetEncoder

    _check_module(encoder, UNetEncoder, "a UNetEncoder")
    return _under(mesh, encoder, x)


def seq_parallel_unet_predictor(mesh: SeqMesh, predictor, x: torch.Tensor, ts: torch.Tensor,
                                cond: Optional[torch.Tensor] = None,
                                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A ``models.unet.UNetPredictor`` (unfused) over a time-sharded x [N,
    Tl, in_channels]; ts [N] and labels [N] replicated; cond [N, Tl1, C]
    sharded the same way, with Tl a multiple of Tl1, so its nearest resize
    is a per-shard repeat."""
    from ..models.unet import UNetPredictor

    _check_module(predictor, UNetPredictor, "a UNetPredictor")
    return _under(mesh, predictor, x, ts, cond=cond, labels=labels)


def seq_parallel_wavegrad_predictor(mesh: SeqMesh, predictor, x: torch.Tensor,
                                    ts: torch.Tensor, cond: Optional[torch.Tensor] = None,
                                    labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A ``models.wavegrad.WaveGradPredictor`` over a time-sharded x [N, Tl,
    1]: Tl a multiple of 64 with the widest halo (16, at the conv_5 levels
    of T / 32) left after /32, so Tl >= 512; cond [N, Tl / 64, C] or None.
    Only its convolutions talk across the ranks (LayerNorm is over
    channels)."""
    from ..models.wavegrad import WaveGradPredictor

    _check_module(predictor, WaveGradPredictor, "a WaveGradPredictor")
    return _under(mesh, predictor, x, ts, cond=cond, labels=labels)


def seq_parallel_wavegrad_encoder(mesh: SeqMesh, encoder, x: torch.Tensor) -> torch.Tensor:
    """A ``models.wavegrad.WaveGradEncoder`` over a time-sharded waveform."""
    from ..models.wavegrad import WaveGradEncoder

    _check_module(encoder, WaveGradEncoder, "a WaveGradEncoder")
    return _under(mesh, encoder, x)


def seq_parallel_predictor(mesh: SeqMesh, predictor, x: torch.Tensor, ts: torch.Tensor,
                           cond: Optional[torch.Tensor] = None,
                           labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sequence-parallel run of a UNet or WaveGrad predictor; a
    TypeError for any other."""
    from ..models.unet import UNetPredictor
    from ..models.wavegrad import WaveGradPredictor

    if isinstance(predictor, UNetPredictor):
        return seq_parallel_unet_predictor(mesh, predictor, x, ts, cond, labels)
    if isinstance(predictor, WaveGradPredictor):
        return seq_parallel_wavegrad_predictor(mesh, predictor, x, ts, cond, labels)
    raise TypeError("sequence parallelism supports UNet and WaveGrad predictors, got "
                    f"{type(predictor).__name__}")


def seq_parallel_sample(
    mesh: SeqMesh,
    diffusion,
    predictor,
    x_T: torch.Tensor,
    steps: int,
    generator: Optional[torch.Generator] = None,
    cond: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    sampler: str = "ddpm",
    eta: float = 0.0,
    **kwargs,
) -> torch.Tensor:
    """``diffusion.{ddpm,ddim,dpmpp}_sample`` from the time-sharded x_T [N,
    Tl, 1] with the sharded predictor; the samplers' arithmetic is
    elementwise in time, and their draws and the x0 constraint's mean are
    the whole sequence's (``draw_normal``, ``seq_row_mean``). ``kwargs``:
    ``constrain``, ``warp``. Returns this rank's shard of x_0."""
    def pred_fn(xs, ts):
        return seq_parallel_predictor(mesh, predictor, xs, ts, cond=cond, labels=labels)

    with sequence_parallel(mesh):
        if sampler == "ddim":
            return diffusion.ddim_sample(x_T, pred_fn, steps, generator=generator, eta=eta,
                                         **kwargs)
        if sampler == "dpmpp":
            return diffusion.dpmpp_sample(x_T, pred_fn, steps, **kwargs)
        if sampler != "ddpm":
            raise ValueError(f"unknown sampler {sampler!r}")
        return diffusion.ddpm_sample(x_T, pred_fn, steps, generator=generator, **kwargs)


# The name the function had before it dispatched ddim and dpmpp.
seq_parallel_ddpm_sample = seq_parallel_sample


def seq_parallel_vqvae_convert(
    mesh: SeqMesh,
    model,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    labels: Optional[torch.Tensor] = None,
    steps: int = 100,
    **kwargs,
) -> torch.Tensor:
    """Speaker conversion (encode, VQ, diffusion decode) of a time-sharded
    waveform x [N, Tl, 1], Tl divisible by the model's downsample rate: the
    encoder sharded, the VQ assignment on this rank's rows (no
    collective), x_T the one-device run's draw from ``generator`` (as
    ``VQVAE.decode`` draws it), then ``seq_parallel_sample``. A UNet or
    WaveGrad encoder; a TypeError for any other (the MFCC encoder).
    Returns this rank's shard of the converted audio."""
    from ..models.unet import UNetEncoder
    from ..models.wavegrad import WaveGradEncoder
    from ..vq import vq_forward

    if isinstance(model.encoder, UNetEncoder):
        enc = seq_parallel_unet_encoder(mesh, model.encoder, x)
    elif isinstance(model.encoder, WaveGradEncoder):
        enc = seq_parallel_wavegrad_encoder(mesh, model.encoder, x)
    else:
        raise TypeError("sequence-parallel conversion supports UNet- and WaveGrad-family "
                        f"encoders, got {type(model.encoder).__name__}")
    cond_seq = vq_forward(model.vq.dictionary, enc)["embedded"]
    x_len = cond_seq.shape[1] * model.encoder.downsample_rate
    with sequence_parallel(mesh):
        x_T = draw_normal((cond_seq.shape[0], x_len, 1), generator, torch.float32, x.device)
    return seq_parallel_sample(mesh, model.diffusion, model.predictor, x_T, steps, generator,
                               cond=cond_seq, labels=labels, **kwargs)


class _SumOverRanks(torch.autograd.Function):
    """The sum over the ranks; the backward passes the gradient through, so
    each rank backpropagates its own share."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(mesh, x.clone(), "loss")

    @staticmethod
    def backward(ctx, g):
        return g, None


def seq_parallel_ddpm_losses(
    mesh: SeqMesh,
    diffusion,
    predictor,
    x: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    cond: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    ts: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    reduce: bool = True,
) -> torch.Tensor:
    """Per-batch-element epsilon-MSE [N] of the time-sharded x [N, Tl, C]
    with the sharded predictor, the draws (ts, then the noise) the
    one-device ``Diffusion.ddpm_losses`` draws from ``generator``. With
    ``reduce`` the losses of the whole sequence on every rank
    (differentiable: each rank's backward carries its own share); without,
    this rank's share, which sums over the ranks to them."""
    n = x.shape[0]
    with sequence_parallel(mesh):
        if ts is None:
            ts = torch.rand((n,), generator=generator, dtype=torch.float32, device=x.device)
        if noise is None:
            noise = draw_normal(x.shape, generator, x.dtype, x.device)
        samples = diffusion.sample_q(x, ts, epsilon=noise)
        pred = seq_parallel_predictor(mesh, predictor, samples, ts, cond=cond, labels=labels)
    share = torch.square(noise - pred).reshape(n, -1).sum(dim=1) / (x[0].numel() * mesh.size)
    return _SumOverRanks.apply(share, mesh) if reduce and mesh.size > 1 else share


def make_seq_parallel_train_step(mesh: SeqMesh, diffusion, predictor, opt):
    """A train step (x, labels=None, cond=None, generator=None, ts=None,
    noise=None) -> (loss, losses) of the mean epsilon-MSE through the
    sequence-parallel predictor, on the port's AdamW (``train.state``
    ``Optimizer`` over the predictor's parameters): each rank
    backpropagates its share of the loss, then one all-reduce of one flat
    buffer sums the parameter gradients and the per-element losses over
    the ranks, and every rank takes the same AdamW step. The draws are the
    one-device step's (see ``seq_parallel_ddpm_losses``)."""

    def step(x, labels=None, cond=None, generator=None, ts=None, noise=None):
        opt.zero_grad()
        with torch.enable_grad():
            share = seq_parallel_ddpm_losses(mesh, diffusion, predictor, x, labels, cond,
                                             generator, ts, noise, reduce=False)
            share.mean().backward()
        grads = [p.grad for p in opt.params if p.grad is not None]
        flat = torch.cat([g.reshape(-1).float() for g in grads] + [share.detach().float()])
        if mesh.size > 1:
            _all_reduce(mesh, flat, "train step")
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view(g.shape))
            offset += g.numel()
        losses = flat[offset:]
        opt.step()
        return losses.mean(), losses

    return step
