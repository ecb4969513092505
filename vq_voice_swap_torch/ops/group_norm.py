"""GroupNorm (+ optional FiLM and exact GELU) over [N, C, T]: a hand-written
CUDA statistics kernel, a Triton apply kernel, and their plain PyTorch
versions.

Counterpart of ``vq_voice_swap_tpu/ops/fused_norm.py``:

- ``group_norm_coeffs`` replaces ``_stats_kernel`` (fused_norm.py:84)
  together with what follows it there, ``_finish_from_channel_stats`` up to
  the folded affine (fused_norm.py:166-184). One launch of
  ``csrc/group_norm_stats.cu`` (its header has the design) reads x once and
  writes the float32 per-channel (mean, a, b) [N, C] of ``fold_affine``:
  two-pass float32 statistics, so large-mean inputs keep their variance,
  with the affine and an optional FiLM h*(ca+1)+cb folded in by the
  kernel's last block. ``group_norm_stats`` runs the same kernel without
  the fold, to the group (mean, var).
- ``group_norm_apply`` is the counterpart of the normalise + GELU pass
  that the JAX package leaves to XLA (fused_norm.py:191-193; the Pallas
  ``_apply_kernel`` at fused_norm.py:115 is reached by no ``pallas_call``):
  y = (x - mean) * a + b per (n, channel) row, then optional exact-erf GELU,
  stored in x's dtype. Subtracting the mean first (rather than folding it
  into b) keeps large-mean inputs accurate.

So one GroupNorm, with or without FiLM, is two launches on the card and no
torch op between them. ``group_norm_coeffs_int8`` and
``group_norm_apply_int8`` read int8 activation codes and their float32
scales (one, or one a channel; ``ops/qact.py``): the int8 serving path's
GroupNorm (no FiLM), whose output is in the compute dtype. The first is
the statistics kernel's int8 mode, a kernel of its own: exact integer sums
of the codes and of their squares, the scale applied once a channel, and
JAX's one-pass E[x^2] - mean^2 in float64 on those sums
(``group_norm_coeffs_int8_plain`` is the same arithmetic); the second, the
apply kernel dequantizing in registers. Both kernels are memory-bound
streaming passes: the bound is x read once (statistics), and x read once
plus y written once (apply), at the card's memory rate.

The backward has no Pallas counterpart: it replaces the VJP the JAX package
takes of GroupNorm (``_fgn_bwd``, fused_norm.py:280-288, and flax's
autodiff of ``nn.GroupNorm``). ``group_norm_backward`` takes the group
(mean, var) of the forward (rstd cannot be recovered from the folded a when
the weight or the FiLM scale is 0): ``GroupNormFunction``'s forward asks
the statistics launch for them (``group_norm_coeffs(..., stats=True)``) and
passes them on; a standalone call without them runs the statistics kernel
first. Then ``csrc/group_norm_bwd.cu`` (its header has the design) by one
of two routes that ``bwd_route`` picks from the shape: one launch of a
thread-block cluster per (n, group) that reads x and dy once into shared
memory, or, for spans beyond a cluster's capacity, a reduce launch and a dx
launch. Both give dx in x's dtype and the per-row sums S1 = sum_t dz,
S2 = sum_t dz * xhat, from which ``group_norm_param_grads`` forms the
parameter gradients. The two-kernel route's launches also have wrappers
of their own, ``group_norm_bwd_reduce`` (S1, S2 of this tensor) and
``group_norm_bwd_dx`` (dx from S1, S2 and the group's element count), for
a group cut over ranks (``parallel/sequence.py``), whose S1 and S2 are
summed over the ranks between them. ``group_norm`` takes
``GroupNormFunction`` only on CUDA, with grad enabled and an input that
requires it, so the no-grad paths launch exactly the two forward kernels.
On the CPU autograd runs through the plain versions.

Wrappers use the plain versions for CPU tensors and launch the kernels for
CUDA tensors, with no fallback between them; each counts its launches.
"""

import ctypes
import functools
from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .cuda_build import load_library
from .tickets import tickets

__all__ = [
    "group_norm",
    "GroupNormFunction",
    "group_norm_backward",
    "group_norm_backward_plain",
    "group_norm_bwd_reduce",
    "group_norm_bwd_reduce_plain",
    "group_norm_bwd_dx",
    "group_norm_bwd_dx_plain",
    "bwd_route",
    "BwdRoute",
    "group_norm_param_grads",
    "group_norm_coeffs",
    "group_norm_coeffs_plain",
    "group_norm_stats",
    "group_norm_apply",
    "group_norm_coeffs_int8",
    "group_norm_coeffs_int8_plain",
    "group_norm_apply_int8",
    "dequantize_codes",
    "group_stats_plain",
    "group_norm_apply_plain",
    "merge_partials",
    "fold_affine",
    "apply_helpers",
    "check_codes",
    "check_apply_coeffs",
    "sm_count",
]

APPLY_BLOCK = 4096  # largest T-block of one apply program
# The statistics kernel's pass over a span, its limit on slices per span
# (csrc/group_norm_stats.cu reports both; _stats_library() checks them) and
# its blocks resident on one SM (its __launch_bounds__).
STATS_TILE = 256 * 32
STATS_MAX_SLICES = 256
STATS_BLOCKS_PER_SM = 4
# The backward (csrc/group_norm_bwd.cu reports its limits; _bwd_library()
# checks them). Cluster route: at most BWD_CLUSTER_MAX blocks a span, each
# holding at most BWD_BLOCK_ELEMS elements in at most BWD_MAX_SMEM bytes of
# shared memory (BWD_HEADER + 8 bytes a channel of the group, rounded up
# to 16, then 8 bytes an element).
# Two-kernel route: the reduce's pass over a row, its limit on blocks per
# row and its blocks per SM.
BWD_CLUSTER_MAX = 16
BWD_BLOCK_ELEMS = 7 * 4096
BWD_MAX_SMEM = 232448
BWD_HEADER = 208
BWD_TILE = 256 * 16
BWD_MAX_SLICES = 64
BWD_BLOCKS_PER_SM = 4
# How bwd_route sizes a cluster: blocks of at most BWD_TARGET_ELEMS
# elements (64 KB of shared memory: three blocks per SM) and at least
# BWD_FILL blocks per SM in all, unless that leaves fewer than
# BWD_MIN_ELEMS elements a block.
BWD_TARGET_ELEMS = 8192
BWD_FILL = 2
BWD_MIN_ELEMS = 1024

_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

Film = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _check_x(x: torch.Tensor) -> None:
    if x.ndim != 3:
        raise ValueError(f"expected x [N, C, T], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"GroupNorm takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("GroupNorm takes a contiguous [N, C, T] tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"GroupNorm runs on CPU or CUDA, not {x.device}")


def _check_groups(x: torch.Tensor, num_groups: int) -> None:
    if num_groups < 1 or x.shape[1] % num_groups:
        raise ValueError(f"{x.shape[1]} channels do not split into {num_groups} groups")


def _check_coeffs(x, weight, bias, film: Film, out) -> None:
    n, c, _ = x.shape
    for name, v in (("weight", weight), ("bias", bias)):
        if v.shape != (c,) or v.dtype not in _DTYPES or v.device != x.device:
            raise ValueError(f"{name} must be [{c}] on {x.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")
    if film is not None:
        ca, cb = film
        if ca.shape != (n, c) or cb.shape != (n, c):
            raise ValueError(f"FiLM (ca, cb) must be [{n}, {c}] each, got "
                             f"{tuple(ca.shape)} and {tuple(cb.shape)}")
        if ca.dtype not in _DTYPES or ca.dtype != cb.dtype:
            raise ValueError(f"FiLM takes one float32 or bfloat16 dtype, got "
                             f"{ca.dtype} and {cb.dtype}")
        if ca.stride() != cb.stride() or ca.stride(1) != 1:
            raise ValueError("FiLM (ca, cb) need unit channel stride and one row stride")
        if ca.device != x.device or cb.device != x.device:
            raise ValueError(f"FiLM must be on {x.device}")
    if out is not None:
        if (out.shape != (3, n, c) or out.dtype != torch.float32 or out.stride(2) != 1
                or out.device != x.device):
            raise ValueError(f"out must be float32 [3, {n}, {c}] with unit channel "
                             f"stride on {x.device}, got {out.dtype} "
                             f"{tuple(out.shape)} strides {out.stride()}")


def check_codes(q: torch.Tensor, scale: torch.Tensor) -> None:
    if q.ndim != 3 or q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError(f"expected contiguous int8 codes [N, C, T], got {q.dtype} "
                         f"{tuple(q.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"GroupNorm runs on CPU or CUDA, not {q.device}")
    if (scale.dtype != torch.float32 or scale.shape not in ((), (q.shape[1],))
            or scale.device != q.device or not scale.is_contiguous()):
        raise ValueError(f"scale must be a contiguous float32 () or ({q.shape[1]},) on "
                         f"{q.device}, got {scale.dtype} {tuple(scale.shape)} on {scale.device}")


# ------------------------------------------------------------ plain versions


def dequantize_codes(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Float32 values of int8 codes [N, C, T]: q * scale, the scale one
    float32 () or one a channel (C,)."""
    return q.float() * (scale if scale.ndim == 0 else scale[:, None])


def group_stats_plain(
    x: torch.Tensor, num_groups: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass float32 group mean and (biased) variance, [N, G] each."""
    n = x.shape[0]
    xf = x.reshape(n, num_groups, -1).float()
    mean = xf.mean(dim=-1)
    var = torch.square(xf - mean[..., None]).mean(dim=-1)
    return mean, var


def group_norm_apply_plain(
    x: torch.Tensor,
    mean: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    use_gelu: bool,
) -> torch.Tensor:
    """y = (x - mean) * a + b per (n, channel), optional exact GELU, in x's
    dtype; mean/a/b are float32 [N, C]."""
    y = (x.float() - mean[..., None]) * a[..., None] + b[..., None]
    if use_gelu:
        y = F.gelu(y)
    return y.to(x.dtype)


def gelu_grad(u: torch.Tensor) -> torch.Tensor:
    """d/du of the exact (erf) GELU: Phi(u) + u * phi(u)."""
    cdf = 0.5 * (1.0 + torch.erf(u * 0.7071067811865476))
    return cdf + u * 0.3989422804014327 * torch.exp(-0.5 * u * u)


def _bwd_terms(x, dy, num_groups, mean, var, weight, bias, eps, use_gelu, film):
    """Float32 (dz, xhat, rstd [N, C, 1]) of the backward at x for dy."""
    rep = x.shape[1] // num_groups
    mean_c, a, b = fold_affine(mean, var, weight, bias, eps, film)
    rstd = torch.rsqrt(var + eps).repeat_interleave(rep, dim=1)[..., None]
    d = x.float() - mean_c[..., None]
    dz = dy.float()
    if use_gelu:
        dz = dz * gelu_grad(d * a[..., None] + b[..., None])
    return dz, d * rstd, rstd


def group_norm_bwd_reduce_plain(
    x: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    mean: torch.Tensor,
    var: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    use_gelu: bool,
    film: Film = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``group_norm_bwd_reduce`` in float32: the per-row S1 = sum_t dz and
    S2 = sum_t dz * xhat [N, C] of x and dy, from the group (mean, var)."""
    dz, xhat, _ = _bwd_terms(x, dy, num_groups, mean, var, weight, bias, eps, use_gelu, film)
    return dz.sum(dim=-1), (dz * xhat).sum(dim=-1)


def group_norm_bwd_dx_plain(
    x: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    mean: torch.Tensor,
    var: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    use_gelu: bool,
    film: Film,
    s1: torch.Tensor,
    s2: torch.Tensor,
    count: int,
) -> torch.Tensor:
    """``group_norm_bwd_dx`` in float32: dx in x's dtype from the group's
    per-row S1, S2 [N, C] and its element count ``count``."""
    n, c, _ = x.shape
    rep = c // num_groups
    dz, xhat, rstd = _bwd_terms(x, dy, num_groups, mean, var, weight, bias, eps, use_gelu,
                                film)
    k = weight.float() * (1.0 if film is None else film[0].float() + 1.0)
    k = k.expand(n, c)
    ga = (k * s1).view(n, num_groups, rep).sum(dim=-1) / count
    gb = (k * s2).view(n, num_groups, rep).sum(dim=-1) / count
    ga = ga.repeat_interleave(rep, dim=1)[..., None]
    gb = gb.repeat_interleave(rep, dim=1)[..., None]
    dx = rstd * (dz * k[..., None] - ga - xhat * gb)
    return dx.to(x.dtype)


def group_norm_backward_plain(
    x: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    use_gelu: bool,
    film: Film = None,
    stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``group_norm_backward`` step by step in float32: (dx in x's dtype,
    S1, S2 [N, C]) for y = act((x - mean) * a + b) of ``fold_affine``, from
    the group (mean, var) ``stats`` of the forward, or computed from x."""
    mean, var = group_stats_plain(x, num_groups) if stats is None else stats
    args = (x, dy, num_groups, mean, var, weight, bias, eps, use_gelu, film)
    s1, s2 = group_norm_bwd_reduce_plain(*args)
    count = x.shape[1] // num_groups * x.shape[2]
    return group_norm_bwd_dx_plain(*args, s1, s2, count), s1, s2


def group_norm_param_grads(
    s1: torch.Tensor,
    s2: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    film: Film = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Float32 (dweight [C], dbias [C], dca [N, C], dcb [N, C]) from the
    backward's per-row S1, S2: dweight = sum_n s S2, dbias = sum_n s S1,
    dca = w S2 + bias S1, dcb = S1, with s = ca + 1 (the FiLM gradients are
    None without FiLM)."""
    if film is None:
        return s2.sum(dim=0), s1.sum(dim=0), None, None
    s = film[0].float() + 1.0
    dca = weight.float() * s2 + bias.float() * s1
    return (s * s2).sum(dim=0), (s * s1).sum(dim=0), dca, s1


# ------------------------------------------------------------- shared math


def merge_partials(
    count: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chan's parallel merge of [R, S] chunk partials -> (mean, var) [R]."""
    total = count.sum(dim=-1)
    mu = (count * mean).sum(dim=-1) / total
    m2_total = m2.sum(dim=-1) + (count * torch.square(mean - mu[:, None])).sum(
        dim=-1
    )
    return mu, m2_total / total


def fold_affine(
    mean: torch.Tensor,
    var: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    film: Film = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group stats [N, G] + affine [C] (+ FiLM (ca, cb) [N, C]) -> float32
    per-channel (mean, a, b) [N, C] for ``group_norm_apply``, so that
    (x - mean) * a + b == FiLM(GroupNorm(x)), with FiLM h*(ca+1)+cb."""
    rep = weight.shape[0] // mean.shape[1]
    mean_c = mean.repeat_interleave(rep, dim=1)
    a = torch.rsqrt(var + eps).repeat_interleave(rep, dim=1) * weight.float()
    b = bias.float().expand_as(a)
    if film is not None:
        ca, cb = film
        s = ca.float() + 1.0
        a = a * s
        b = b * s + cb.float()
    return mean_c.contiguous(), a.contiguous(), b.contiguous()


def group_norm_coeffs_plain(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    film: Film = None,
    out: Optional[torch.Tensor] = None,
    stats: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``group_norm_coeffs`` in plain PyTorch: ``fold_affine`` of
    ``group_stats_plain``, copied into ``out`` when given; with ``stats``,
    followed by the group (mean, var)."""
    group = group_stats_plain(x, num_groups)
    coeffs = fold_affine(*group, weight, bias, eps, film)
    if out is not None:
        for dst, src in zip(out, coeffs):
            dst.copy_(src)
        coeffs = tuple(out)
    return (*coeffs, *group) if stats else coeffs


def group_norm_coeffs_int8_plain(
    q: torch.Tensor,
    scale: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    stats: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``group_norm_coeffs_int8`` in plain PyTorch, the kernel's arithmetic
    step by step: exact int64 sums S1 = sum q and S2 = sum q^2 of each
    channel's row of codes (of the group's span with one scale); in
    float64, a channel at a time in channel order, m1 = sum_c s_c S1_c and
    m2 = sum_c s_c^2 S2_c; mean = m1 / n, var = max(m2 / n - mean^2, 0)
    (JAX's one-pass formula on exact sums: no cancellation), each rounded
    to float32 once; then ``fold_affine``. With ``stats``, the group
    (mean, var) [N, G] follow."""
    n, c, t = q.shape
    cpg = c // num_groups
    per_channel = scale.ndim == 1
    rows = q.view(n, num_groups, cpg, t) if per_channel else q.view(n, num_groups, 1, cpg * t)
    s1 = rows.sum(dim=-1, dtype=torch.int64).double()
    s2 = rows.int().square().sum(dim=-1, dtype=torch.int64).double()
    s = scale.double().view(1, num_groups, cpg) if per_channel else scale.double().view(1, 1, 1)
    m1 = torch.zeros((n, num_groups), dtype=torch.float64, device=q.device)
    m2 = torch.zeros_like(m1)
    for k in range(rows.shape[2]):
        sk = s[..., k]
        m1 = m1 + sk * s1[..., k]
        m2 = m2 + (sk * sk) * s2[..., k]
    # A tensor divisor: torch on CUDA multiplies by the reciprocal of a
    # Python number, which rounds otherwise than the kernel's division.
    count = m1.new_full((), cpg * t)
    mean = m1 / count
    var = (m2 / count - mean * mean).clamp(min=0.0)
    group = mean.float(), var.float()
    coeffs = fold_affine(*group, weight, bias, eps)
    return (*coeffs, *group) if stats else coeffs


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def apply_helpers() -> SimpleNamespace:
    """The apply kernel's body as ``@triton.jit`` helpers, defined at first
    use (triton is imported here, never at module import: the CPU has no
    triton): ``triton``, ``tl``, ``affine`` (float32 (x - mean) * a + b of
    one block of an (n, c) row), ``gelu`` (exact erf GELU) and ``values``
    (the two composed). The apply kernel and ``ops/qact.py``'s quantize
    kernels take them from here, so a quantized GroupNorm output has the
    apply kernel's bits. The kernels reach them as closure variables."""
    import triton
    import triton.language as tl

    @triton.jit
    def affine(x_ptr, offs, mask, row, mean_ptr, a_ptr, b_ptr, s_ptr, C, S_STRIDE,
               INT8: tl.constexpr):
        """Float32 (x - mean) * a + b of one block of row ``row`` (n * C +
        c) at ``offs``; int8 codes times the row's channel scale where
        INT8."""
        mean = tl.load(mean_ptr + row)
        a = tl.load(a_ptr + row)
        b = tl.load(b_ptr + row)
        if INT8:  # codes times the row's channel scale
            x = tl.load(x_ptr + offs, mask=mask, other=0).to(tl.float32)
            x = x * tl.load(s_ptr + (row % C) * S_STRIDE)
        else:
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        return (x - mean) * a + b

    @triton.jit
    def gelu(y):
        """Exact (erf) GELU, (0.5 y) (1 + erf(y / sqrt 2)): at most y where
        y >= 0 (erf <= 1), and above -0.17 where y < 0."""
        return 0.5 * y * (1.0 + tl.math.erf(y * 0.7071067811865476))

    # Unannotated: Triton reads a callee's annotations in the names it
    # captures, and this body names no ``tl``; the callers' constexpr GELU
    # and INT8 specialise it all the same.
    @triton.jit
    def values(x_ptr, offs, mask, row, mean_ptr, a_ptr, b_ptr, s_ptr, C, S_STRIDE, GELU, INT8):
        """``affine``, then ``gelu`` where GELU."""
        y = affine(x_ptr, offs, mask, row, mean_ptr, a_ptr, b_ptr, s_ptr, C, S_STRIDE, INT8)
        if GELU:
            y = gelu(y)
        return y

    return SimpleNamespace(triton=triton, tl=tl, affine=affine, gelu=gelu, values=values)


@functools.lru_cache(maxsize=None)
def _apply_kernel():
    """Define the Triton apply kernel at first launch, on ``apply_helpers``."""
    helpers = apply_helpers()
    triton, tl, values = helpers.triton, helpers.tl, helpers.values

    @triton.jit
    def apply_kernel(x_ptr, mean_ptr, a_ptr, b_ptr, y_ptr, T, s_ptr, C, S_STRIDE,
                     GELU: tl.constexpr, INT8: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        idx = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        mask = idx < T
        offs = row.to(tl.int64) * T + idx
        y = values(x_ptr, offs, mask, row, mean_ptr, a_ptr, b_ptr, s_ptr, C, S_STRIDE, GELU,
                   INT8)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, apply_kernel


@functools.lru_cache(maxsize=None)
def _stats_library():
    lib = load_library("group_norm_stats")
    for fn, want in ((lib.group_norm_stats_tile, STATS_TILE),
                     (lib.group_norm_stats_max_slices, STATS_MAX_SLICES)):
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"csrc/group_norm_stats.cu: {fn.__name__} is {fn()}, "
                               f"the wrapper expects {want}")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.group_norm_stats.argtypes = (
        [i, p, i, i, i, i, i, ll, i, p, p, p, p, ctypes.c_float, p, p, i, ll, p, p, p, ll, p, p,
         i, p]
    )
    lib.group_norm_stats.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library():
    lib = load_library("group_norm_bwd")
    for fn, want in ((lib.group_norm_bwd_tile, BWD_TILE),
                     (lib.group_norm_bwd_max_slices, BWD_MAX_SLICES),
                     (lib.group_norm_bwd_cluster_max, BWD_CLUSTER_MAX),
                     (lib.group_norm_bwd_block_elems, BWD_BLOCK_ELEMS),
                     (lib.group_norm_bwd_max_smem, BWD_MAX_SMEM)):
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"csrc/group_norm_bwd.cu: {fn.__name__} is {fn()}, "
                               f"the wrapper expects {want}")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.group_norm_bwd_cluster_smem.argtypes = [i, ll]
    lib.group_norm_bwd_cluster_smem.restype = ll
    for cpg, chunk in ((1, 8000), (5, 840), (16, BWD_BLOCK_ELEMS)):
        if lib.group_norm_bwd_cluster_smem(cpg, chunk) != _bwd_cluster_smem(cpg, chunk):
            raise RuntimeError("csrc/group_norm_bwd.cu: a cluster block's shared memory "
                               "differs from the wrapper's _bwd_cluster_smem")
    lib.group_norm_bwd_reduce.argtypes = [
        i, p, p, i, i, ll, i, i, ll, i, p, p, p, p, ctypes.c_float, p, p, p, p, i, ll, i, p, p, p,
    ]
    lib.group_norm_bwd_reduce.restype = i
    lib.group_norm_bwd_dx.argtypes = [
        i, p, p, p, i, i, ll, i, i, p, p, ctypes.c_float, p, p, p, p, i, ll, i, p, p, ll, p,
    ]
    lib.group_norm_bwd_dx.restype = i
    lib.group_norm_bwd_cluster.argtypes = [
        i, p, p, p, i, i, ll, i, i, ll, i, p, p, ctypes.c_float, p, p, p, p, i, ll, i, p, p, p,
    ]
    lib.group_norm_bwd_cluster.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch_stats(x, num_groups, out_mean, out_a, out_b, out_ld,
                  weight=None, bias=None, eps=0.0, film: Film = None, out_group=None,
                  scale=None, slices=None) -> None:
    """One launch of the statistics kernel (see csrc/group_norm_stats.cu);
    ``scale`` marks x as int8 codes. ``slices`` (1 to STATS_MAX_SLICES)
    overrides the blocks a span takes, which otherwise fill the card."""
    n, c, t = x.shape
    spans, span = n * num_groups, (c // num_groups) * t
    if slices is None:
        target = sm_count(x.device) * STATS_BLOCKS_PER_SM
        slices = max(1, min(target // max(spans, 1), -(-span // STATS_TILE), STATS_MAX_SLICES))
    chunk = -(-span // slices)
    step = 16 if scale is not None else 8  # a slice starts on a 16-byte load
    chunk = -(-chunk // step) * step
    per_channel = scale is not None and scale.ndim == 1
    # 16-byte loads need the span, and so every slice, to start 16-byte
    # aligned; with one scale a channel, no load may straddle two channels.
    row = t if per_channel else span
    vec = row % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
    part = None
    if slices > 1:  # 16 bytes a partial; int8 with one scale a channel, one a channel
        rows = c // num_groups if per_channel else 1
        part = torch.empty(spans * rows * slices * 4, dtype=torch.float32, device=x.device)
    ca = cb = None
    film_code, film_ld = 0, 0
    if film is not None:
        ca, cb = film
        film_code, film_ld = _DTYPE_CODE[ca.dtype], ca.stride(0)
    dtype_code = 2 if scale is not None else _DTYPE_CODE[x.dtype]
    scale_stride = int(per_channel)
    stream = torch.cuda.current_stream(x.device)
    with torch.cuda.device(x.device):
        err = _stats_library().group_norm_stats(
            dtype_code, x.data_ptr(), n, c, t, num_groups, slices, chunk,
            int(vec), _ptr(part), tickets(stream, spans).data_ptr(), _ptr(weight),
            _ptr(bias), float(eps), _ptr(ca), _ptr(cb), film_code, film_ld,
            out_mean.data_ptr(), out_a.data_ptr(), _ptr(out_b), out_ld, _ptr(out_group),
            _ptr(scale), scale_stride, stream.cuda_stream,
        )
    if err:
        raise RuntimeError(f"group_norm_stats kernel launch failed: CUDA error {err}")


def group_norm_coeffs(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    film: Film = None,
    out: Optional[torch.Tensor] = None,
    stats: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Float32 per-channel (mean, a, b) [N, C] of GroupNorm over [N, C, T]
    with affine ``weight``/``bias`` [C] and optional FiLM (ca, cb) [N, C]
    folded in, as ``group_norm_apply`` takes them: one kernel launch on the
    card. ``out``, a float32 [3, N, C] view with unit channel stride (e.g.
    the column slice of a wider [3, N, Cin] buffer), receives them. With
    ``stats``, the same launch also writes the group (mean, var) [N, G],
    returned after them, as ``group_norm_backward`` takes them."""
    _check_x(x)
    _check_groups(x, num_groups)
    _check_coeffs(x, weight, bias, film, out)
    if x.device.type == "cpu":
        return group_norm_coeffs_plain(x, num_groups, weight, bias, eps, film, out, stats)
    n, c, _ = x.shape
    if out is None:
        out = torch.empty((3, n, c), dtype=torch.float32, device=x.device)
    group = None
    if stats:
        group = torch.empty((2, n, num_groups), dtype=torch.float32, device=x.device)
    _launch_stats(x, num_groups, out[0], out[1], out[2], out.stride(1),
                  weight.float().contiguous(), bias.float().contiguous(), eps, film, group)
    group_norm_coeffs.launches += 1
    if stats:
        return out[0], out[1], out[2], group[0], group[1]
    return out[0], out[1], out[2]


def group_norm_stats(
    x: torch.Tensor, num_groups: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 group mean and biased variance of [N, C, T], [N, G] each."""
    _check_x(x)
    _check_groups(x, num_groups)
    if x.device.type == "cpu":
        return group_stats_plain(x, num_groups)
    n = x.shape[0]
    stats = torch.empty((2, n, num_groups), dtype=torch.float32, device=x.device)
    _launch_stats(x, num_groups, stats[0], stats[1], None, num_groups)
    group_norm_stats.launches += 1
    return stats[0], stats[1]


def group_norm_apply(
    x: torch.Tensor,
    mean: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    use_gelu: bool,
) -> torch.Tensor:
    """y = (x - mean) * a + b per (n, channel) row of [N, C, T], optional
    exact GELU, in x's dtype. mean/a/b: float32 contiguous [N, C]."""
    _check_x(x)
    check_apply_coeffs(x, mean, a, b)
    if x.device.type == "cpu":
        return group_norm_apply_plain(x, mean, a, b, use_gelu)
    y = torch.empty_like(x)
    _launch_apply(x, mean, a, b, use_gelu, y)
    group_norm_apply.launches += 1
    return y


def check_apply_coeffs(x, mean, a, b) -> None:
    for name, v in (("mean", mean), ("a", a), ("b", b)):
        if v.shape != x.shape[:2] or v.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 {tuple(x.shape[:2])}, got "
                f"{v.dtype} {tuple(v.shape)}"
            )
        if not v.is_contiguous() or v.device != x.device:
            raise ValueError(f"{name} must be contiguous on {x.device}")


def _launch_apply(x, mean, a, b, use_gelu, y, scale=None) -> None:
    """One launch of the Triton apply kernel; ``scale`` marks x as int8 codes."""
    triton, apply_kernel = _apply_kernel()
    n, c, t = x.shape
    block = min(APPLY_BLOCK, triton.next_power_of_2(t))
    stride = 0 if scale is None or scale.ndim == 0 else 1
    with torch.cuda.device(x.device):
        apply_kernel[(n * c, triton.cdiv(t, block))](
            x, mean, a, b, y, t, mean if scale is None else scale, c, stride,
            GELU=use_gelu, INT8=scale is not None, BLOCK=block, num_warps=4,
        )


def group_norm_coeffs_int8(
    q: torch.Tensor,
    scale: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    stats: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``group_norm_coeffs`` (no FiLM) of the values q * scale of int8
    codes q [N, C, T] and a float32 scale () or (C,): one launch of the
    statistics kernel's int8 mode on the card (exact integer sums of the
    codes, the scale applied once a channel; ``group_norm_coeffs_int8_plain``
    is its arithmetic). With ``stats``, the group (mean, var) [N, G] follow."""
    check_codes(q, scale)
    _check_groups(q, num_groups)
    _check_coeffs(q, weight, bias, None, None)
    if q.device.type == "cpu":
        return group_norm_coeffs_int8_plain(q, scale, num_groups, weight, bias, eps, stats)
    out = torch.empty((3, *q.shape[:2]), dtype=torch.float32, device=q.device)
    group = None
    if stats:
        group = torch.empty((2, q.shape[0], num_groups), dtype=torch.float32, device=q.device)
    _launch_stats(q, num_groups, out[0], out[1], out[2], out.stride(1),
                  weight.float().contiguous(), bias.float().contiguous(), eps, None, group,
                  scale)
    group_norm_coeffs_int8.launches += 1
    if stats:
        return out[0], out[1], out[2], group[0], group[1]
    return out[0], out[1], out[2]


def group_norm_apply_int8(
    q: torch.Tensor,
    scale: torch.Tensor,
    mean: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    use_gelu: bool,
    dtype: torch.dtype,
) -> torch.Tensor:
    """``group_norm_apply`` of the values q * scale of int8 codes, the
    output in ``dtype`` (float32 or bfloat16): one launch of the Triton
    apply kernel's int8 mode on the card."""
    check_codes(q, scale)
    check_apply_coeffs(q, mean, a, b)
    if dtype not in _DTYPES:
        raise ValueError(f"GroupNorm writes float32 or bfloat16, not {dtype}")
    if q.device.type == "cpu":
        return group_norm_apply_plain(dequantize_codes(q, scale), mean, a, b, use_gelu).to(dtype)
    y = torch.empty(q.shape, dtype=dtype, device=q.device)
    _launch_apply(q, mean, a, b, use_gelu, y, scale)
    group_norm_apply_int8.launches += 1
    return y


def group_norm_backward(
    x: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    use_gelu: bool,
    film: Film = None,
    stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``group_norm`` at x for an output gradient dy (x's
    dtype and shape): (dx in x's dtype, float32 S1 = sum_t dz and
    S2 = sum_t dz * xhat [N, C], for ``group_norm_param_grads``). ``stats``
    is the forward's group (mean, var), float32 [N, G] each
    (``group_norm_coeffs(..., stats=True)``); without it the card first runs
    the statistics kernel. On the card, the backward kernel by the route of
    ``bwd_route``: one launch, or two beyond a cluster's capacity."""
    _check_bwd(x, dy, num_groups, weight, bias, film, stats)
    if x.device.type == "cpu":
        return group_norm_backward_plain(x, dy, num_groups, weight, bias, eps, use_gelu, film,
                                         stats)
    mean, var = group_norm_stats(x, num_groups) if stats is None else stats
    return _launch_bwd(x, dy, num_groups, mean, var, weight, bias, eps, use_gelu, film)


def _check_bwd(x, dy, num_groups, weight, bias, film, stats, sums=None) -> None:
    _check_x(x)
    _check_groups(x, num_groups)
    _check_coeffs(x, weight, bias, film, None)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be {x.dtype} {tuple(x.shape)} on {x.device}, got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if not dy.is_contiguous():
        raise ValueError("dy must be contiguous")
    for name, vals, want in (("stats", stats, (x.shape[0], num_groups)),
                             ("S1 and S2", sums, tuple(x.shape[:2]))):
        for v in vals or ():
            if (v.shape != want or v.dtype != torch.float32 or v.device != x.device
                    or not v.is_contiguous()):
                raise ValueError(f"{name} must be contiguous float32 {want} on {x.device}, "
                                 f"got {v.dtype} {tuple(v.shape)} on {v.device}")


def _bwd_args(mean, var, weight, bias, eps, use_gelu, film):
    """(the float32 affine to keep alive until the launch is queued, the C
    arguments from the statistics to the GELU flag)."""
    ca = cb = None
    film_code, film_ld = 0, 0
    if film is not None:
        ca, cb = film
        film_code, film_ld = _DTYPE_CODE[ca.dtype], ca.stride(0)
    w32, b32 = weight.float().contiguous(), bias.float().contiguous()
    return (w32, b32), (mean.data_ptr(), var.data_ptr(), float(eps), w32.data_ptr(),
                        b32.data_ptr(), _ptr(ca), _ptr(cb), film_code, film_ld, int(use_gelu))


def _vec(t: int, *tensors: torch.Tensor) -> bool:
    """16-byte accesses: T a multiple of 16 bytes, every tensor aligned."""
    return t % (16 // tensors[0].element_size()) == 0 and all(
        v.data_ptr() % 16 == 0 for v in tensors)


def _reduce_launch(x, dy, num_groups, slices, chunk, args, sums, stream) -> None:
    """One launch of the reduce kernel: the per-row S1, S2 of x and dy into
    ``sums`` [2, N, C]; a row split over several blocks merges through a
    per-row ticket."""
    n, c, t = x.shape
    part = ticket = None
    if slices > 1:
        part = torch.empty(n * c * slices * 2, dtype=torch.float32, device=x.device)
        ticket = tickets(stream, n * c)
    with torch.cuda.device(x.device):
        err = _bwd_library().group_norm_bwd_reduce(
            _DTYPE_CODE[x.dtype], x.data_ptr(), dy.data_ptr(), n, c, t, num_groups, slices,
            chunk, int(_vec(t, x, dy)), _ptr(part), _ptr(ticket), *args, sums[0].data_ptr(),
            sums[1].data_ptr(), stream.cuda_stream)
    if err:
        raise RuntimeError(f"group_norm_bwd_reduce kernel launch failed: CUDA error {err}")


def _dx_launch(x, dy, dx, num_groups, args, s1, s2, count, stream) -> None:
    """One launch of the dx kernel, from the group's S1, S2 and count."""
    n, c, t = x.shape
    with torch.cuda.device(x.device):
        err = _bwd_library().group_norm_bwd_dx(
            _DTYPE_CODE[x.dtype], x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, c, t,
            num_groups, int(_vec(t, x, dy, dx)), *args, s1.data_ptr(), s2.data_ptr(),
            int(count), stream.cuda_stream)
    if err:
        raise RuntimeError(f"group_norm_bwd_dx kernel launch failed: CUDA error {err}")


def group_norm_bwd_reduce(
    x: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    mean: torch.Tensor,
    var: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    use_gelu: bool,
    film: Film = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-row float32 S1 = sum_t dz and S2 = sum_t dz * xhat [N, C] of
    x and dy, from the group (mean, var) [N, G] of the whole group (which
    may span other ranks' shards of x): the two-kernel route's reduce
    launch alone on the card."""
    _check_bwd(x, dy, num_groups, weight, bias, film, (mean, var))
    if x.device.type == "cpu":
        return group_norm_bwd_reduce_plain(x, dy, num_groups, mean, var, weight, bias, eps,
                                           use_gelu, film)
    sums = torch.empty((2, *x.shape[:2]), dtype=torch.float32, device=x.device)
    keep, args = _bwd_args(mean, var, weight, bias, eps, use_gelu, film)
    _reduce_launch(x, dy, num_groups, *bwd_slices(x), args, sums,
                   torch.cuda.current_stream(x.device))
    del keep
    group_norm_bwd_reduce.launches += 1
    return sums[0], sums[1]


def group_norm_bwd_dx(
    x: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    mean: torch.Tensor,
    var: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    use_gelu: bool,
    film: Film,
    s1: torch.Tensor,
    s2: torch.Tensor,
    count: int,
) -> torch.Tensor:
    """dx in x's dtype from the whole group's per-row S1, S2 [N, C] (this
    tensor's from ``group_norm_bwd_reduce``, or their sum over the ranks
    that hold the group's shards) and ``count``, the group's elements over
    all its shards (C/G * T on one device): the two-kernel route's dx
    launch alone on the card."""
    _check_bwd(x, dy, num_groups, weight, bias, film, (mean, var), (s1, s2))
    if count < x.shape[1] // num_groups * x.shape[2]:
        raise ValueError(f"a group of {count} elements is smaller than this shard's")
    if x.device.type == "cpu":
        return group_norm_bwd_dx_plain(x, dy, num_groups, mean, var, weight, bias, eps,
                                       use_gelu, film, s1, s2, count)
    dx = torch.empty_like(x)
    keep, args = _bwd_args(mean, var, weight, bias, eps, use_gelu, film)
    _dx_launch(x, dy, dx, num_groups, args, s1, s2, count, torch.cuda.current_stream(x.device))
    del keep
    group_norm_bwd_dx.launches += 1
    return dx


class BwdRoute(NamedTuple):
    """How the backward runs: ``name`` "cluster" (one launch, ``blocks``
    blocks of a thread-block cluster per (n, group) span, ``chunk`` span
    elements each) or "two_kernel" (reduce + dx, ``blocks`` reduce blocks
    per (n, channel) row, ``chunk`` row elements each)."""

    name: str
    blocks: int
    chunk: int


def _round8(v: int) -> int:
    return -(-v // 8) * 8


def _bwd_cluster_smem(cpg: int, chunk: int) -> int:
    """Shared memory of one cluster block (csrc/group_norm_bwd.cu
    ``cluster_smem``): header and per-channel partials, then 8 bytes an
    element (x, dy, and dz in float32 for bfloat16)."""
    return -(-(BWD_HEADER + 8 * cpg) // 16) * 16 + 8 * chunk


def bwd_slices(x: torch.Tensor, sms: Optional[int] = None) -> Tuple[int, int]:
    """(slices, chunk) of the two-kernel route: its reduce splits each
    (n, c) row of x over ``slices`` blocks of ``chunk`` samples (a multiple
    of 8), so that few rows still fill the card; with more than one, the
    last block of a row merges the slices' partial sums in slice order."""
    n, c, t = x.shape
    rows = n * c
    sms = sm_count(x.device) if sms is None else sms
    target = sms * BWD_BLOCKS_PER_SM
    slices = max(1, min(target // max(rows, 1), -(-t // BWD_TILE), BWD_MAX_SLICES))
    return slices, _round8(-(-t // slices))


def bwd_route(x: torch.Tensor, num_groups: int, sms: Optional[int] = None) -> BwdRoute:
    """The backward's route for x (any tensor of x's shape and dtype, a
    ``meta`` one included) on a card of ``sms`` SMs (default: x's card): a
    pure function of those and the kernel's limits. The cluster route when
    a (n, group) span of C/G * T elements fits BWD_CLUSTER_MAX blocks, with
    the fewest blocks (a power of two) that keep each block within
    BWD_TARGET_ELEMS and give the card BWD_FILL blocks per SM; else the
    two-kernel route. At 16 kHz a span outgrows the cluster beyond 14.3 s
    of audio at a unet32's first level (its up path's 64 channels, two a
    group), 7.2 s at a unet64's (128 channels, four a group) and 28.7 s at
    a classifier's (one)."""
    n, c, t = x.shape
    cpg = c // num_groups
    span, spans = cpg * t, n * num_groups
    sms = sm_count(x.device) if sms is None else sms
    chosen = None
    k = 1
    while k <= BWD_CLUSTER_MAX:
        chunk = _round8(-(-span // k))
        if chunk <= BWD_BLOCK_ELEMS and _bwd_cluster_smem(cpg, chunk) <= BWD_MAX_SMEM:
            chosen = BwdRoute("cluster", k, chunk)
            if chunk <= BWD_MIN_ELEMS or (chunk <= BWD_TARGET_ELEMS
                                          and spans * k >= BWD_FILL * sms):
                break
        k *= 2
    return chosen or BwdRoute("two_kernel", *bwd_slices(x, sms))


def _launch_bwd(x, dy, num_groups, mean, var, weight, bias, eps, use_gelu, film,
                route: Optional[BwdRoute] = None):
    """The backward kernel from x's group (mean, var), by ``route``
    (default ``bwd_route``); counts each launch in ``group_norm_backward``
    and in its route's launcher."""
    route = route or bwd_route(x, num_groups)
    dx = torch.empty_like(x)
    sums = torch.empty((2, *x.shape[:2]), dtype=torch.float32, device=x.device)
    keep, args = _bwd_args(mean, var, weight, bias, eps, use_gelu, film)
    launcher = _bwd_cluster if route.name == "cluster" else _bwd_two_kernel
    launcher(x, dy, dx, num_groups, route, args, sums, torch.cuda.current_stream(x.device))
    del keep
    return dx, sums[0], sums[1]


def _bwd_cluster(x, dy, dx, num_groups, route, args, sums, stream) -> None:
    """One launch of the cluster kernel."""
    n, c, t = x.shape
    with torch.cuda.device(x.device):
        err = _bwd_library().group_norm_bwd_cluster(
            _DTYPE_CODE[x.dtype], x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, c, t,
            num_groups, route.blocks, route.chunk, int(_vec(t, x, dy, dx)), *args,
            sums[0].data_ptr(), sums[1].data_ptr(), stream.cuda_stream)
    if err:
        raise RuntimeError(f"group_norm_bwd_cluster kernel launch failed: CUDA error {err}")
    _bwd_cluster.launches += 1
    group_norm_backward.launches += 1


def _bwd_two_kernel(x, dy, dx, num_groups, route, args, sums, stream) -> None:
    """The reduce and dx launches, the group's count this tensor's."""
    _reduce_launch(x, dy, num_groups, route.blocks, route.chunk, args, sums, stream)
    count = x.shape[1] // num_groups * x.shape[2]
    _dx_launch(x, dy, dx, num_groups, args, sums[0], sums[1], count, stream)
    _bwd_two_kernel.launches += 2
    group_norm_backward.launches += 2


group_norm_coeffs.launches = 0
group_norm_stats.launches = 0
group_norm_apply.launches = 0
group_norm_coeffs_int8.launches = 0
group_norm_apply_int8.launches = 0
group_norm_backward.launches = 0
group_norm_bwd_reduce.launches = 0
group_norm_bwd_dx.launches = 0
_bwd_cluster.launches = 0
_bwd_two_kernel.launches = 0


class GroupNormFunction(torch.autograd.Function):
    """``group_norm`` with its backward: forward ``group_norm_coeffs`` +
    ``group_norm_apply`` (the same launches and outputs as without grad; the
    statistics launch also writes the group (mean, var), saved with x),
    backward ``group_norm_backward`` from those statistics, with the
    parameter gradients formed only when asked for. ca and cb are the FiLM
    pair (both None without FiLM)."""

    @staticmethod
    def forward(ctx, x, weight, bias, ca, cb, num_groups, eps, use_gelu):
        film = None if ca is None else (ca, cb)
        mean_c, a, b, mean, var = group_norm_coeffs(x, num_groups, weight, bias, eps, film,
                                                    stats=True)
        ctx.save_for_backward(x, weight, bias, ca, cb, mean, var)
        ctx.num_groups, ctx.eps, ctx.use_gelu = num_groups, eps, use_gelu
        return group_norm_apply(x, mean_c, a, b, use_gelu)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, ca, cb, mean, var = ctx.saved_tensors
        film = None if ca is None else (ca, cb)
        dx, s1, s2 = group_norm_backward(x, dy.contiguous(), ctx.num_groups, weight, bias,
                                         ctx.eps, ctx.use_gelu, film, (mean, var))
        grads = [dx if ctx.needs_input_grad[0] else None, None, None, None, None]
        if any(ctx.needs_input_grad[1:5]):
            params = (weight, bias, ca, cb)
            for i, g in enumerate(group_norm_param_grads(s1, s2, weight, bias, film), 1):
                if ctx.needs_input_grad[i]:
                    grads[i] = g.to(params[i - 1].dtype)
        return (*grads, None, None, None)


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float,
    use_gelu: bool,
    film: Film = None,
) -> torch.Tensor:
    """GroupNorm over the channels of [N, C, T] with float32 statistics,
    then optional FiLM h*(ca+1)+cb and exact GELU; output in x's dtype.
    On CUDA with grad enabled and an input that requires it, through
    ``GroupNormFunction``; otherwise the two forward kernels alone (on the
    CPU, autograd runs through the plain versions)."""
    inputs = (x, weight, bias) + tuple(film or ())
    if (x.device.type == "cuda" and torch.is_grad_enabled()
            and any(v.requires_grad for v in inputs)):
        ca, cb = film or (None, None)
        return GroupNormFunction.apply(x, weight, bias, ca, cb, num_groups, eps, use_gelu)
    mean_c, a, b = group_norm_coeffs(x, num_groups, weight, bias, eps, film)
    return group_norm_apply(x, mean_c, a, b, use_gelu)
