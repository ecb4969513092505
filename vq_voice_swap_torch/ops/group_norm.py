"""GroupNorm (+ optional FiLM and exact GELU) over [N, C, T]: two
hand-written Triton kernels and their plain PyTorch versions.

Counterpart of ``vq_voice_swap_tpu/ops/fused_norm.py``:

- ``group_norm_stats`` replaces ``_stats_kernel`` (fused_norm.py:84). Each
  (n, group) of a contiguous [N, C, T] tensor is one contiguous span of
  C/G*T elements. A program reads one chunk of a span once and writes its
  float32 (count, mean, M2) partial; per-lane Welford updates and a Chan
  merge across lanes keep it free of the one-pass E[x^2] - mean^2
  cancellation. The chunk partials merge in torch (tiny [N*G, S] ops), with
  no atomics, so the result is the same from run to run.
- ``group_norm_apply`` replaces ``_apply_kernel`` (fused_norm.py:115):
  y = (x - mean) * a + b per (n, channel) row, then optional exact-erf GELU,
  stored in x's dtype. Subtracting the mean first (rather than folding it
  into b) keeps large-mean inputs accurate. A FiLM h*(ca+1)+cb folds into
  a and b on the [N, C] side (``fold_affine``), so one apply covers
  norm_in, norm_mid and out_norm.

Both are memory-bound streaming passes: the bound is x read once (stats),
and x read once plus y written once (apply), at the card's memory rate.
Wrappers use the plain versions for CPU tensors and launch the kernels for
CUDA tensors, with no fallback between them; each counts its launches.
"""

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "group_norm",
    "group_norm_stats",
    "group_norm_apply",
    "group_stats_plain",
    "group_norm_apply_plain",
    "merge_partials",
    "fold_affine",
]

STATS_BLOCK = 1024  # lanes of one statistics program
STATS_CHUNK = 16 * STATS_BLOCK  # span elements one statistics program reads
APPLY_BLOCK = 4096  # largest T-block of one apply program

_DTYPES = (torch.float32, torch.bfloat16)


def _check_x(x: torch.Tensor) -> None:
    if x.ndim != 3:
        raise ValueError(f"expected x [N, C, T], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"GroupNorm takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("GroupNorm takes a contiguous [N, C, T] tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"GroupNorm runs on CPU or CUDA, not {x.device}")


# ------------------------------------------------------------ plain versions


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
    film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
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


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _kernels():
    """Define the Triton kernels at first launch (triton is imported here,
    never at module import: the CPU has no triton)."""
    global tl  # the kernels resolve `tl` from this module's globals
    import triton
    import triton.language as tl

    @triton.jit
    def stats_kernel(x_ptr, cnt_ptr, mean_ptr, m2_ptr, span, n_chunks,
                     CHUNK: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        chunk = tl.program_id(1)
        base = x_ptr + row.to(tl.int64) * span
        lanes = chunk * CHUNK + tl.arange(0, BLOCK)
        n = tl.zeros([BLOCK], tl.float32)
        mu = tl.zeros([BLOCK], tl.float32)
        m2 = tl.zeros([BLOCK], tl.float32)
        for off in range(0, CHUNK, BLOCK):
            idx = lanes + off
            mask = idx < span
            x = tl.load(base + idx, mask=mask, other=0.0).to(tl.float32)
            n_new = n + mask.to(tl.float32)
            delta = x - mu
            mu = tl.where(mask, mu + delta / tl.maximum(n_new, 1.0), mu)
            m2 = tl.where(mask, m2 + delta * (x - mu), m2)
            n = n_new
        total = tl.sum(n, axis=0)
        mean = tl.sum(n * mu, axis=0) / tl.maximum(total, 1.0)
        dev = mu - mean
        out = row * n_chunks + chunk
        tl.store(cnt_ptr + out, total)
        tl.store(mean_ptr + out, mean)
        tl.store(m2_ptr + out, tl.sum(m2 + n * dev * dev, axis=0))

    @triton.jit
    def apply_kernel(x_ptr, mean_ptr, a_ptr, b_ptr, y_ptr, T,
                     GELU: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        idx = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        mask = idx < T
        offs = row.to(tl.int64) * T + idx
        mean = tl.load(mean_ptr + row)
        a = tl.load(a_ptr + row)
        b = tl.load(b_ptr + row)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = (x - mean) * a + b
        if GELU:
            y = 0.5 * y * (1.0 + tl.math.erf(y * 0.7071067811865476))
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, stats_kernel, apply_kernel


def group_norm_stats(
    x: torch.Tensor, num_groups: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 group mean and biased variance of [N, C, T], [N, G] each."""
    _check_x(x)
    n, c, t = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if x.device.type == "cpu":
        return group_stats_plain(x, num_groups)
    triton, stats_kernel, _ = _kernels()
    rows, span = n * num_groups, (c // num_groups) * t
    n_chunks = triton.cdiv(span, STATS_CHUNK)
    partials = torch.empty((3, rows, n_chunks), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stats_kernel[(rows, n_chunks)](
            x, partials[0], partials[1], partials[2], span, n_chunks,
            CHUNK=STATS_CHUNK, BLOCK=STATS_BLOCK, num_warps=4,
        )
    group_norm_stats.launches += 1
    mean, var = merge_partials(partials[0], partials[1], partials[2])
    return mean.view(n, num_groups), var.view(n, num_groups)


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
    for name, v in (("mean", mean), ("a", a), ("b", b)):
        if v.shape != x.shape[:2] or v.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 {tuple(x.shape[:2])}, got "
                f"{v.dtype} {tuple(v.shape)}"
            )
        if not v.is_contiguous() or v.device != x.device:
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if x.device.type == "cpu":
        return group_norm_apply_plain(x, mean, a, b, use_gelu)
    triton, _, apply_kernel = _kernels()
    n, c, t = x.shape
    block = min(APPLY_BLOCK, triton.next_power_of_2(t))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        apply_kernel[(n * c, triton.cdiv(t, block))](
            x, mean, a, b, y, t, GELU=use_gelu, BLOCK=block, num_warps=4,
        )
    group_norm_apply.launches += 1
    return y


group_norm_stats.launches = 0
group_norm_apply.launches = 0


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float,
    use_gelu: bool,
    film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """GroupNorm over the channels of [N, C, T] with float32 statistics,
    then optional FiLM h*(ca+1)+cb and exact GELU; output in x's dtype."""
    mean, var = group_norm_stats(x, num_groups)
    mean_c, a, b = fold_affine(mean, var, weight, bias, eps, film)
    return group_norm_apply(x, mean_c, a, b, use_gelu)
