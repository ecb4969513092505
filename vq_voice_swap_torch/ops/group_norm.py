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
torch op between them. Both kernels are memory-bound streaming passes: the
bound is x read once (statistics), and x read once plus y written once
(apply), at the card's memory rate. Wrappers use the plain versions for
CPU tensors and launch the kernels for CUDA tensors, with no fallback
between them; each counts its launches.
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .cuda_build import load_library
from .tickets import tickets

__all__ = [
    "group_norm",
    "group_norm_coeffs",
    "group_norm_coeffs_plain",
    "group_norm_stats",
    "group_norm_apply",
    "group_stats_plain",
    "group_norm_apply_plain",
    "merge_partials",
    "fold_affine",
]

APPLY_BLOCK = 4096  # largest T-block of one apply program
# The statistics kernel's pass over a span, its limit on slices per span
# (csrc/group_norm_stats.cu reports both; _stats_library() checks them) and
# its blocks resident on one SM (its __launch_bounds__).
STATS_TILE = 256 * 32
STATS_MAX_SLICES = 256
STATS_BLOCKS_PER_SM = 4
MAX_SPAN = 1 << 24  # float32 counts stay exact below this

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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``group_norm_coeffs`` in plain PyTorch: ``fold_affine`` of
    ``group_stats_plain``, copied into ``out`` when given."""
    coeffs = fold_affine(*group_stats_plain(x, num_groups), weight, bias, eps, film)
    if out is None:
        return coeffs
    for dst, src in zip(out, coeffs):
        dst.copy_(src)
    return tuple(out)


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _apply_kernel():
    """Define the Triton apply kernel at first launch (triton is imported
    here, never at module import: the CPU has no triton)."""
    global tl  # the kernel resolves `tl` from this module's globals
    import triton
    import triton.language as tl

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
        [i, p, i, i, i, i, i, ll, i, p, p, p, p, ctypes.c_float, p, p, i, ll, p, p, p, ll, p]
    )
    lib.group_norm_stats.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch_stats(x, num_groups, out_mean, out_a, out_b, out_ld,
                  weight=None, bias=None, eps=0.0, film: Film = None) -> None:
    """One launch of the statistics kernel (see csrc/group_norm_stats.cu)."""
    n, c, t = x.shape
    spans, span = n * num_groups, (c // num_groups) * t
    if span >= MAX_SPAN:
        raise ValueError(f"GroupNorm group of {span} elements: the kernel takes "
                         f"fewer than {MAX_SPAN}")
    target = _sm_count(x.device) * STATS_BLOCKS_PER_SM
    slices = max(1, min(target // max(spans, 1), -(-span // STATS_TILE), STATS_MAX_SLICES))
    chunk = -(-span // slices)
    chunk = -(-chunk // 8) * 8
    # 16-byte loads need the span, and so every slice, to start 16-byte aligned.
    vec = span % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
    part = None
    if slices > 1:
        part = torch.empty(spans * slices * 3, dtype=torch.float32, device=x.device)
    ca = cb = None
    film_code, film_ld = 0, 0
    if film is not None:
        ca, cb = film
        film_code, film_ld = _DTYPE_CODE[ca.dtype], ca.stride(0)
    stream = torch.cuda.current_stream(x.device)
    with torch.cuda.device(x.device):
        err = _stats_library().group_norm_stats(
            _DTYPE_CODE[x.dtype], x.data_ptr(), n, c, t, num_groups, slices, chunk,
            int(vec), _ptr(part), tickets(stream, spans).data_ptr(), _ptr(weight),
            _ptr(bias), float(eps), _ptr(ca), _ptr(cb), film_code, film_ld,
            out_mean.data_ptr(), out_a.data_ptr(), _ptr(out_b), out_ld, stream.cuda_stream,
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Float32 per-channel (mean, a, b) [N, C] of GroupNorm over [N, C, T]
    with affine ``weight``/``bias`` [C] and optional FiLM (ca, cb) [N, C]
    folded in, as ``group_norm_apply`` takes them: one kernel launch on the
    card. ``out``, a float32 [3, N, C] view with unit channel stride (e.g.
    the column slice of a wider [3, N, Cin] buffer), receives them."""
    _check_x(x)
    _check_groups(x, num_groups)
    _check_coeffs(x, weight, bias, film, out)
    if x.device.type == "cpu":
        return group_norm_coeffs_plain(x, num_groups, weight, bias, eps, film, out)
    n, c, _ = x.shape
    if out is None:
        out = torch.empty((3, n, c), dtype=torch.float32, device=x.device)
    _launch_stats(x, num_groups, out[0], out[1], out[2], out.stride(1),
                  weight.float().contiguous(), bias.float().contiguous(), eps, film)
    group_norm_coeffs.launches += 1
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
    triton, apply_kernel = _apply_kernel()
    n, c, t = x.shape
    block = min(APPLY_BLOCK, triton.next_power_of_2(t))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        apply_kernel[(n * c, triton.cdiv(t, block))](
            x, mean, a, b, y, t, GELU=use_gelu, BLOCK=block, num_warps=4,
        )
    group_norm_apply.launches += 1
    return y


group_norm_coeffs.launches = 0
group_norm_stats.launches = 0
group_norm_apply.launches = 0


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
    then optional FiLM h*(ca+1)+cb and exact GELU; output in x's dtype."""
    mean_c, a, b = group_norm_coeffs(x, num_groups, weight, bias, eps, film)
    return group_norm_apply(x, mean_c, a, b, use_gelu)
