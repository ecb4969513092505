"""int8-stored activations for the serving path, on [N, C, T] (counterpart of
``vq_voice_swap_tpu/ops/qact.py``; the same public names).

An activation that crosses a layer boundary at the UNet's long levels is
stored as int8 codes with one dynamic symmetric float32 scale
(``QAct``); its consumers dequantize in registers, and the convolutions
multiply int8 by int8 into exact int32 sums. Weights stay float32 in the
checkpoint and are quantized per output channel. A serving-only knob, off
by default (``act_int8_min_t``, models/layers.py).

On the card, three hand-written kernels (none replaces a Pallas kernel:
the JAX package leaves all of this to XLA, and PyTorch has no int8
convolution that sums into int32):

- the quantize kernels, Triton, here: an amax pass whose programs each
  write a partial, the last of them to finish (a ticket, ops/tickets.py)
  reducing the partials to the scale on the card (no host sync, no zeroed
  buffer), and a codes pass that writes the codes, with JAX's IEEE division
  (``div_rn``) and round-half-even (``rint``), so the codes have JAX's
  bits. Both passes take the tensor's producer as a prologue and
  recompute its output from the producer's own inputs, rounded to the
  compute dtype as the producer would store it, so that output never goes
  to device memory: ``quantize_group_norm`` (the GroupNorm apply, the
  apply kernel's own body, ``ops/group_norm.py``'s ``apply_helpers``, on
  float or int8 input), ``quantize_residual`` (the residual add, an int8
  skip dequantized in registers) and ``quantize`` (no prologue). XLA does
  the same: it rematerialises the producer inside the quantizing fusion.
  What bounds them on the card: bytes, the producer's inputs read twice
  and the codes written once (an int8 GroupNorm input: 3 bytes an
  element, where the apply and a quantize of its float output moved 14 in
  float32).
- ``conv1d_int8``: ``csrc/conv1d_int8.cu``, an implicit GEMM on the int8
  tensor cores (mma.sync m16n8k32) with the float32 epilogue fused.
- ``qact_group_norm``: the GroupNorm statistics and apply kernels' int8
  modes (``ops/group_norm.py``), two launches; the statistics alone where
  the output is quantized (``quantize_group_norm``).

``qact_concat``, ``qact_avg_pool``, ``qact_upsample`` and ``dequantize``
are plain PyTorch, as XLA ran them. Every wrapper uses its plain version
for CPU tensors and launches its kernel for CUDA tensors, with no fallback;
each counts its launches.

``QAct.scale`` is a float32 tensor on the codes' device, of shape () (one
scale for the tensor) or (C,) (one a channel: only ``qact_concat`` makes
it). ``QAct.dtype`` is the compute dtype of the tensor that was quantized,
which the consumers write (the JAX package takes it from the module's
``dtype``).

Where the port's numbers differ from the JAX package's: ``qact_group_norm``
takes two-pass statistics where JAX takes E[x^2] - mean^2
(ops/qact.py:138-143), as the port's float GroupNorm does.
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .cuda_build import load_library
from .group_norm import (apply_helpers, check_apply_coeffs, check_codes, dequantize_codes,
                         group_norm_apply_int8, group_norm_apply_plain,
                         group_norm_coeffs_int8, group_norm_coeffs_int8_plain, sm_count)
from .tickets import tickets

__all__ = [
    "QAct",
    "quantize",
    "quantize_plain",
    "quantize_group_norm",
    "quantize_group_norm_plain",
    "quantize_residual",
    "quantize_residual_plain",
    "dequantize",
    "qact_concat",
    "qact_avg_pool",
    "qact_upsample",
    "qact_group_norm",
    "qact_group_norm_plain",
    "conv1d_int8",
    "conv1d_int8_plain",
    "quantize_weight",
    "int8_weight",
]

# Symmetric int8 range; +-127 keeps the grid symmetric (no -128).
QMAX = 127.0
# Guards zero-range tensors (e.g. a zero-init conv_out).
EPS = 1e-12

_DTYPES = (torch.float32, torch.bfloat16)
_THREADS = 256
# The convolution's tiling (csrc/conv1d_int8.cu reports both; _conv_library
# checks them): output channels a block, and input channels padded to 32.
CONV_CO_TILE = 64
CONV_CIN_ALIGN = 32


class QAct(NamedTuple):
    """An int8-stored activation: value = q * scale (broadcast on C)."""

    q: torch.Tensor  # int8 [N, C, T]
    scale: torch.Tensor  # float32 () or (C,)
    dtype: torch.dtype = torch.float32  # the compute dtype it came from


# ------------------------------------------------------------ plain versions


def quantize_plain(x: torch.Tensor) -> QAct:
    """``quantize`` in plain PyTorch."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(), min=EPS) / QMAX
    q = torch.round(xf / scale).clamp_(-QMAX, QMAX).to(torch.int8)
    return QAct(q, scale, x.dtype)


def quantize_group_norm_plain(x: Union[torch.Tensor, QAct], mean: torch.Tensor,
                              a: torch.Tensor, b: torch.Tensor, use_gelu: bool) -> QAct:
    """``quantize_group_norm`` in plain PyTorch: the apply's plain version
    (on the dequantized codes of a ``QAct``, cast to its dtype), then
    ``quantize_plain``."""
    if isinstance(x, QAct):
        y = group_norm_apply_plain(dequantize_codes(x.q, x.scale), mean, a, b, use_gelu)
        return quantize_plain(y.to(x.dtype))
    return quantize_plain(group_norm_apply_plain(x, mean, a, b, use_gelu))


def quantize_residual_plain(skip: Union[torch.Tensor, QAct], h: torch.Tensor) -> QAct:
    """``quantize_residual`` in plain PyTorch: ``dequantize`` of a ``QAct``
    skip to its dtype, the eager add, then ``quantize_plain``."""
    if isinstance(skip, QAct):
        skip = dequantize(skip, skip.dtype)
    return quantize_plain(skip + h)


def conv1d_int8_plain(
    q: torch.Tensor,
    kq: torch.Tensor,
    w_scale: torch.Tensor,
    act_scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    stride: int,
    dilation: int,
    dtype: torch.dtype,
) -> torch.Tensor:
    """The int8 convolution in plain PyTorch: the int32 sums of codes q
    [N, Cin, T] and kq [Cout, Cin, K], as a float64 convolution (exact: every
    sum is an integer far below 2^53), then the float32 epilogue
    acc * w_scale, * act_scale, + bias, cast to ``dtype``."""
    pad = (kq.shape[-1] - 1) * dilation // 2
    acc = F.conv1d(q.double(), kq.double(), stride=stride, padding=pad, dilation=dilation)
    out = acc.float() * w_scale[:, None]
    if act_scale is not None:
        out = out * act_scale
    if bias is not None:
        out = out + bias.float()[:, None]
    return out.to(dtype)


def qact_group_norm_plain(qa: QAct, weight, bias, groups: int, eps: float,
                          use_gelu: bool) -> torch.Tensor:
    """``qact_group_norm`` in plain PyTorch: the int8 statistics' plain
    version on the codes, then the apply's on the dequantized values."""
    coeffs = group_norm_coeffs_int8_plain(qa.q, qa.scale, groups, weight, bias, eps)
    return group_norm_apply_plain(dequantize(qa), *coeffs, use_gelu).to(qa.dtype)


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _conv_library():
    lib = load_library("conv1d_int8")
    lib.conv1d_int8_co_tile.restype = ctypes.c_int
    if lib.conv1d_int8_co_tile() != CONV_CO_TILE:
        raise RuntimeError("csrc/conv1d_int8.cu: its channel tile differs from the wrapper's")
    lib.conv1d_int8_max_smem.restype = ctypes.c_int
    lib.conv1d_int8_smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.conv1d_int8_smem.restype = ctypes.c_longlong
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv1d_int8.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.conv1d_int8.restype = i
    return lib


# The quantize kernels' tiles: QUANT_BLOCK positions of one (n, c) row,
# QUANT_WARPS warps a program. The amax pass is a persistent grid of
# QUANT_PROGRAMS_PER_SM programs an SM (one partial each); the codes pass
# takes one tile a program, which is 4-7% faster at the byte-bound sites
# than a persistent loop (kernel_ab.py, PERF.md).
QUANT_BLOCK = 2048
QUANT_PROGRAMS_PER_SM = 16
QUANT_WARPS = 4
# Prologues: what the two passes recompute from the producer's inputs.
_PLAIN_INPUT, _NORM, _RESIDUAL = 0, 1, 2


@functools.lru_cache(maxsize=None)
def _quantize_kernels():
    """Define the Triton quantize kernels at first launch, on
    ``ops/group_norm.py``'s ``apply_helpers`` (the apply kernel's body)."""
    helpers = apply_helpers()
    triton, tl = helpers.triton, helpers.tl
    affine, gelu, values = helpers.affine, helpers.gelu, helpers.values
    from triton.language.extra import libdevice

    @triton.jit
    def site_values(tile, x_ptr, s_ptr, h_ptr, mean_ptr, a_ptr, b_ptr, T, C, S_STRIDE,
                    tiles_t, PRO: tl.constexpr, GELU: tl.constexpr, INT8: tl.constexpr,
                    OUT_BF16: tl.constexpr, BLOCK: tl.constexpr):
        """The float32 values of one tile as the producer would store them
        (rounded to bfloat16 where OUT_BF16), their offsets and mask."""
        row = tile // tiles_t
        idx = (tile % tiles_t) * BLOCK + tl.arange(0, BLOCK)
        mask = idx < T
        offs = row.to(tl.int64) * T + idx
        if PRO == 1:  # the GroupNorm apply
            v = values(x_ptr, offs, mask, row, mean_ptr, a_ptr, b_ptr, s_ptr, C, S_STRIDE,
                       GELU, INT8)
        elif PRO == 2:  # skip + h, in h's dtype as torch adds them
            if INT8:  # ``dequantize``: codes times their scale, cast to the dtype
                skip = tl.load(x_ptr + offs, mask=mask, other=0).to(tl.float32)
                # A rounded product, as torch writes it (an FMA with the add
                # would round once).
                skip = libdevice.mul_rn(skip, tl.load(s_ptr + (row % C) * S_STRIDE))
                skip = skip.to(h_ptr.dtype.element_ty)
            else:
                skip = tl.load(x_ptr + offs, mask=mask, other=0.0)
            h = tl.load(h_ptr + offs, mask=mask, other=0.0)
            v = skip.to(tl.float32) + h.to(tl.float32)
        else:
            v = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        if OUT_BF16:
            v = v.to(tl.bfloat16).to(tl.float32)
        return v, offs, mask

    @triton.jit
    def amax_kernel(x_ptr, s_ptr, h_ptr, mean_ptr, a_ptr, b_ptr, part_ptr, ticket_ptr,
                    scale_ptr, T, C, S_STRIDE, tiles_t, n_tiles, PRO: tl.constexpr,
                    GELU: tl.constexpr, INT8: tl.constexpr, OUT_BF16: tl.constexpr,
                    BLOCK: tl.constexpr, NPART: tl.constexpr):
        pid = tl.program_id(0)
        nprog = tl.num_programs(0)
        if PRO == 1 and GELU:
            # GELU's output is at most its input where that is >= 0, and
            # above -0.17 below it, so once the running max exceeds 0.25 a
            # tile whose largest pre-GELU value is under it (with a margin
            # for the rounding to the dtype) cannot raise it: only the
            # affine runs there, the GELU is skipped.
            m = tl.zeros([], dtype=tl.float32)
            for tile in range(pid, n_tiles, nprog):
                row = tile // tiles_t
                idx = (tile % tiles_t) * BLOCK + tl.arange(0, BLOCK)
                mask = idx < T
                offs = row.to(tl.int64) * T + idx
                y = affine(x_ptr, offs, mask, row, mean_ptr, a_ptr, b_ptr, s_ptr, C, S_STRIDE,
                           INT8)
                top = tl.max(tl.where(mask, y, 0.0), axis=0)
                if (top * 1.01 > m) | (m < 0.25):
                    v = gelu(y)
                    if OUT_BF16:
                        v = v.to(tl.bfloat16).to(tl.float32)
                    m = tl.maximum(m, tl.max(tl.where(mask, tl.abs(v), 0.0), axis=0))
        else:
            mv = tl.zeros([BLOCK], dtype=tl.float32)
            for tile in range(pid, n_tiles, nprog):
                v, offs, mask = site_values(tile, x_ptr, s_ptr, h_ptr, mean_ptr, a_ptr, b_ptr,
                                            T, C, S_STRIDE, tiles_t, PRO, GELU, INT8, OUT_BF16,
                                            BLOCK)
                mv = tl.maximum(mv, tl.where(mask, tl.abs(v), 0.0))
            m = tl.max(mv, axis=0)
        tl.store(part_ptr + pid, m)
        # The program that draws the last ticket reduces the partials to the
        # scale, JAX's max(amax, 1e-12) / 127 with IEEE division, and puts
        # the counter back to 0 (ops/tickets.py).
        tl.debug_barrier()
        if tl.atomic_add(ticket_ptr, 1) == nprog - 1:
            k = tl.arange(0, NPART)
            parts = tl.load(part_ptr + k, mask=k < nprog, other=0.0, cache_modifier=".cg")
            amax = tl.maximum(tl.max(parts, axis=0), 1e-12)
            tl.store(scale_ptr, libdevice.div_rn(amax, tl.full([], 127.0, tl.float32)))
            tl.store(ticket_ptr, 0)

    @triton.jit
    def codes_kernel(x_ptr, s_ptr, h_ptr, mean_ptr, a_ptr, b_ptr, scale_ptr, q_ptr, T, C,
                     S_STRIDE, tiles_t, PRO: tl.constexpr, GELU: tl.constexpr,
                     INT8: tl.constexpr, OUT_BF16: tl.constexpr, BLOCK: tl.constexpr):
        scale = tl.load(scale_ptr)
        v, offs, mask = site_values(tl.program_id(0), x_ptr, s_ptr, h_ptr, mean_ptr, a_ptr,
                                    b_ptr, T, C, S_STRIDE, tiles_t, PRO, GELU, INT8, OUT_BF16,
                                    BLOCK)
        # round_half_even(v / scale) with v / scale an IEEE division:
        # v * (1 / scale) is within |t| 2^-21 of it, so its rounding is the
        # division's unless t lies within |t| 2^-20 of a half-integer; those
        # rare lanes take the division itself.
        t = v * (1.0 / scale)
        c = libdevice.rint(t)
        near = tl.abs(tl.abs(t - c) - 0.5) < tl.abs(t) * 9.5367431640625e-07
        if tl.max(near.to(tl.int32), axis=0) > 0:
            c = tl.where(near, libdevice.rint(libdevice.div_rn(v, scale)), c)
        c = tl.minimum(tl.maximum(c, -127.0), 127.0)
        tl.store(q_ptr + offs, c.to(tl.int8), mask=mask)

    return triton, amax_kernel, codes_kernel


def _launch_quantize(pro: int, x: torch.Tensor, dtype: torch.dtype, rows: int, t: int,
                     codes_scale: Optional[torch.Tensor] = None,
                     h: Optional[torch.Tensor] = None, coeffs=(), use_gelu: bool = False
                     ) -> QAct:
    """The two launches of one quantize: the amax pass (one partial a
    program, the last program to finish writing the scale) and the codes
    pass (one tile a program), over ``rows`` rows of ``t`` values."""
    triton, amax_kernel, codes_kernel = _quantize_kernels()
    tiles_t = triton.cdiv(t, QUANT_BLOCK)
    n_tiles = rows * tiles_t
    programs = max(1, min(n_tiles, sm_count(x.device) * QUANT_PROGRAMS_PER_SM))
    shape = x.shape if h is None else h.shape
    q = torch.empty(shape, dtype=torch.int8, device=x.device)
    part = torch.empty(programs, dtype=torch.float32, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    s_in = part if codes_scale is None else codes_scale
    mean, a, b = coeffs or (part, part, part)
    c = shape[1] if len(shape) == 3 else 1
    stride = 0 if codes_scale is None or codes_scale.ndim == 0 else 1
    flags = dict(PRO=pro, GELU=use_gelu, INT8=codes_scale is not None,
                 OUT_BF16=pro != _PLAIN_INPUT and dtype == torch.bfloat16, BLOCK=QUANT_BLOCK)
    h_ptr = part if h is None else h
    with torch.cuda.device(x.device):
        counter = tickets(torch.cuda.current_stream(x.device), 1)
        amax_kernel[(programs,)](x, s_in, h_ptr, mean, a, b, part, counter, scale, t, c,
                                 stride, tiles_t, n_tiles, NPART=triton.next_power_of_2(programs),
                                 num_warps=QUANT_WARPS, **flags)
        codes_kernel[(n_tiles,)](x, s_in, h_ptr, mean, a, b, scale, q, t, c, stride, tiles_t,
                                 num_warps=QUANT_WARPS, **flags)
    return QAct(q, scale, dtype)


def _check_float(x: torch.Tensor, name: str) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA, not {x.device}")


def quantize(x: torch.Tensor) -> QAct:
    """Symmetric per-tensor dynamic quantization of x (float32 or bfloat16)
    to int8: scale = max(max |x|, 1e-12) / 127 over the whole tensor, the
    batch included; q = clip(round_half_even(x / scale), -127, 127). On the
    card the two launches of the Triton quantize kernels; the scale stays
    there."""
    _check_float(x, "quantize")
    if x.device.type == "cpu":
        return quantize_plain(x)
    x = x.contiguous()
    out = _launch_quantize(_PLAIN_INPUT, x, x.dtype, 1, x.numel())
    quantize.launches += 2
    return out


def quantize_group_norm(x: Union[torch.Tensor, QAct], mean: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, use_gelu: bool) -> QAct:
    """``quantize`` of the GroupNorm apply's output (``group_norm_apply``,
    or ``group_norm_apply_int8`` of a ``QAct``, in its dtype) from the
    statistics kernel's per-(n, c) (mean, a, b): on the card both quantize
    passes recompute the apply from x, so the float output is never
    written."""
    if isinstance(x, QAct):
        check_codes(x.q, x.scale)
        src = x.q
    else:
        _check_float(x, "quantize_group_norm")
        src = x
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize_group_norm writes float32 or bfloat16, not {x.dtype}")
    if src.ndim != 3 or not src.is_contiguous():
        raise ValueError(f"quantize_group_norm takes contiguous [N, C, T], got "
                         f"{tuple(src.shape)}")
    check_apply_coeffs(src, mean, a, b)
    if src.device.type == "cpu":
        return quantize_group_norm_plain(x, mean, a, b, use_gelu)
    n, c, t = src.shape
    out = _launch_quantize(_NORM, src, x.dtype, n * c, t,
                           x.scale if isinstance(x, QAct) else None,
                           coeffs=(mean, a, b), use_gelu=use_gelu)
    quantize_group_norm.launches += 2
    return out


def quantize_residual(skip: Union[torch.Tensor, QAct], h: torch.Tensor) -> QAct:
    """``quantize`` of the residual sum skip + h in h's dtype, a ``QAct``
    skip dequantized to that dtype first (``dequantize``): on the card both
    quantize passes recompute the sum, so it is never written."""
    _check_float(h, "quantize_residual")
    src = skip.q if isinstance(skip, QAct) else skip
    if isinstance(skip, QAct):
        check_codes(skip.q, skip.scale)
    if (skip.dtype != h.dtype or src.shape != h.shape or h.ndim != 3 or src.device != h.device
            or not h.is_contiguous() or not src.is_contiguous()):
        raise ValueError(f"quantize_residual takes contiguous [N, C, T] skip and h of one "
                         f"dtype and shape on one device, got {skip.dtype} "
                         f"{tuple(src.shape)} and {h.dtype} {tuple(h.shape)}")
    if h.device.type == "cpu":
        return quantize_residual_plain(skip, h)
    n, c, t = h.shape
    out = _launch_quantize(_RESIDUAL, src, h.dtype, n * c, t,
                           skip.scale if isinstance(skip, QAct) else None, h=h)
    quantize_residual.launches += 2
    return out


def dequantize(qa: QAct, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Back to real values: float32 by default."""
    out = dequantize_codes(qa.q, qa.scale)
    return out.to(dtype) if dtype is not None else out


def qact_concat(a: QAct, b: QAct) -> QAct:
    """Channel concat; the scales widen to one a channel, so each half keeps
    its own grid."""
    if a.dtype != b.dtype:
        raise ValueError(f"concat of activations quantized from {a.dtype} and {b.dtype}")
    ca, cb = a.q.shape[1], b.q.shape[1]
    sa = a.scale.expand(ca) if a.scale.ndim == 0 else a.scale
    sb = b.scale.expand(cb) if b.scale.ndim == 0 else b.scale
    return QAct(torch.cat([a.q, b.q], dim=1), torch.cat([sa, sb]), a.dtype)


def qact_avg_pool(qa: QAct, factor: int) -> QAct:
    """Non-overlapping average pool over T, staying int8: the mean in
    float32 rounded half to even (at most half an LSB); the scale is kept."""
    n, c, t = qa.q.shape
    if t % factor:
        raise ValueError(f"length {t} not divisible by pool factor {factor}")
    pooled = qa.q.float().reshape(n, c, t // factor, factor).mean(dim=-1)
    return QAct(torch.round(pooled).to(torch.int8), qa.scale, qa.dtype)


def qact_upsample(qa: QAct, factor: int) -> QAct:
    """Nearest-neighbour upsample over T: a gather, exact in int8."""
    return QAct(torch.repeat_interleave(qa.q, factor, dim=-1), qa.scale, qa.dtype)


def qact_group_norm(qa: QAct, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                    eps: float, use_gelu: bool) -> torch.Tensor:
    """GroupNorm over the channels of [N, C, T] reading the int8 codes, with
    the affine and optional exact GELU (no FiLM), in ``qa.dtype``. The card
    runs the statistics and apply kernels' int8 modes."""
    mean, a, b = group_norm_coeffs_int8(qa.q, qa.scale, groups, weight, bias, eps)
    return group_norm_apply_int8(qa.q, qa.scale, mean, a, b, use_gelu, qa.dtype)


def quantize_weight(weight: torch.Tensor, act_scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 codes kq [Cout, Cin, K] and float32 scales
    [Cout] of a float32 weight [Cout, Cin, K], as JAX quantizes its
    (K, Cin, Cout) kernel: w_scale = max(max |w|, 1e-12) / 127 over (Cin,
    K), kq = clip(round(w / w_scale)). A per-channel activation scale (Cin,)
    is folded into the weight first."""
    kf = weight.float()
    if act_scale is not None:
        kf = kf * act_scale[None, :, None]
    w_scale = torch.clamp(kf.abs().amax(dim=(1, 2)), min=EPS) / QMAX
    kq = torch.round(kf / w_scale[:, None, None]).clamp_(-QMAX, QMAX).to(torch.int8)
    return kq, w_scale


def _kernel_layout(kq: torch.Tensor) -> torch.Tensor:
    """kq [Cout, Cin, K] as the kernel takes it: [K, Cout padded to 64, Cin
    padded to 32], zero-filled."""
    cout, cin, k = kq.shape
    cout_p = -(-cout // CONV_CO_TILE) * CONV_CO_TILE
    cin_p = -(-cin // CONV_CIN_ALIGN) * CONV_CIN_ALIGN
    out = torch.zeros((k, cout_p, cin_p), dtype=torch.int8, device=kq.device)
    out[:, :cout, :cin] = kq.permute(2, 0, 1)
    return out


def int8_weight(conv: torch.nn.Conv1d, weight: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(kq, w_scale, the kernel's layout of kq on CUDA, else None) of
    ``weight`` (``conv``'s, or this rank's shard of it), quantized once and
    kept on ``conv`` until the weight is replaced, moved or written to (its
    ``_version``): the counterpart of XLA hoisting the weight quantization
    out of the sampling loop."""
    key = (weight._version, weight.data_ptr(), weight.device)
    cached = getattr(conv, "_int8_weight", None)
    if cached is not None and cached[0] is weight and cached[1] == key:
        return cached[2]
    with torch.no_grad():
        kq, w_scale = quantize_weight(weight)
        layout = _kernel_layout(kq) if kq.is_cuda else None
    value = (kq, w_scale, layout)
    conv._int8_weight = (weight, key, value)
    return value


def conv1d_int8(
    qa: QAct,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    stride: int = 1,
    dilation: int = 1,
    dtype: Optional[torch.dtype] = None,
    conv: Optional[torch.nn.Conv1d] = None,
) -> torch.Tensor:
    """1-D convolution of an int8 activation with a float32 weight [Cout,
    Cin, K] quantized per output channel (``quantize_weight``), SAME
    padding, output in ``dtype`` (default ``qa.dtype``). The epilogue runs
    in float32 in JAX's order: acc * w_scale, then * the activation scale
    where it is one for the tensor, then + bias. A per-channel scale is
    folded into the weight per call; otherwise the quantized weight is kept
    on ``conv`` (``int8_weight``). On the card one launch of
    ``csrc/conv1d_int8.cu`` (stride 1, 1 or 3 taps)."""
    q = qa.q
    dtype = dtype or qa.dtype
    per_channel = qa.scale.ndim == 1
    if per_channel or conv is None:
        kq, w_scale = quantize_weight(weight, qa.scale if per_channel else None)
        layout = _kernel_layout(kq) if q.is_cuda else None
    else:
        kq, w_scale, layout = int8_weight(conv, weight)
    act_scale = None if per_channel else qa.scale
    if q.device.type == "cpu":
        return conv1d_int8_plain(q, kq, w_scale, act_scale, bias, stride, dilation, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"conv1d_int8 runs on CPU or CUDA, not {q.device}")
    if stride != 1:
        raise ValueError(f"the int8 convolution kernel takes stride 1, not {stride}")
    n, cin, t = q.shape
    cout, wcin, taps = kq.shape
    if wcin != cin or taps not in (1, 3) or not q.is_contiguous():
        raise ValueError(f"conv1d_int8 takes contiguous codes [N, {wcin}, T] and 1 or 3 "
                         f"taps, got {tuple(q.shape)} and {taps} taps")
    if dtype not in _DTYPES:
        raise ValueError(f"conv1d_int8 writes float32 or bfloat16, not {dtype}")
    lib = _conv_library()
    if lib.conv1d_int8_smem(layout.shape[2], taps, dilation) > lib.conv1d_int8_max_smem():
        raise ValueError(f"dilation {dilation} needs more shared memory than a block has")
    out = torch.empty((n, cout, t), dtype=dtype, device=q.device)
    b32 = None if bias is None else bias.float().contiguous()
    stream = torch.cuda.current_stream(q.device)
    with torch.cuda.device(q.device):
        err = lib.conv1d_int8(
            q.data_ptr(), layout.data_ptr(), w_scale.data_ptr(),
            None if act_scale is None else act_scale.data_ptr(),
            None if b32 is None else b32.data_ptr(), out.data_ptr(),
            0 if dtype == torch.float32 else 1, n, cin, cout, t, layout.shape[2],
            layout.shape[1], taps, dilation, sm_count(q.device), stream.cuda_stream)
    if err:
        raise RuntimeError(f"conv1d_int8 kernel launch failed: CUDA error {err}")
    conv1d_int8.launches += 1
    return out


quantize.launches = 0
quantize_group_norm.launches = 0
quantize_residual.launches = 0
conv1d_int8.launches = 0
