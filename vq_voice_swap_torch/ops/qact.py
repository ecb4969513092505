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

- ``quantize``: ``csrc/qact.cu``, an amax launch that writes the scale on
  the card (no host sync) and a launch that writes the codes, with JAX's
  IEEE division and round-half-even, so the codes have JAX's bits.
- ``conv1d_int8``: ``csrc/conv1d_int8.cu``, an implicit GEMM on the int8
  tensor cores (mma.sync m16n8k32) with the float32 epilogue fused.
- ``qact_group_norm``: the GroupNorm statistics and apply kernels' int8
  modes (``ops/group_norm.py``), two launches.

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
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .cuda_build import load_library
from .group_norm import (_sm_count, dequantize_codes, group_norm_apply_int8,
                         group_norm_apply_plain, group_norm_coeffs_int8,
                         group_norm_coeffs_plain)
from .tickets import tickets

__all__ = [
    "QAct",
    "quantize",
    "quantize_plain",
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
CONV_POS = 128  # positions a block


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
    """``qact_group_norm`` in plain PyTorch: the float GroupNorm's plain
    versions on the dequantized values."""
    xf = dequantize(qa)
    coeffs = group_norm_coeffs_plain(xf, groups, weight, bias, eps)
    return group_norm_apply_plain(xf, *coeffs, use_gelu).to(qa.dtype)


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _quantize_library():
    lib = load_library("qact")
    lib.qact_max_blocks.restype = ctypes.c_int
    if lib.qact_max_blocks() != _AMAX_MAX_BLOCKS:
        raise RuntimeError(f"csrc/qact.cu: qact_max_blocks is {lib.qact_max_blocks()}, "
                           f"the wrapper expects {_AMAX_MAX_BLOCKS}")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.qact_quantize.argtypes = [i, p, ll, i, i, i, p, p, p, p, p]
    lib.qact_quantize.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _conv_library():
    lib = load_library("conv1d_int8")
    lib.conv1d_int8_co_tile.restype = ctypes.c_int
    if lib.conv1d_int8_co_tile() != CONV_CO_TILE:
        raise RuntimeError("csrc/conv1d_int8.cu: its channel tile differs from the wrapper's")
    lib.conv1d_int8_max_smem.restype = ctypes.c_int
    lib.conv1d_int8_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.conv1d_int8_smem.restype = ctypes.c_longlong
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv1d_int8.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.conv1d_int8.restype = i
    return lib


_AMAX_MAX_BLOCKS = 1024


def quantize(x: torch.Tensor) -> QAct:
    """Symmetric per-tensor dynamic quantization of x (float32 or bfloat16)
    to int8: scale = max(max |x|, 1e-12) / 127 over the whole tensor, the
    batch included; q = clip(round_half_even(x / scale), -127, 127). On the
    card two launches of ``csrc/qact.cu``; the scale stays there."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize takes float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return quantize_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize runs on CPU or CUDA, not {x.device}")
    x = x.contiguous()
    n = x.numel()
    v = 16 // x.element_size()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    vec = n % v == 0 and x.data_ptr() % 16 == 0 and q.data_ptr() % 8 == 0
    nvec = n // v if vec else n
    sms = _sm_count(x.device)
    amax_blocks = max(1, min(_AMAX_MAX_BLOCKS, sms * 4, -(-nvec // (_THREADS * 4))))
    code_blocks = max(1, min(sms * 16, -(-nvec // _THREADS)))
    part = torch.empty(amax_blocks, dtype=torch.float32, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    with torch.cuda.device(x.device):
        err = _quantize_library().qact_quantize(
            0 if x.dtype == torch.float32 else 1, x.data_ptr(), n, int(vec), amax_blocks,
            code_blocks, part.data_ptr(), tickets(stream, 1).data_ptr(), scale.data_ptr(),
            q.data_ptr(), stream.cuda_stream)
    if err:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err}")
    quantize.launches += 2
    return QAct(q, scale, x.dtype)


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
    rows = CONV_POS + (taps - 1) * dilation
    if lib.conv1d_int8_smem(rows, taps) > lib.conv1d_int8_max_smem():
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
            layout.shape[1], taps, dilation, stream.cuda_stream)
    if err:
        raise RuntimeError(f"conv1d_int8 kernel launch failed: CUDA error {err}")
    conv1d_int8.launches += 1
    return out


quantize.launches = 0
conv1d_int8.launches = 0
