"""The serving forward's bf16 1-D convolution on [N, C, T]: a hand-written
CUDA kernel (``csrc/conv1d_bf16.cu``, see its header for the design and the
bound) with the bias in its epilogue, and its plain PyTorch version.

No TPU kernel is behind it: the JAX package leaves the convolution to XLA
(``vq_voice_swap_tpu/models/layers.py``, flax's ``nn.Conv``). On the card
PyTorch's ``F.conv1d`` runs cuDNN on [N, C, T] as a transpose to
channels-last, the implicit GEMM and a transpose back, and then adds the
bias in a broadcast pass of its own; the kernel reads and writes [N, C, T]
and adds the bias to its float32 sums before the one rounding to bf16.

``models/layers.py``'s ``conv1d`` takes this route where ``routes`` says
so: a CUDA bf16 input that autograd is not recording, no sequence-parallel
mesh, and a shape the kernel takes and where it beats cuDNN (``fits``).
Every other call runs ``F.conv1d`` as before: training and its graphs, the
guided backward, float32, sequence parallelism, the int8 ``QAct`` route.

The kernel takes the weight as [taps, Cout padded to 64, Cin padded to 16]
in bf16, made once and kept on the module (``kernel_weight``) until the
weight or the bias is replaced, moved or written to. ``conv1d_bf16`` takes
the plain version for CPU tensors and launches the kernel for CUDA
tensors, with no fallback, and counts its launches.
"""

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .cuda_build import load_library
from .group_norm import sm_count

__all__ = ["conv1d_bf16", "conv1d_bf16_plain", "fits", "routes", "kernel_weight"]

# The weight's layout (csrc/conv1d_bf16.cu checks it at each launch): Cout
# padded to the block's 64 output channels, Cin to the MMA's depth of 16.
CO_TILE = 64
CIN_ALIGN = 16
# T's alignment: the kernel stages its windows in blocks of 8 positions.
T_ALIGN = 8
# The widest window, (taps - 1) * dilation positions beyond a 128-position
# tile, that the kernel's smallest shared-memory layout (two stages of the
# window and a weight slice each, beside the transposed window; the .cu's
# ``geometry``) holds in an H100 block's 227 KB.
MAX_REACH = 320
# The route's shapes, from kernel_ab.py's timings on the H100 at the swap
# predictor's shapes (batch 64; PERF.md): every shape up to 192 input
# channels (the kernel beats cuDNN with its transposes and bias pass by
# 1.1-4.6x), and at 256 the 3-tap convolutions to at most 128 channels
# (1.10-1.13x); not 256 -> 256 (0.88-0.97x), 256 -> 128 with 1 tap (at
# par) or wider inputs (0.4-0.9x).
MAX_CIN = 192
WIDE_CIN, WIDE_COUT = 256, 128


def _cin_p(cin: int) -> int:
    return -(-cin // CIN_ALIGN) * CIN_ALIGN


@functools.lru_cache(maxsize=None)
def fits(cin: int, cout: int, taps: int, stride: int, padding: int, dilation: int,
         groups: int, t: int) -> bool:
    """Whether the kernel takes a convolution of these shapes and the route
    takes it: stride 1, one group, 1 or 3 taps with SAME padding, T a
    multiple of 8, a window of at most MAX_REACH positions beyond the tile,
    and the widths where the kernel is the faster: Cin at most MAX_CIN, or
    at most WIDE_CIN with 3 taps and at most WIDE_COUT output channels."""
    return (stride == 1 and groups == 1 and taps in (1, 3) and dilation >= 1
            and padding == (taps - 1) * dilation // 2 and t > 0 and t % T_ALIGN == 0
            and 0 < cout and 0 < cin and (taps - 1) * dilation <= MAX_REACH
            and (cin <= MAX_CIN or (cin <= WIDE_CIN and cout <= WIDE_COUT and taps == 3)))


def routes(device: str, dtype: torch.dtype, recording: bool, shape: Sequence[int],
           dense: bool, conv: nn.Conv1d) -> bool:
    """The route of ``conv`` on an input of ``shape`` [N, Cin, T]: True for
    the kernel, False for ``F.conv1d``. A pure function of what the call
    can observe: the input's device type and dtype, whether autograd
    records the call, the shapes, and whether the input is contiguous and
    16-byte aligned (``dense``). (Under sequence parallelism ``conv1d``
    takes its sharded route before it asks.)"""
    if device != "cuda" or dtype != torch.bfloat16 or recording or not dense:
        return False
    cout, cin, taps = conv.weight.shape
    return (len(shape) == 3 and shape[1] == cin and conv.padding_mode == "zeros"
            and fits(cin, cout, taps, conv.stride[0], conv.padding[0], conv.dilation[0],
                     conv.groups, shape[2]))


def conv1d_bf16_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                      dilation: int = 1) -> torch.Tensor:
    """``conv1d_bf16`` in plain PyTorch: ``F.conv1d`` in x's dtype with the
    weight and the bias cast to it, SAME padding, stride 1."""
    pad = (weight.shape[-1] - 1) * dilation // 2
    return F.conv1d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                    padding=pad, dilation=dilation)


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("conv1d_bf16")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv1d_bf16.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.conv1d_bf16.restype = i
    return lib


def _kernel_layout(weight: torch.Tensor) -> torch.Tensor:
    """weight [Cout, Cin, K] as the kernel takes it: [K, Cout padded to 64,
    Cin padded to 16] in bf16, zero-filled."""
    cout, cin, k = weight.shape
    cout_p = -(-cout // CO_TILE) * CO_TILE
    out = torch.zeros((k, cout_p, _cin_p(cin)), dtype=torch.bfloat16, device=weight.device)
    out[:, :cout, :cin] = weight.permute(2, 0, 1)
    return out


def _prepare(weight: torch.Tensor, bias: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    with torch.no_grad():
        b32 = None if bias is None else bias.to(torch.bfloat16).float()
        return _kernel_layout(weight), b32


def kernel_weight(conv: nn.Module, weight: torch.Tensor, bias: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the kernel's layout of ``weight``, the float32 value of the bf16
    ``bias`` or None) of ``conv``'s parameters (or this rank's shards of
    them), made once and kept on ``conv`` until either is replaced, moved
    or written to (its ``data_ptr`` and ``_version``): a ``load_state_dict``,
    an optimizer step or an EMA swap makes them anew. Parameters made under
    ``torch.inference_mode`` keep no version counter, so nothing would show
    a write to them: theirs are made every call."""
    if weight.is_inference() or (bias is not None and bias.is_inference()):
        return _prepare(weight, bias)
    key = (weight.data_ptr(), weight._version,
           None if bias is None else (bias.data_ptr(), bias._version))
    cached = conv.__dict__.get("_bf16_weight")
    if cached is not None and cached[0] is weight and cached[1] is bias and cached[2] == key:
        return cached[3]
    value = _prepare(weight, bias)
    conv.__dict__["_bf16_weight"] = (weight, bias, key, value)
    return value


def conv1d_bf16(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                dilation: int = 1, conv: Optional[nn.Module] = None) -> torch.Tensor:
    """1-D convolution of a bf16 x [N, Cin, T] with weight [Cout, Cin, K]
    (K 1 or 3) and bias [Cout] or None, SAME padding, stride 1, in bf16:
    the float32 sums plus the bf16 bias, rounded once. The kernel's weight
    is kept on ``conv`` where one is given (``kernel_weight``). On the card
    one launch of ``csrc/conv1d_bf16.cu``; no autograd."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"conv1d_bf16 runs on CPU or CUDA, not {x.device}")
        return conv1d_bf16_plain(x, weight, bias, dilation)
    n, cin, t = x.shape
    cout, wcin, taps = weight.shape
    if (x.dtype != torch.bfloat16 or wcin != cin or not x.is_contiguous()
            or x.data_ptr() % 16
            or not fits(cin, cout, taps, 1, (taps - 1) * dilation // 2, dilation, 1, t)):
        raise ValueError(f"conv1d_bf16 takes a contiguous, 16-byte aligned bf16 x [N, {wcin}, "
                         f"T] with T a multiple of {T_ALIGN}, 1 or 3 taps and widths the "
                         f"route takes (``fits``); got {x.dtype} "
                         f"{tuple(x.shape)}, {taps} taps, dilation {dilation}")
    layout, b32 = _prepare(weight, bias) if conv is None else kernel_weight(conv, weight, bias)
    out = x.new_empty((n, cout, t))
    index = x.get_device()
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            err = _launch(x, layout, b32, out, dilation, index)
    else:
        err = _launch(x, layout, b32, out, dilation, index)
    if err:
        raise RuntimeError(f"conv1d_bf16 kernel launch failed: CUDA error {err}")
    conv1d_bf16.launches += 1
    return out


def _launch(x, layout, b32, out, dilation: int, index: int) -> int:
    """One launch on the current stream of device ``index`` (the current
    device); the CUDA error code."""
    n, cin, t = x.shape
    taps, cout_p, cin_p = layout.shape
    return _library().conv1d_bf16(
        x.data_ptr(), layout.data_ptr(), None if b32 is None else b32.data_ptr(),
        out.data_ptr(), n, cin, out.shape[1], t, cin_p, cout_p, taps, dilation,
        sm_count(index), torch._C._cuda_getCurrentRawStream(index))


conv1d_bf16.launches = 0
