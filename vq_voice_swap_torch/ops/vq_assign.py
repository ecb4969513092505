"""Nearest-code VQ assignment: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``vq_voice_swap_tpu/ops/vq_pallas.py``. ``vq_assign`` takes
the plain version for CPU tensors and launches the kernel
(``csrc/vq_assign.cu``, see its header for the design and the bound) for
CUDA tensors; there is no fallback between the two. Unlike the TPU path,
which gates the kernel on codebook and batch size, every CUDA call launches
the kernel.
"""

import ctypes
from typing import Tuple

import torch

from .cuda_build import load_library

__all__ = ["vq_assign", "vq_assign_plain"]


def vq_assign_plain(
    dictionary: torch.Tensor, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, C] against dictionary [D, C] -> (idx [B] int32, used [D] int32):
    argmin of |d|^2 - 2 x.d in float32, ties to the lowest index."""
    dict_norms = torch.sum(torch.square(dictionary), dim=-1)
    dots = torch.matmul(x, dictionary.t())
    idx = torch.argmin(dict_norms[None, :] - 2.0 * dots, dim=-1)
    used = torch.zeros(dictionary.shape[0], dtype=torch.int32, device=x.device)
    used[idx] = 1
    return idx.to(torch.int32), used


def _check(dictionary: torch.Tensor, x: torch.Tensor) -> None:
    if x.ndim != 2 or dictionary.ndim != 2 or x.shape[1] != dictionary.shape[1]:
        raise ValueError(
            f"expected x [B, C] and dictionary [D, C], got "
            f"{tuple(x.shape)} and {tuple(dictionary.shape)}"
        )
    if x.dtype != torch.float32 or dictionary.dtype != torch.float32:
        raise ValueError(
            f"vq_assign takes float32, got {x.dtype} and {dictionary.dtype}"
        )
    if x.device != dictionary.device:
        raise ValueError(f"x on {x.device} but dictionary on {dictionary.device}")
    if not (x.is_contiguous() and dictionary.is_contiguous()):
        raise ValueError("vq_assign takes contiguous tensors")


def _kernel():
    lib = load_library("vq_assign")
    fn = lib.vq_assign_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def vq_assign(
    dictionary: torch.Tensor, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest code per row of x [B, C] and the [D] used mask (int32)."""
    _check(dictionary, x)
    if x.device.type == "cpu":
        return vq_assign_plain(dictionary, x)
    if x.device.type != "cuda":
        raise ValueError(f"vq_assign runs on CPU or CUDA, not {x.device}")
    b, c = x.shape
    d = dictionary.shape[0]
    with torch.cuda.device(x.device):
        dict_norms = torch.sum(torch.square(dictionary), dim=-1)
        idx = torch.empty(b, dtype=torch.int32, device=x.device)
        used = torch.zeros(d, dtype=torch.int32, device=x.device)
        err = _kernel()(
            x.data_ptr(), dictionary.data_ptr(), dict_norms.data_ptr(),
            idx.data_ptr(), used.data_ptr(), b, c, d,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"vq_assign kernel launch failed: CUDA error {err}")
    vq_assign.launches += 1
    return idx, used


vq_assign.launches = 0
