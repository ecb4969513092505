"""Nearest-code VQ assignment: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``vq_voice_swap_tpu/ops/vq_pallas.py``. ``vq_assign`` takes
the plain version for CPU tensors and launches the kernel
(``csrc/vq_assign.cu``, see its header for the design and the bound) for
CUDA tensors; there is no fallback between the two. Unlike the TPU path,
which gates the kernel on codebook and batch size, every CUDA call launches
the kernel: one launch, with the codebook norms, the argmin and the used
mask inside it. The kernel's block is 64 rows by 64 codes, or 32 codes
where 64 would give the card fewer blocks than it has SMs (the CLI's batch
of 200 rows against 512 codes).
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .cuda_build import load_library
from .tickets import tickets

__all__ = ["vq_assign", "vq_assign_plain"]

# The kernel's rows per block (csrc/vq_assign.cu reports the same; _kernel()
# checks that they agree) and the codes per block it can take.
BLOCK_ROWS = 64
BLOCK_CODES = (32, 64)


def vq_assign_plain(
    dictionary: torch.Tensor, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, C] against dictionary [D, C] -> (idx [B] int32, used [D] int32):
    argmin of |d|^2 - 2 x.d in float32, ties to the lowest index."""
    dict_norms = torch.sum(torch.square(dictionary), dim=-1)
    dots = torch.matmul(x, dictionary.t())
    idx = torch.argmin(dict_norms[None, :] - 2.0 * dots, dim=-1)
    used = torch.zeros(dictionary.shape[0], dtype=torch.int32, device=x.device)
    used.index_fill_(0, idx, 1)
    return idx.to(torch.int32), used


def _check(dictionary: torch.Tensor, x: torch.Tensor, block_codes) -> None:
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
    if block_codes is not None and block_codes not in BLOCK_CODES:
        raise ValueError(f"block_codes must be one of {BLOCK_CODES}, got {block_codes}")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = load_library("vq_assign")
    lib.vq_assign_block_rows.restype = ctypes.c_int
    if lib.vq_assign_block_rows() != BLOCK_ROWS:
        raise RuntimeError(f"csrc/vq_assign.cu: vq_assign_block_rows is "
                           f"{lib.vq_assign_block_rows()}, the wrapper expects {BLOCK_ROWS}")
    fn = lib.vq_assign_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 5 + [p]
    fn.restype = i
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def vq_assign(
    dictionary: torch.Tensor, x: torch.Tensor, block_codes: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest code per row of x [B, C] and the [D] used mask (int32).
    ``block_codes`` sets the kernel's codes per block (32 or 64; default:
    chosen from the grid); it does not change the result."""
    _check(dictionary, x, block_codes)
    if x.device.type == "cpu":
        return vq_assign_plain(dictionary, x)
    if x.device.type != "cuda":
        raise ValueError(f"vq_assign runs on CPU or CUDA, not {x.device}")
    b, c = x.shape
    d = dictionary.shape[0]
    row_tiles = -(-b // BLOCK_ROWS)
    if row_tiles > 65535:
        raise ValueError(f"vq_assign takes at most {65535 * BLOCK_ROWS} rows, got {b}")
    if block_codes is None:
        block_codes = 64 if row_tiles * -(-d // 64) >= _sm_count(x.device) else 32
    vec = c % 4 == 0 and x.data_ptr() % 16 == 0 and dictionary.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(x.device)
    with torch.cuda.device(x.device):
        idx = torch.empty(b, dtype=torch.int32, device=x.device)
        used = torch.empty(d, dtype=torch.int32, device=x.device)
        if b == 0:
            return idx, used.zero_()
        cand = torch.empty((b, -(-d // block_codes), 2), dtype=torch.float32,
                           device=x.device)
        err = _kernel()(
            x.data_ptr(), dictionary.data_ptr(), cand.data_ptr(),
            tickets(stream, 1 + row_tiles).data_ptr(), idx.data_ptr(),
            used.data_ptr(), b, c, d, block_codes, int(vec), stream.cuda_stream,
        )
    if err:
        raise RuntimeError(f"vq_assign kernel launch failed: CUDA error {err}")
    vq_assign.launches += 1
    return idx, used


vq_assign.launches = 0
