"""Fused same-resolution ResBlock: a hand-written CUDA kernel pair and its
plain PyTorch version.

Counterpart of ``attic/fused_resblock.py``, the TPU pair behind
``packed_unet_predict(fuse_levels=K)``:

- ``fused_resblock_stats`` replaces ``_stats_kernel`` (fused_resblock.py:151):
  per tile of 128 positions, g = gelu(GroupNorm-1(x)) zeroed outside
  [0, T), h1 = conv_in(g) rounded to the compute dtype, and float32
  (count, mean, M2) partials of h1 per (n, channel, tile).
- ``fused_resblock_apply`` replaces ``_apply_kernel`` (fused_resblock.py:175):
  recompute h1 over the tile and its halo, z = gelu(GroupNorm-2 + FiLM),
  zeroed outside [0, T), out = dilated conv_out(z) + skip, stored once.

conv_in runs in both kernels and conv_out in the second, 3 x 3 x Cin x
Cout x 2 flops per position, against x read twice and the output written
once. The design keeps every intermediate (g, h1, z) on chip and runs each
convolution as an implicit GEMM per tap on the tensor cores: bf16
``mma.sync`` for bf16, 3xTF32 (three TF32 products of split operands) for
float32 (``csrc/fused_resblock.cu``, whose header has the details). The
wrapper hands the kernels each convolution's weights as [tap, Cout, Cin]
in the compute dtype (``_conv_weight``).

Outside the kernels, as in the TPU wrapper: GroupNorm-1's per-channel
affine (the port's ``group_norm_coeffs`` kernel, one launch per input, each
writing its column slice of one [3, N, Cin] buffer), the FiLM
``gelu(emb) @ cond_proj`` exactly as the unfused block computes it, and the
merge and fold of the GroupNorm-2 partials.
Two inputs run the block on their channel concat without materialising
it, when the concat boundary falls on a GroupNorm-1 group edge.

``fused_resblock`` takes the plain version for CPU tensors and launches
both kernels for CUDA tensors, with no fallback between them; each kernel
counts its launches. The pair takes whole weights: under tensor
parallelism (``parallel/tensor.py``) a block's leaves that were cut over
the model group are gathered whole for the call, and the pair runs the
whole block on every rank of the group (storage sharding for these
blocks, not split work). Unlike the TPU path there is no gate on T, on the
channel count or on a tile that divides T: the kernels mask the ragged
last tile.
"""

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel.tensor import TP_AXES, gathered
from .cuda_build import load_library
from .group_norm import (
    fold_affine,
    group_norm_apply_plain,
    group_norm_coeffs,
    group_norm_coeffs_plain,
    group_stats_plain,
    merge_partials,
)

__all__ = [
    "fused_resblock",
    "fused_resblock_plain",
    "fused_resblock_stats",
    "fused_resblock_apply",
    "fusable",
    "MAX_DILATION",
    "MAX_COUT",
    "STATS_TILE",
]

# The kernels' limits and the stats kernel's tile (csrc/fused_resblock.cu
# reports the same numbers; _library() checks that they agree).
MAX_DILATION = 7
MAX_COUT = 256
STATS_TILE = 128
WEIGHT_ALIGN = 8  # weight rows are padded to a multiple of 8 input channels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fusable(block) -> bool:
    """Whether the kernel pair computes ``block`` (a ``models.layers.ResBlock``):
    same resolution, conv_out dilation within the halo, and at most
    ``MAX_COUT`` output channels."""
    return (
        block.scale_factor == 1.0
        and block.conv_out.conv.dilation[0] <= MAX_DILATION
        and block.conv_out.conv.out_channels <= MAX_COUT
    )


def _inputs(block, x: torch.Tensor, emb, x2) -> Tuple[torch.Tensor, ...]:
    """Validate the call; returns the inputs as a tuple."""
    xs = (x,) if x2 is None else (x, x2)
    if not fusable(block):
        raise ValueError("the fused ResBlock takes same-resolution blocks with "
                         f"dilation <= {MAX_DILATION} and <= {MAX_COUT} outputs")
    for xi in xs:
        if xi.ndim != 3 or xi.dtype not in _DTYPE_CODE:
            raise ValueError(f"expected float32 or bfloat16 [N, C, T], got "
                             f"{xi.dtype} {tuple(xi.shape)}")
        if not xi.is_contiguous():
            raise ValueError("the fused ResBlock takes contiguous [N, C, T] inputs")
        if (xi.shape[0], xi.shape[2], xi.dtype, xi.device) != (
                x.shape[0], x.shape[2], x.dtype, x.device):
            raise ValueError("both inputs need the same N, T, dtype and device")
    cin = sum(xi.shape[1] for xi in xs)
    if cin != block.conv_in.conv.in_channels:
        raise ValueError(f"block takes {block.conv_in.conv.in_channels} channels, "
                         f"got {cin}")
    if x2 is not None and x.shape[1] % (cin // block.norm_in.norm.num_groups):
        raise ValueError(f"concat boundary {x.shape[1]} straddles a GroupNorm group")
    if (emb is not None) != (block.cond_proj is not None):
        raise ValueError("pass an embedding iff the block was built with one")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the fused ResBlock runs on CPU or CUDA, not {x.device}")
    for t in (block.conv_in.conv.weight, emb):
        if t is not None and t.device != x.device:
            raise ValueError(f"the block's weights and the embedding must be on "
                             f"{x.device}, found {t.device}")
    return xs


def _norm_in_affine(block, xs: Sequence[torch.Tensor], coeffs) -> Tuple[torch.Tensor, ...]:
    """GroupNorm-1 folded to float32 (mean, a, b) [N, Cin] by ``coeffs``
    (``group_norm_coeffs`` or its plain version); with two inputs, each
    writes its column slice from its share of the groups and of the affine."""
    norm = block.norm_in.norm
    cin = sum(xi.shape[1] for xi in xs)
    out = torch.empty((3, xs[0].shape[0], cin), dtype=torch.float32, device=xs[0].device)
    c0 = 0
    for xi in xs:
        c1 = c0 + xi.shape[1]
        coeffs(xi, norm.num_groups * xi.shape[1] // cin, norm.weight[c0:c1],
               norm.bias[c0:c1], norm.eps, out=out[:, :, c0:c1])
        c0 = c1
    return tuple(out)


def _norm_mid_affine(block, part: torch.Tensor, emb) -> Tuple[torch.Tensor, ...]:
    """GroupNorm-2 and the FiLM folded to float32 (mean, a, b) [N, Cout]
    from the stats kernel's partials [3, N, Cout, tiles]: a group's
    channels are adjacent, so [N * G, Cout / G * tiles] rows merge."""
    norm = block.norm_mid.norm
    n = part.shape[1]
    mean2, var2 = merge_partials(*part.view(3, n * norm.num_groups, -1))
    return fold_affine(mean2.view(n, -1), var2.view(n, -1), norm.weight, norm.bias,
                       norm.eps, _film(block, emb))


def _film(block, emb: Optional[torch.Tensor]):
    """FiLM (ca, cb) [N, Cout] from the embedding, as ResBlock.forward
    computes it."""
    if emb is None:
        return None
    proj = block.cond_proj
    ab = F.linear(F.gelu(emb), proj.weight.to(emb.dtype), proj.bias.to(emb.dtype))
    return tuple(ab.chunk(2, dim=-1))


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float32 parameter rounded to the compute dtype, kept in float32."""
    return t.detach().to(dtype).float()


# ------------------------------------------------------------ plain version


def fused_resblock_plain(
    block,
    x: torch.Tensor,
    emb: Optional[torch.Tensor] = None,
    x2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel pair's function in plain PyTorch: ResBlock.forward on
    concat(x, x2) with the kernels' rounding points (g, h1 and z rounded to
    x's dtype, convolutions in float32, the skip added in float32 and the
    output rounded once). [N, Cin, T] -> [N, Cout, T] in x's dtype."""
    xs = _inputs(block, x, emb, x2)
    dtype = x.dtype
    mean1, a1, b1 = _norm_in_affine(block, xs, group_norm_coeffs_plain)
    xc = torch.cat(xs, dim=1) if len(xs) > 1 else x
    g = group_norm_apply_plain(xc, mean1, a1, b1, True)

    def conv(inp, layer):
        c = layer.conv
        return F.conv1d(inp.float(), _rounded(c.weight, dtype), _rounded(c.bias, dtype),
                        padding=c.padding, dilation=c.dilation)

    h1 = conv(g, block.conv_in).to(dtype)
    norm = block.norm_mid.norm
    mean2, var2 = group_stats_plain(h1, norm.num_groups)
    folded = fold_affine(mean2, var2, norm.weight, norm.bias, norm.eps,
                         _film(block, emb))
    z = group_norm_apply_plain(h1, *folded, True)
    skip = xc.float() if block.skip_proj is None else conv(xc, block.skip_proj)
    return (conv(z, block.conv_out) + skip).to(dtype)


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("fused_resblock")
    for fn, want in ((lib.fused_resblock_max_dilation, MAX_DILATION),
                     (lib.fused_resblock_max_cout, MAX_COUT),
                     (lib.fused_resblock_stats_tile, STATS_TILE),
                     (lib.fused_resblock_weight_align, WEIGHT_ALIGN)):
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"csrc/fused_resblock.cu: {fn.__name__} is {fn()}, "
                               f"the wrapper expects {want}")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_resblock_stats.argtypes = [i, p, p, i, i] + [p] * 6 + [i, i, i, p]
    lib.fused_resblock_stats.restype = i
    lib.fused_resblock_apply.argtypes = [i, p, p, i, i] + [p] * 13 + [i, i, i, i, p]
    lib.fused_resblock_apply.restype = i
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _conv_weight(layer, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch conv weight [Cout, Cin, K] -> the kernels' MMA operand [K, Cout,
    Cin'] in the compute dtype, row-major per tap, with Cin zero-padded to
    Cin' = a multiple of ``WEIGHT_ALIGN`` so every row is whole 16-byte
    copies; and the bias rounded to the dtype, in float32."""
    c = layer.conv
    cout, cin, taps = c.weight.shape
    w = torch.zeros((taps, cout, -(-cin // WEIGHT_ALIGN) * WEIGHT_ALIGN), dtype=dtype,
                    device=c.weight.device)
    w[:, :, :cin] = c.weight.detach().permute(2, 0, 1)
    return w, _rounded(c.bias, dtype)


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def fused_resblock_stats(xs, norm1, conv_in) -> torch.Tensor:
    """Kernel 4: float32 (count, mean, M2) [3, N, Cout, tiles] of
    h1 = conv_in(gelu(GroupNorm-1(x))) per tile of ``STATS_TILE``."""
    x = xs[0]
    n, c1, t = x.shape
    c2 = xs[1].shape[1] if len(xs) > 1 else 0
    cout = conv_in[1].shape[0]
    tiles = -(-t // STATS_TILE)
    part = torch.empty((3, n, cout, tiles), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().fused_resblock_stats(
            _DTYPE_CODE[x.dtype], x.data_ptr(), _ptr(xs[1]) if c2 else None, c1, c2,
            *(_ptr(v) for v in norm1), *(_ptr(v) for v in conv_in), part.data_ptr(),
            n, t, cout, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, "fused_resblock_stats")
    fused_resblock_stats.launches += 1
    return part


def fused_resblock_apply(xs, norm1, conv_in, norm2, conv_out, skip,
                         dilation: int) -> torch.Tensor:
    """Kernel 5: out = conv_out(gelu(GroupNorm-2 + FiLM of h1)) + skip,
    [N, Cout, T] in x's dtype. ``skip`` is the 1x1 projection's
    ``_conv_weight`` or (None, None) for the identity."""
    x = xs[0]
    n, c1, t = x.shape
    c2 = xs[1].shape[1] if len(xs) > 1 else 0
    cout = conv_out[1].shape[0]
    out = torch.empty((n, cout, t), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().fused_resblock_apply(
            _DTYPE_CODE[x.dtype], x.data_ptr(), _ptr(xs[1]) if c2 else None, c1, c2,
            *(_ptr(v) for v in norm1), *(_ptr(v) for v in conv_in),
            *(_ptr(v) for v in norm2), *(_ptr(v) for v in conv_out),
            *(_ptr(v) for v in skip), out.data_ptr(), n, t, cout, dilation,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, "fused_resblock_apply")
    fused_resblock_apply.launches += 1
    return out


fused_resblock_stats.launches = 0
fused_resblock_apply.launches = 0


def fused_resblock(
    block,
    x: torch.Tensor,
    emb: Optional[torch.Tensor] = None,
    x2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Same-resolution ``ResBlock`` forward on concat(x, x2) ([N, C, T]
    each, the concat never materialised): the plain version for CPU
    tensors, the two kernels for CUDA tensors. The pair has no backward:
    with grad enabled, an input or a parameter that requires grad raises,
    on either device, rather than taking a path autograd could run through."""
    _inputs(block, x, emb, x2)
    if torch.is_grad_enabled() and any(
            v is not None and v.requires_grad for v in (x, emb, x2, *block.parameters())):
        raise RuntimeError("the fused ResBlock has no backward: run gradients through "
                           "the unfused block (load with fuse_levels=0), or call it "
                           "under torch.no_grad()")
    if any(TP_AXES in m.__dict__ for m in block.modules()):
        with gathered(block):
            return _fused_resblock(block, x, emb, x2)
    return _fused_resblock(block, x, emb, x2)


def _fused_resblock(block, x, emb, x2) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_resblock_plain(block, x, emb, x2)
    xs = (x,) if x2 is None else (x, x2)
    dtype = x.dtype
    norm1 = _norm_in_affine(block, xs, group_norm_coeffs)
    conv_in = _conv_weight(block.conv_in, dtype)
    part = fused_resblock_stats(xs, norm1, conv_in)

    norm2 = _norm_mid_affine(block, part, emb)
    skip = (None, None)
    if block.skip_proj is not None:
        skip = _conv_weight(block.skip_proj, dtype)
    return fused_resblock_apply(xs, norm1, conv_in, norm2,
                                _conv_weight(block.conv_out, dtype), skip,
                                block.conv_out.conv.dilation[0])
