"""Operations and bytes of the benchmark's models, worked out from their
shapes, and the published peaks of the card they are held to.

A layer is a dict: ``op`` ("conv", "dense", "matmul", "group_norm" or
"quantize"), its per-sample FLOPs (2 per multiply-add, as
``torch.utils.flop_counter`` counts them) and, for a GroupNorm or a
quantize, its channels ``c`` and length ``t``. ``int8`` marks a
convolution that the int8 serving path runs on int8 codes (its input is
stored as int8: a time axis of at least ``act_int8_min_t``).

On that path an activation is stored as "float", "int8" (one scale) or
"int8c" (a scale a channel: the up path's concat of two int8 tensors),
as the port's ``models/layers.py`` ``ResBlock`` and ``models/unet.py``
route it. A GroupNorm's ``x`` is how its input is stored (its statistics
read codes where it is int8) and its ``apply`` "float", "int8" (the apply
reads codes) or "fused" (a quantize recomputes the apply: no apply
launch). A quantize (two launches: amax, then codes) has a prologue
``pro``: "norm" (a GroupNorm's apply, on ``x``), "residual" (``skip`` +
a float h) or "none"."""

from typing import Dict, List, Sequence, Tuple

__all__ = ["PEAK", "HBM_BYTES_PER_S", "unet_predictor_layers", "unet_encoder_layers",
           "mfcc_encoder_layers", "encoder_layers", "code_length", "predictor_layers", "vq_flops",
           "swap_batch_flops", "train_step_flops", "group_norm_bytes", "group_norm_bwd_bytes",
           "stored_bytes", "quantize_bytes", "conv_int8_bound_s", "peak_time_s"]

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W).
PEAK = {"bfloat16": 989e12, "float16": 989e12, "int8": 1979e12, "tf32": 495e12,
        "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ESIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def _conv(cin: int, cout: int, k: int, t_out: int, int8: bool = False) -> Dict:
    return {"op": "conv", "flops": 2 * cin * cout * k * t_out, "int8": int8,
            "cin": cin, "cout": cout, "k": k, "t": t_out}


def _dense(cin: int, cout: int) -> Dict:
    return {"op": "dense", "flops": 2 * cin * cout, "int8": False}


def _gn(c: int, t: int, film: bool, x: str = "float", apply: str = "float") -> Dict:
    return {"op": "group_norm", "flops": 0, "c": c, "t": t, "film": film, "x": x,
            "apply": apply}


def _quantize(c: int, t: int, pro: str, x: str = "float", skip: str = "") -> Dict:
    return {"op": "quantize", "flops": 0, "c": c, "t": t, "pro": pro, "x": x, "skip": skip}


def _stored(t: int, min_t: int) -> bool:
    return bool(min_t) and t >= min_t


def _resblock(cin: int, cout: int, emb: int, t_in: int, scale: float, min_t: int,
              x: str = "float") -> Tuple[List[Dict], str]:
    """The block's layers on an input stored as ``x``, and how its output
    is stored."""
    t_out = t_in if scale == 1.0 else (t_in // 2 if scale < 1.0 else t_in * 2)
    q = _stored(t_out, min_t)
    if q and scale >= 1.0:
        layers = [_gn(cin, t_in, False, x, "fused"), _quantize(cin, t_in, "norm", x)]
    else:
        layers = [_gn(cin, t_in, False, x, "float" if x == "float" else "int8")]
        if q:
            layers.append(_quantize(cin, t_out, "none"))
    layers.append(_conv(cin, cout, 3, t_out, q))
    if emb:
        layers.append(_dense(emb, 2 * cout))
    if q:
        layers += [_gn(cout, t_out, bool(emb), "float", "fused"), _quantize(cout, t_out, "norm")]
    else:
        layers.append(_gn(cout, t_out, bool(emb)))
    layers.append(_conv(cout, cout, 3, t_out, q))
    skip = x
    if cin != cout:
        layers.append(_conv(cin, cout, 1, t_out, x != "float"))
        skip = "float"
    if q:
        return layers + [_quantize(cout, t_out, "residual", "float", skip)], "int8"
    return layers, "float"


def _concat(a: str, b: str) -> str:
    if (a == "float") != (b == "float"):
        raise ValueError("a skip concat mixes int8 and float activations")
    return "float" if a == "float" else "int8c"


def unet_predictor_layers(base: int, t: int, cond_channels: int, cond_t: int,
                          channel_mult: Sequence[int] = (1, 1, 2, 2, 2, 4, 4, 8, 8),
                          middle: int = 4, depth_mult: int = 2,
                          act_int8_min_t: int = 0) -> List[Dict]:
    """Every layer of one UNet predictor forward of one sample of t."""
    ch, emb, min_t = base, base * 4, act_int8_min_t
    layers = [_dense(emb, emb), _dense(emb, emb)]
    if cond_channels:
        layers.append(_conv(cond_channels, ch, 3, cond_t))
    layers.append(_conv(1, ch, 3, t))
    kind = "float"
    if _stored(t, min_t):
        layers.append(_quantize(ch, t, "none"))
        kind = "int8"

    def block(cin: int, cout: int, scale: float, x: str) -> str:
        got, out = _resblock(cin, cout, emb, length, scale, min_t, x)
        layers.extend(got)
        return out

    skips, cur, length = [(ch, kind)], ch, t
    for depth, mult in enumerate(channel_mult):
        for _ in range(depth_mult):
            kind = block(cur, mult * ch, 1.0, kind)
            cur = mult * ch
            skips.append((cur, kind))
        if depth != len(channel_mult) - 1:
            kind = block(cur, cur, 0.5, kind)
            length //= 2
            skips.append((cur, kind))
    for _ in range(middle):
        kind = block(cur, cur, 1.0, kind)
    for depth, mult in list(enumerate(channel_mult))[::-1]:
        for _ in range(depth_mult + 1):
            c, k = skips.pop()
            kind = block(cur + c, mult * ch, 1.0, _concat(kind, k))
            cur = mult * ch
        if depth:
            kind = block(cur, cur, 2.0, kind)
            length *= 2
    out_apply = "float" if kind == "float" else "int8"
    return layers + [_gn(cur, length, False, kind, out_apply), _conv(cur, 1, 3, length)]


def unet_encoder_layers(base: int, t: int, out_channels: int,
                        channel_mult: Sequence[int] = (1, 1, 2, 2, 2, 4, 4, 8),
                        depth_mult: int = 2) -> List[Dict]:
    """The down-only UNet encoder (``unet128``) on one sample of t."""
    ch = base
    layers, cur, length = [_conv(1, ch, 3, t)], ch, t
    for depth, mult in enumerate(channel_mult):
        for _ in range(depth_mult):
            layers += _resblock(cur, mult * ch, 0, length, 1.0, 0)[0]
            cur = mult * ch
        if depth != len(channel_mult) - 1:
            layers += _resblock(cur, cur, 0, length, 0.5, 0)[0]
            length //= 2
    return layers + [_gn(cur, length, False), _conv(cur, out_channels, 3, length)]


def mfcc_encoder_layers(base: int, t: int, out_channels: int, sr: int = 16000,
                        rate: int = 100) -> List[Dict]:
    """The MFCC conv encoder on one sample of t (the FFT is not counted)."""
    hop = sr // rate
    frames = t // hop + 1
    mid = base * 12
    half = (frames + 2 - 4) // 2 + 1
    layers = [{"op": "matmul", "flops": 2 * frames * (hop + 1) * 40, "int8": False},
              {"op": "matmul", "flops": 2 * frames * 40 * 13, "int8": False},
              _conv(39, mid, 3, frames), _conv(mid, mid, 3, frames), _conv(mid, mid, 4, half)]
    layers += [_conv(mid, mid, 3, half) for _ in range(2)]
    layers += [_conv(mid, mid, 1, half) for _ in range(4)]
    return layers + [_conv(mid, out_channels, 1, half)]


def encoder_layers(model: Dict, t: int) -> List[Dict]:
    out = model["base_channels"] * model.get("cond_mult", 16)
    if model["enc_name"] == "conv-mfcc-ulaw":
        return mfcc_encoder_layers(model["base_channels"], t, out)
    if model["enc_name"] == "unet128":
        return unet_encoder_layers(model["base_channels"], t, out)
    raise ValueError(f"no counts for the encoder {model['enc_name']!r}")


def code_length(model: Dict, t: int) -> int:
    """Codes of one sample of t: the MFCC encoder's frames at 50 a second,
    the UNet encoder's at one a 128 samples."""
    return t // (320 if model["enc_name"] == "conv-mfcc-ulaw" else 128)


def predictor_layers(model: Dict, t: int, act_int8_min_t: int = 0) -> List[Dict]:
    cond = model["base_channels"] * model.get("cond_mult", 16)
    return unet_predictor_layers(model["base_channels"], t, cond, code_length(model, t),
                                 act_int8_min_t=act_int8_min_t)


def vq_flops(model: Dict, t: int) -> int:
    """The nearest-code search of one sample: its rows against the codebook."""
    c = model["base_channels"] * model.get("cond_mult", 16)
    return 2 * code_length(model, t) * c * model["dictionary_size"]


def peak_time_s(layers: Sequence[Dict], n: int, dtype: str) -> float:
    """Least time of n samples through ``layers`` at the card's peaks:
    each convolution and dense layer at the peak of the type it runs in
    (int8 where marked, else ``dtype``), the host-side matmuls in float32."""
    total = 0.0
    for layer in layers:
        if layer["op"] in ("group_norm", "quantize"):
            continue
        kind = "int8" if layer["int8"] else ("float32" if layer["op"] == "matmul" else dtype)
        total += n * layer["flops"] / PEAK[kind]
    return total


def swap_batch_flops(model: Dict, n: int, t: int, steps: int, act_int8_min_t: int = 0) -> int:
    """FLOPs of one swap batch: an encode and ``steps`` predictor calls."""
    enc = sum(layer["flops"] for layer in encoder_layers(model, t)) + vq_flops(model, t)
    pred = sum(layer["flops"] for layer in predictor_layers(model, t, act_int8_min_t))
    return n * (enc + steps * pred)


def train_step_flops(model: Dict, n: int, t: int) -> int:
    """FLOPs of one train step: three times the forward of the encoder and
    the predictor (forward, and a backward of twice its operations)."""
    fwd = sum(layer["flops"] for layer in encoder_layers(model, t) + predictor_layers(model, t))
    return 3 * n * fwd


def stored_bytes(n: int, c: int, t: int, dtype: str, kind: str) -> int:
    """Bytes of an [n, c, t] activation stored as ``kind``: ``dtype``
    values, or int8 codes with one float32 scale or one a channel."""
    if kind == "float":
        return n * c * t * ESIZE[dtype]
    return n * c * t + 4 * (c if kind == "int8c" else 1)


def group_norm_bytes(n: int, c: int, t: int, dtype: str, film: bool, x: str = "float",
                     apply: str = "float") -> Dict[str, int]:
    """Least bytes of one GroupNorm's launches: the statistics read x (as
    stored) and the affine (and FiLM) and write (mean, a, b); the apply,
    unless a quantize recomputes it, reads x and (mean, a, b) and writes y
    in ``dtype``."""
    xin = stored_bytes(n, c, t, dtype, x)
    coeffs = 3 * n * c * 4
    out = {"stats": xin + 2 * c * 4 + (2 * n * c * 4 if film else 0) + coeffs}
    if apply != "fused":
        out["apply"] = xin + coeffs + n * c * t * ESIZE[dtype]
    return out


def quantize_bytes(n: int, layer: Dict, dtype: str) -> int:
    """Least bytes of one quantize's two launches: its inputs read once
    (x; a "norm" prologue's (mean, a, b); a "residual" prologue's skip),
    the codes and their scale written once."""
    c, t = layer["c"], layer["t"]
    total = stored_bytes(n, c, t, dtype, layer["x"]) + n * c * t + 4
    if layer["pro"] == "norm":
        total += 3 * n * c * 4
    elif layer["pro"] == "residual":
        total += stored_bytes(n, c, t, dtype, layer["skip"])
    return total


def group_norm_bwd_bytes(n: int, c: int, t: int, dtype: str, film: bool) -> int:
    """Least bytes of one GroupNorm backward: x and dy read, dx written,
    the group statistics and the affine (and FiLM) read, their gradients
    written."""
    small = 4 * c * 4 + (4 * n * c * 4 if film else 0)
    return 3 * n * c * t * ESIZE[dtype] + small


def conv_int8_bound_s(n: int, layer: Dict, out_dtype: str) -> float:
    """Least time of one int8 convolution: the larger of its operations at
    the int8 peak and its bytes (codes in, weights, float output)."""
    ops = n * layer["flops"] / PEAK["int8"]
    nbytes = (n * layer["cin"] * layer["t"] + layer["cout"] * layer["cin"] * layer["k"]
              + 4 * layer["cout"] + n * layer["cout"] * layer["t"] * ESIZE[out_dtype])
    return max(ops, nbytes / HBM_BYTES_PER_S)
