"""The plain reference of the benchmark's models: the VQ-VAE of
unixpickle/vq-voice-swap (``vq_voice_swap/vq_vae.py``, ``models/unet.py``,
``models/mfcc_encoder.py``) with the UNet predictor, the UNet or MFCC
encoder and the DPM++(2M) sampler, written with plain ``torch`` operations
in float32. It imports nothing of the program under test; its module and
parameter names equal the program's, so one state dict loads into both.

``Quant(bits, min_t)`` rounds what the program's int8 serving path stores
as int8 to a symmetric grid of that many bits, each weight of a
convolution that reads such a value per output channel: at 4 bits it is
the control of an int8 cell (the nearest precision below the one it
states). ``quantize_convs`` rounds every convolution's input and weight
to int8, ``fp8_everywhere`` every stored activation and weight through
float8, and ``dpmpp_sample``'s ``state_dtype`` the sampler's state: the
controls of the stages that run in bfloat16 and float32."""

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["VQVAE", "dpmpp_sample", "dpmpp_update", "fake_quant", "alpha_exp", "quantize_convs",
           "fp8_everywhere", "loss_parts", "distances", "Quant"]


def fake_quant(x: torch.Tensor, bits: int, dim=None) -> torch.Tensor:
    """x on a symmetric grid of ``bits`` bits, one scale for the tensor (or
    one per index of ``dim``, the others reduced)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    if dim is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=[d for d in range(x.ndim) if d != dim], keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / qmax
    return torch.round(x / scale).clamp(-qmax, qmax) * scale


class Quant:
    """Where the int8 serving path stores int8: time axes of at least
    ``min_t``; ``bits`` 0 is off."""

    def __init__(self, bits: int = 0, min_t: int = 0):
        self.bits, self.min_t = bits, min_t

    def on(self, t: int) -> bool:
        return bool(self.bits) and t >= self.min_t

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return fake_quant(x, self.bits) if self.on(x.shape[-1]) else x


def group_count(ch: int, max_groups: int = 32) -> int:
    g = max_groups
    while ch % g:
        g //= 2
    return g


def round_fp8(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """x through a float8 format (e4m3: 3 mantissa bits; e5m2: 2), one
    scale for the tensor that puts its largest magnitude at the format's
    largest."""
    top = torch.finfo(fmt).max
    scale = torch.clamp(x.detach().abs().amax().float(), min=1e-12) / top
    return ((x / scale).to(fmt).to(x.dtype) * scale).to(x.dtype)


class Fp8(torch.autograd.Function):
    """float8 training's rounding: the value through e4m3 in the forward,
    its gradient through e5m2 in the backward."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2)


class Conv1d(nn.Module):
    """``rounds`` (a control: ``quantize_convs``, ``fp8_everywhere``)
    rounds the input and the weight of every call; ``wbits`` rounds the
    weight of one call (the int8 serving path's int8 convolutions)."""

    def __init__(self, cin: int, cout: int, k: int = 3, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, dilation=dilation, padding=(k - 1) * dilation // 2)
        self.rounds = None

    def forward(self, x: torch.Tensor, wbits: int = 0) -> torch.Tensor:
        c = self.conv
        w = fake_quant(c.weight, wbits, dim=0) if wbits else c.weight
        if self.rounds is not None:
            x, w = self.rounds[0](x), self.rounds[1](w)
        return F.conv1d(x, w, c.bias, padding=c.padding, dilation=c.dilation)


def quantize_convs(model: nn.Module, bits: int) -> None:
    """Round every convolution's input (one scale a tensor) and weight (one
    an output channel) to ``bits`` bits: the control of a stage that the
    program serves in bfloat16 (a forward without gradients)."""
    for m in model.modules():
        if isinstance(m, Conv1d):
            m.rounds = (lambda x: fake_quant(x, bits), lambda w: fake_quant(w, bits, dim=0))


def fp8_everywhere(model: nn.Module) -> None:
    """Compute a training step a precision below bfloat16, as float8
    training does (``Fp8``): every convolution's input and weight and the
    output of every block, norm and dense layer through e4m3, and their
    gradients through e5m2 (the control of a bfloat16 training cell)."""
    for m in model.modules():
        if isinstance(m, Conv1d):
            m.rounds = (Fp8.apply, Fp8.apply)
        if isinstance(m, (ResBlock, GroupNorm, TimeEmbedding, nn.Linear, nn.Embedding)):
            m.register_forward_hook(lambda mod, args, out: Fp8.apply(out))


class GroupNorm(nn.Module):
    def __init__(self, ch: int, use_gelu: bool = False):
        super().__init__()
        self.norm = nn.GroupNorm(group_count(ch), ch, eps=1e-5)
        self.use_gelu = use_gelu

    def forward(self, x, film=None):
        h = F.group_norm(x, self.norm.num_groups, self.norm.weight, self.norm.bias, 1e-5)
        if film is not None:
            h = h * (film[0][..., None] + 1.0) + film[1][..., None]
        return F.gelu(h) if self.use_gelu else h


class TimeEmbedding(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.channels = ch
        self.proj = nn.Linear(ch, ch)

    def forward(self, ts):
        half = self.channels // 2
        freqs = 100.0 * torch.exp(-math.log(1000.0) * torch.arange(half, device=ts.device) / (half - 1))
        args = ts.float()[:, None] * freqs[None]
        feats = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        return self.proj(feats.to(self.proj.weight.dtype))


class ResBlock(nn.Module):
    def __init__(self, cin, cout=None, emb=None, scale=1.0, dilation=2):
        super().__init__()
        cout = cout or cin
        self.scale = scale
        self.norm_in = GroupNorm(cin, use_gelu=True)
        self.conv_in = Conv1d(cin, cout, 3)
        self.norm_mid = GroupNorm(cout, use_gelu=True)
        self.cond_proj = nn.Linear(emb, cout * 2) if emb else None
        self.conv_out = Conv1d(cout, cout, 3, dilation=dilation)
        self.skip_proj = Conv1d(cin, cout, 1) if cin != cout else None

    def resize(self, x):
        if self.scale < 1.0:
            n, c, t = x.shape
            return x.reshape(n, c, t // 2, 2).mean(dim=-1)
        if self.scale > 1.0:
            return torch.repeat_interleave(x, 2, dim=-1)
        return x

    def forward(self, x, emb=None, q: Quant = Quant()):
        t_out = x.shape[-1] if self.scale == 1.0 else (
            x.shape[-1] // 2 if self.scale < 1.0 else x.shape[-1] * 2)
        wb = q.bits if q.on(t_out) else 0
        h = self.conv_in(q.act(self.resize(self.norm_in(x))), wb)
        film = None
        if emb is not None:
            film = self.cond_proj(F.gelu(emb)).chunk(2, dim=-1)
        h = self.conv_out(q.act(self.norm_mid(h, film)), wb)
        skip = self.resize(x)
        if self.skip_proj is not None:
            skip = self.skip_proj(skip, wb)
        return q.act(skip + h)


class UNetPredictor(nn.Module):
    def __init__(self, base_channels, channel_mult=(1, 1, 2, 2, 2, 4, 4, 8, 8),
                 middle_dilations=(4, 8, 16, 32), depth_mult=2, cond_channels=None,
                 num_labels=None):
        super().__init__()
        ch = base_channels
        emb = ch * 4
        self.depth_mult = depth_mult
        self.time_embed = TimeEmbedding(emb)
        self.time_embed_extra = nn.Linear(emb, emb)
        if num_labels is not None:
            self.class_embed = nn.Embedding(num_labels, emb)
        if cond_channels is not None:
            self.cond_proj = Conv1d(cond_channels, ch, 3)
        self.in_conv = Conv1d(1, ch, 3)
        skips, cur, down = [ch], ch, []
        for depth, mult in enumerate(channel_mult):
            for _ in range(depth_mult):
                down.append(ResBlock(cur, mult * ch, emb))
                cur = mult * ch
                skips.append(cur)
            if depth != len(channel_mult) - 1:
                down.append(ResBlock(cur, emb=emb, scale=0.5))
                skips.append(cur)
        self.down_blocks = nn.ModuleList(down)
        self.middle_blocks = nn.ModuleList(ResBlock(cur, emb=emb, dilation=d)
                                           for d in middle_dilations)
        up = []
        for depth, mult in list(enumerate(channel_mult))[::-1]:
            for _ in range(depth_mult + 1):
                up.append(ResBlock(cur + skips.pop(), mult * ch, emb))
                cur = mult * ch
            if depth:
                up.append(ResBlock(cur, emb=emb, scale=2.0))
        self.up_blocks = nn.ModuleList(up)
        self.out_norm = GroupNorm(cur, use_gelu=True)
        self.out_conv = Conv1d(cur, 1, 3)

    def forward(self, x, ts, cond=None, labels=None, q: Quant = Quant()):
        """x [N, T, 1], ts [N], cond [N, T1, C] -> eps [N, T, 1]."""
        emb = self.time_embed_extra(F.gelu(self.time_embed(ts)))
        if labels is not None:
            emb = emb + self.class_embed(labels)
        h = self.in_conv(x.transpose(1, 2))
        if cond is not None:
            c = self.cond_proj(cond.transpose(1, 2))
            pos = torch.arange(h.shape[-1], dtype=torch.float32, device=x.device) * (
                c.shape[-1] / h.shape[-1])
            h = h + c[..., torch.floor(pos).long()]
        h = q.act(h)

        def run(b, h):
            return b(h, emb, q)

        skips = [h]
        for b in self.down_blocks:
            h = run(b, h)
            skips.append(h)
        for b in self.middle_blocks:
            h = run(b, h)
        for i, b in enumerate(self.up_blocks):
            if i % (self.depth_mult + 2) == self.depth_mult + 1:
                h = run(b, h)
            else:
                h = run(b, torch.cat([h, skips.pop()], dim=1))
        return self.out_conv(self.out_norm(h)).transpose(1, 2)


class UNetEncoder(nn.Module):
    def __init__(self, base_channels, channel_mult=(1, 1, 2, 2, 2, 4, 4, 8), depth_mult=2,
                 out_channels=512):
        super().__init__()
        ch = base_channels
        self.in_conv = Conv1d(1, ch, 3)
        blocks, cur = [], ch
        for depth, mult in enumerate(channel_mult):
            for _ in range(depth_mult):
                blocks.append(ResBlock(cur, mult * ch))
                cur = mult * ch
            if depth != len(channel_mult) - 1:
                blocks.append(ResBlock(cur, scale=0.5))
        self.blocks = nn.ModuleList(blocks)
        self.out_norm = GroupNorm(cur, use_gelu=True)
        self.out_conv = Conv1d(cur, out_channels, 3)
        self.downsample_rate = 2 ** (len(channel_mult) - 1)

    def forward(self, x):
        h = self.in_conv(x.transpose(1, 2))
        for b in self.blocks:
            h = b(h)
        return self.out_conv(self.out_norm(h)).transpose(1, 2)


def _mel_fb(n_freqs, n_mels, sr):
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)  # noqa: E731
    m_pts = np.linspace(mel(0.0), mel(sr / 2.0), n_mels + 2)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    freqs = np.linspace(0, sr // 2, n_freqs)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    return np.maximum(0.0, np.minimum(-slopes[:, :-2] / f_diff[:-1], slopes[:, 2:] / f_diff[1:]))


def _dct(n_mfcc, n_mels):
    n, k = np.arange(n_mels)[:, None], np.arange(n_mfcc)[None, :]
    d = np.cos(np.pi / n_mels * (n + 0.5) * k) * np.sqrt(2.0 / n_mels)
    d[:, 0] /= np.sqrt(2.0)
    return d


class ConvMFCCEncoder(nn.Module):
    """Version 1: mu-law inversion, 13 MFCCs of 40 log-mels (torchaudio's
    defaults: centred reflect-padded frames, periodic Hann window, HTK
    mels), deltas, then the conv stack."""

    def __init__(self, base_channels, out_channels, sr=16000, mfcc_rate=100):
        super().__init__()
        mid = base_channels * 12
        self.hop, self.n_fft = sr // mfcc_rate, 2 * (sr // mfcc_rate)
        self.fb = _mel_fb(self.n_fft // 2 + 1, 40, sr).astype(np.float32)
        self.dct = _dct(13, 40).astype(np.float32)
        self.window = np.hanning(self.n_fft + 1)[:-1].astype(np.float32)
        self.conv_in = Conv1d(39, mid, 3)
        self.res = nn.ModuleList([Conv1d(mid, mid, 3)])
        self.down_conv = nn.Conv1d(mid, mid, 4, stride=2, padding=1)
        self.res_3 = nn.ModuleList(Conv1d(mid, mid, 3) for _ in range(2))
        self.res_1 = nn.ModuleList(Conv1d(mid, mid, 1) for _ in range(4))
        self.out_conv = Conv1d(mid, out_channels, 1)
        self.downsample_rate = sr // (mfcc_rate // 2)

    def forward(self, x):
        wav = x[..., 0]
        wav = torch.sign(wav) * (1.0 / 255.0) * (256.0 ** wav.abs() - 1.0)
        pad = self.n_fft // 2
        wav = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
        const = lambda a: torch.as_tensor(a, device=x.device)  # noqa: E731
        frames = wav.unfold(-1, self.n_fft, self.hop) * const(self.window)
        spec = torch.fft.rfft(frames, dim=-1).abs() ** 2
        h = torch.log(spec @ const(self.fb) + 1e-6) @ const(self.dct)

        def delta(s):
            return (torch.cat([s[:, :1], s[:, :-1]], 1) - torch.cat([s[:, 1:], s[:, -1:]], 1)) / 2

        d1 = delta(h)
        h = torch.cat([h, d1, delta(d1)], dim=-1).transpose(1, 2)
        h = F.gelu(self.conv_in(h))
        h = h + F.gelu(self.res[0](h))
        h = F.gelu(self.down_conv(h))
        for conv in (*self.res_3, *self.res_1):
            h = h + F.gelu(conv(h))
        return self.out_conv(h).transpose(1, 2)


class Codebook(nn.Module):
    def __init__(self, n, c, dead_rate=100):
        super().__init__()
        self.dictionary = nn.Parameter(torch.zeros(n, c))
        self.register_buffer("usage_count", torch.full((n,), dead_rate, dtype=torch.int32))


def distances(dictionary, x):
    """Squared L2 distances [..., D] of the rows of x [..., C] to the codes."""
    return (x * x).sum(-1, keepdim=True) - 2.0 * x @ dictionary.t() + (dictionary ** 2).sum(-1)


class VQVAE(nn.Module):
    def __init__(self, base_channels, enc_name, dictionary_size=512, num_labels=None,
                 cond_mult=16, pred_name="unet", dead_rate=100, **_):
        super().__init__()
        if pred_name != "unet":
            raise ValueError("the reference has the unet predictor only")
        cond = base_channels * cond_mult
        self.predictor = UNetPredictor(base_channels, cond_channels=cond, num_labels=num_labels)
        if enc_name == "conv-mfcc-ulaw":
            self.encoder = ConvMFCCEncoder(base_channels, cond)
        elif enc_name == "unet128":
            self.encoder = UNetEncoder(base_channels, out_channels=cond)
        else:
            raise ValueError(f"the reference has no encoder {enc_name!r}")
        self.vq = Codebook(dictionary_size, cond, dead_rate)


def alpha_exp(t: torch.Tensor) -> torch.Tensor:
    """The "exp" schedule: alpha(t) = exp(-k t^2), alpha(1) = 1e-5."""
    return torch.exp(math.log(1e-5) * torch.square(t))


def grid_time(i: int, steps: int) -> float:
    return float(np.float32(steps - i) * np.float32(1.0 / steps))


def dpmpp_update(i: int, steps: int, x: torch.Tensor, eps: torch.Tensor, prev, constrain: bool):
    """Step i of DPM-Solver++(2M) in half-log-SNR space, first order on the
    first and the last step; ``constrain`` centres each x0 prediction and
    clips it to [-1, 1]. ``prev`` is the last step's (x0, lambda), None at
    the first. Returns the next x and this step's (x0, lambda)."""
    n = x.shape[0]
    ts = torch.full((n,), grid_time(i, steps), device=x.device)
    tn = torch.full((n,), grid_time(i + 1, steps), device=x.device)
    a_t, a_n = alpha_exp(ts)[:, None, None], alpha_exp(tn)[:, None, None]
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) * torch.rsqrt(a_t)
    if constrain:
        x0 = torch.clamp(x0 - x0.mean(dim=(1, 2), keepdim=True), -1.0, 1.0)
    al_t, sg_t, al_n, sg_n = a_t.sqrt(), (1 - a_t).sqrt(), a_n.sqrt(), (1 - a_n).sqrt()
    exp_neg_h = (al_t * sg_n) / (sg_t * al_n)
    lam = 0.5 * (torch.log(a_t) - torch.log1p(-a_t))
    if 0 < i < steps - 1:
        lam_next = 0.5 * (torch.log(a_n) - torch.log1p(-a_n))
        r = (lam - prev[1]) / (lam_next - lam)
        d = x0 + (x0 - prev[0]) * (0.5 / r)
    else:
        d = x0
    return (sg_n / sg_t) * x - al_n * (exp_neg_h - 1.0) * d, (x0, lam)


def dpmpp_sample(x_T: torch.Tensor, predictor, steps: int, constrain: bool = True,
                 state_dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """The sampler from x_T: [x_0 = x_T, eps_0, x_1, eps_1, ..., x_steps];
    ``state_dtype`` rounds every new state to that type (a control)."""
    x, prev, seq = x_T, None, [x_T]
    for i in range(steps):
        ts = torch.full((x.shape[0],), grid_time(i, steps), device=x.device)
        eps = predictor(x, ts)
        x, prev = dpmpp_update(i, steps, x, eps, prev, constrain)
        if state_dtype is not None:
            x = x.to(state_dtype).float()
        seq += [eps, x]
    return seq


def loss_parts(model: VQVAE, x, labels, ts, eps, commitment: float = 0.25):
    """The VQ-VAE training loss of x [N, T, 1] with the given draws: (mse +
    vq loss, each row's mse [N], the vq loss, their codes). The model may
    compute in a lower type; the loss is taken in float32."""
    dtype = model.vq.dictionary.dtype
    enc = model.encoder(x.to(dtype)).float()
    flat = enc.reshape(-1, enc.shape[-1])
    d = model.vq.dictionary.float()
    with torch.no_grad():
        idxs = distances(d, flat).argmin(dim=-1)
    emb = d[idxs].reshape(enc.shape)
    vq_loss = torch.mean((enc.detach() - emb) ** 2) + commitment * torch.mean((enc - emb.detach()) ** 2)
    cond = enc + (emb - enc).detach()
    a = alpha_exp(ts)[:, None, None]
    noised = a.sqrt() * x + (1 - a).sqrt() * eps
    pred = model.predictor(noised.to(dtype), ts, cond.to(dtype), labels).float()
    mses = ((pred - eps) ** 2).reshape(x.shape[0], -1).mean(dim=1)
    return mses.mean() + vq_loss, mses.detach(), vq_loss.detach(), idxs
