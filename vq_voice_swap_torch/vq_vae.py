"""VQ-VAE with a diffusion decoder, for speaker conversion (counterpart of
``vq_voice_swap_tpu/vq_vae.py``): the training losses (encoder, optional
temporal jitter, VQ, the VQ loss and the conditional diffusion MSE), and
encode, embed, and decode with the DDPM, DDIM and DPM++ samplers, with
encoder-predictor guidance or classifier-free guidance."""

import math
from typing import Any, Dict, Optional, Sequence

import torch

from .diffusion.process import CondFn, PredictorFn
from .diffusion.warp import TimeWarp
from .diffusion_model import DiffusionModel
from .model_base import register_model
from .models import make_encoder
from .observe import span
from .vq import Codebook, VQLossConfig, vq_forward, vq_loss_fn

__all__ = ["VQVAE", "jitter_seq"]


def jitter_seq(seq: torch.Tensor, p: float, nums: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Temporal jitter (https://arxiv.org/abs/1901.08810) of seq [N, T, C]:
    each timestep takes its left neighbour's value where its uniform draw
    (``nums`` [N, T, 1], else from ``generator``) is below p / 2, its right
    neighbour's where it is below p, with the edges repeated."""
    if nums is None:
        nums = torch.rand((seq.shape[0], seq.shape[1], 1), generator=generator,
                          device=seq.device)
    right = torch.cat([seq[:, :1], seq[:, :-1]], dim=1)
    left = torch.cat([seq[:, 1:], seq[:, -1:]], dim=1)
    return torch.where(nums < p / 2, right, torch.where(nums < p, left, seq))


@register_model
class VQVAE(DiffusionModel):
    """A waveform VQ-VAE whose decoder is the diffusion model."""

    def __init__(
        self,
        base_channels: int,
        enc_name: str = "unet",
        cond_mult: int = 16,
        dictionary_size: int = 512,
        dead_rate: int = 100,
        **kwargs: Any,
    ):
        kwargs["cond_channels"] = base_channels * cond_mult
        super().__init__(base_channels=base_channels, **kwargs)
        self.enc_name = enc_name
        self.cond_mult = cond_mult
        self.dictionary_size = dictionary_size
        self.dead_rate = dead_rate
        self.encoder = make_encoder(
            enc_name,
            base_channels=base_channels,
            cond_mult=cond_mult,
            dtype=self.compute_dtype,
            remat=self.remat,
        )
        self.vq = Codebook(dictionary_size, self.cond_channels, dead_rate)

    def save_kwargs(self) -> Dict[str, Any]:
        res = super().save_kwargs()
        del res["cond_channels"]  # derived from cond_mult
        res.update(
            enc_name=self.enc_name,
            cond_mult=self.cond_mult,
            dictionary_size=self.dictionary_size,
            dead_rate=self.dead_rate,
        )
        return res

    @property
    def downsample_rate(self) -> int:
        """LCM of the predictor's and the encoder's rates."""
        x, y = self.predictor.downsample_rate, self.encoder.downsample_rate
        return x * y // math.gcd(x, y)

    # -------------------------------------------------------------- compute

    def encode_raw(self, inputs: torch.Tensor) -> torch.Tensor:
        """Encoder output before quantization: [N, T, 1] -> [N, T1, C]."""
        return self.encoder(inputs)

    def losses(
        self,
        inputs: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        vq_loss_cfg: VQLossConfig = VQLossConfig(),
        jitter: float = 0.0,
        no_vq_prob: float = 0.0,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        ts: Optional[torch.Tensor] = None,
        epsilon: Optional[torch.Tensor] = None,
        jitter_nums: Optional[torch.Tensor] = None,
        no_vq_nums: Optional[torch.Tensor] = None,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Training losses of waveforms inputs [N, T, 1]: "vq_loss", "mse",
        per-element "mses" and their "ts", and for the codebook
        maintenance "idxs", "used" and "enc_flat" (the detached encoder
        outputs, [N * T1, C]).

        The random draws, each from ``generator`` unless passed: ``ts``
        [N] and ``epsilon`` (inputs' shape) of the diffusion loss,
        ``jitter_nums`` [N, T1, 1] (see ``jitter_seq``), ``no_vq_nums``
        [N, 1, 1] (a sequence's codes are zeroed where its draw is at most
        ``no_vq_prob``) and, in a training forward, ``dropout_masks`` (see
        ``DiffusionModel.predict_eps``)."""
        dictionary = self.vq.dictionary
        enc_out = self.encode_raw(inputs)
        if jitter:
            enc_out = jitter_seq(enc_out, jitter, jitter_nums, generator)
        vq_out = vq_forward(dictionary, enc_out)
        vq_loss = vq_loss_fn(vq_loss_cfg, enc_out, vq_out["embedded"], dictionary)

        n = inputs.shape[0]
        if ts is None:
            ts = torch.rand((n,), generator=generator, device=inputs.device)
        if epsilon is None:
            epsilon = torch.randn(inputs.shape, generator=generator, dtype=inputs.dtype,
                                  device=inputs.device)
        noised = self.diffusion.sample_q(inputs, ts, epsilon=epsilon)
        cond = vq_out["passthrough"]
        if no_vq_prob:
            if no_vq_nums is None:
                no_vq_nums = torch.rand((n, 1, 1), generator=generator, device=inputs.device)
            cond = cond * (no_vq_nums > no_vq_prob).to(cond.dtype)

        predictions = self.predict_eps(noised, ts, cond=cond, labels=labels, train=train,
                                       generator=generator, dropout_masks=dropout_masks)
        mses = torch.square(predictions - epsilon).reshape(n, -1).mean(dim=1)
        return {
            "vq_loss": vq_loss,
            "mse": mses.mean(),
            "ts": ts,
            "mses": mses,
            "idxs": vq_out["idxs"],
            "used": vq_out["used"],
            "enc_flat": enc_out.detach().reshape(-1, enc_out.shape[-1]),
        }

    def loss_draws(self, inputs: torch.Tensor, generator: Optional[torch.Generator],
                   train: bool = False, jitter: float = 0.0,
                   no_vq_prob: float = 0.0) -> Dict[str, Any]:
        """Every random draw of ``losses(inputs, ...)`` with these settings,
        in the order and shapes it draws them: ``jitter_nums``, ``ts``,
        ``epsilon``, ``no_vq_nums``, then the dropout masks."""
        n, t = inputs.shape[:2]
        dev = inputs.device
        draws: Dict[str, Any] = {}
        if jitter:
            t1 = t // self.encoder.downsample_rate
            draws["jitter_nums"] = torch.rand((n, t1, 1), generator=generator, device=dev)
        draws["ts"] = torch.rand((n,), generator=generator, device=dev)
        draws["epsilon"] = torch.randn(inputs.shape, generator=generator, dtype=inputs.dtype,
                                       device=dev)
        if no_vq_prob:
            draws["no_vq_nums"] = torch.rand((n, 1, 1), generator=generator, device=dev)
        masks = self.dropout_draws(n, t, generator, dev, train)
        if masks is not None:
            draws["dropout_masks"] = masks
        return draws

    def encode(self, inputs: torch.Tensor) -> torch.Tensor:
        """Waveform [N, T, 1] -> integer codes [N, T1]."""
        with span("vvs.encode"):
            return vq_forward(self.vq.dictionary, self.encode_raw(inputs))["idxs"]

    def embed_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """[N, T1] int codes -> [N, T1, C] codebook embeddings."""
        return self.vq.dictionary[codes]

    def _cond_seq(self, codes: torch.Tensor) -> torch.Tensor:
        """[N, T1] int codes -> their embeddings; [N, T1, C] passes as is."""
        if codes.ndim == 2:
            return self.embed_codes(codes)
        if codes.ndim == 3:
            return codes
        raise ValueError(f"unsupported codes shape: {tuple(codes.shape)}")

    def _x_T(self, cond_seq: torch.Tensor, x_T: Optional[torch.Tensor],
             generator: Optional[torch.Generator]) -> torch.Tensor:
        if x_T is not None:
            return x_T
        x_len = cond_seq.shape[1] * self.encoder.downsample_rate
        return torch.randn(
            (cond_seq.shape[0], x_len, 1), generator=generator,
            dtype=torch.float32, device=cond_seq.device,
        )

    def _sample(self, x_T: torch.Tensor, pred_fn: PredictorFn, steps: int, sampler: str,
                eta: float, constrain: bool, generator: Optional[torch.Generator],
                warp: Optional[TimeWarp] = None,
                cond_fn: Optional[CondFn] = None) -> torch.Tensor:
        kw = dict(constrain=constrain, warp=warp, cond_fn=cond_fn)
        if sampler == "ddim":
            return self.diffusion.ddim_sample(x_T, pred_fn, steps, generator=generator,
                                              eta=eta, **kw)
        if sampler == "dpmpp":
            return self.diffusion.dpmpp_sample(x_T, pred_fn, steps, **kw)
        if sampler != "ddpm":
            raise ValueError(f"unknown sampler {sampler!r}")
        return self.diffusion.ddpm_sample(x_T, pred_fn, steps, generator=generator, **kw)

    def decode(
        self,
        codes: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        steps: int = 100,
        constrain: bool = False,
        sampler: str = "ddpm",
        eta: float = 0.0,
        x_T: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        enc_pred=None,
        enc_pred_scale: float = 1.0,
    ) -> torch.Tensor:
        """Sample audio [N, T, 1] for codes ([N, T1] ints, or [N, T1, C]
        embeddings as --no-vq passes them) and labels. ``x_T`` is the
        starting noise; when omitted it is drawn from ``generator``, as is
        every later draw of the DDPM (and DDIM eta > 0) sampler.

        ``enc_pred`` (an ``EncoderPredictorModel``) guides the sampler
        towards audio whose predicted codes are the nearest codes of the
        conditioning sequence: cond_fn = -enc_pred_scale * the gradient of
        its summed cross-entropy with respect to x."""
        cond_seq = self._cond_seq(codes)
        x_T = self._x_T(cond_seq, x_T, generator)
        cond_fn = None
        if enc_pred is not None:
            targets = vq_forward(self.vq.dictionary, cond_seq)["idxs"]
            cond_fn = enc_pred.cond_fn(targets, enc_pred_scale)

        def pred_fn(xs, ts):
            return self.predict_eps(xs, ts, cond=cond_seq, labels=labels)

        return self._sample(x_T, pred_fn, steps, sampler, eta, constrain, generator,
                            cond_fn=cond_fn)

    def decode_uncond_guidance(
        self,
        codes: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        steps: int = 100,
        constrain: bool = False,
        label_scale: float = 0.0,
        vq_scale: float = 0.0,
        sampler: str = "ddpm",
        eta: float = 0.0,
        x_T: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        warp: Optional[TimeWarp] = None,
    ) -> torch.Tensor:
        """Classifier-free guidance for models fine-tuned with an
        unconditional label (0) and zeroed codes: one predictor call on a
        k-stacked batch (the conditional prediction, then one without the
        codes when ``vq_scale``, then one without the label when
        ``label_scale``), combined as base + scale * (base - other) for
        each. ``labels`` are raw; the stack offsets them by 1."""
        cond_seq = self._cond_seq(codes)
        n = cond_seq.shape[0]
        x_T = self._x_T(cond_seq, x_T, generator)

        cond_batches = [cond_seq]
        label_batches = [labels + 1] if labels is not None else None
        if vq_scale:
            cond_batches.append(torch.zeros_like(cond_seq))
            if label_batches is not None:
                label_batches.append(labels + 1)
        if labels is not None and label_scale:
            cond_batches.append(cond_seq)
            label_batches.append(torch.zeros_like(labels))
        k = len(cond_batches)
        cond_all = torch.cat(cond_batches, dim=0)
        labels_all = torch.cat(label_batches, dim=0) if label_batches is not None else None
        scales = [s for s in (vq_scale, label_scale if labels is not None else 0.0) if s]

        def pred_fn(xs, ts):
            outs = self.predict_eps(torch.cat([xs] * k, dim=0), torch.cat([ts] * k, dim=0),
                                    cond=cond_all, labels=labels_all)
            base = pred = outs[:n]
            for i, scale in enumerate(scales, 1):
                pred = pred + scale * (base - outs[i * n:(i + 1) * n])
            return pred

        return self._sample(x_T, pred_fn, steps, sampler, eta, constrain, generator, warp)
