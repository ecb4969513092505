"""Continuous-time DDPM: forward noising, epsilon/x0 conversions, and the
DDPM, DDIM and DPM-Solver++(2M) samplers.

Each sampler is a Python loop over steps (the JAX package's ``lax.scan``).
All sampler math is float32 whatever the model's compute dtype. Noise comes
from an explicit ``torch.Generator``; the per-step functions take their
noise as an argument so tests can hand both packages the same draw. Every
sampler takes an optional time ``warp`` (``warp.py``), applied to the
float32 grid times as the JAX samplers apply it, and an optional guidance
``cond_fn(x, ts)``, a gradient with respect to x (``input_grad``): the
DDPM step shifts its posterior mean by sigma^2 * grad, DDIM and DPM++
shift epsilon by -sqrt(1 - abar_t) * grad, as the JAX samplers do. Without
it every sampler computes exactly what it computed before guidance.
Under sequence parallelism (``parallel/sequence.py``) x is a shard of the
time axis: each noise draw is the whole sequence's, sliced
(``draw_normal``), and the x0 constraint's mean is the whole sequence's
(``seq_row_mean``).
"""

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..observe import span
from ..parallel.sequence import draw_normal, seq_row_mean
from .schedules import Schedule
from .warp import TimeWarp

__all__ = ["Diffusion", "broadcast_to_batch", "input_grad"]

PredictorFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
CondFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def input_grad(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The gradient of the scalar fn(x) with respect to x, taken on a
    detached copy of x with grad enabled, so it works inside the samplers'
    ``torch.no_grad()``."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        (grad,) = torch.autograd.grad(fn(xx), xx)
    return grad


def broadcast_to_batch(ts: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape a [N] vector so it broadcasts against [N, ...] data."""
    return ts.reshape(ts.shape + (1,) * (x.ndim - ts.ndim)).to(x.dtype)


def _grid_time(i: int, steps: int, warp: Optional[TimeWarp] = None) -> float:
    """Time at grid index i (i=0 -> 1.0, i=steps -> 0.0), rounded as the
    JAX samplers round it: float32(steps - i) * float32(1 / steps), then
    warped in float32."""
    t = torch.tensor(np.float32(steps - i) * np.float32(1.0 / steps))
    return (t if warp is None else warp(t)).item()


def _step_time(i: int, steps: int, warp: Optional[TimeWarp]) -> Tuple[float, float]:
    """(t, step) of reverse step i of the DDPM and DDIM samplers: without a
    warp the grid time and 1 / steps; with one, warp(t) and the warped step
    warp(t) - warp(t - 1/steps), all in float32."""
    if warp is None:
        return _grid_time(i, steps), 1.0 / steps
    t = torch.tensor(_grid_time(i, steps), dtype=torch.float32)
    dt = float(np.float32(1.0 / steps))
    return warp(t).item(), (warp(t) - warp(t - dt)).item()


def _clamp_x0(x0: torch.Tensor) -> torch.Tensor:
    """Subtract the per-sequence mean over all non-batch axes, then clamp."""
    return torch.clamp(x0 - seq_row_mean(x0), -1.0, 1.0)


@dataclass(frozen=True)
class Diffusion:
    """A continuous-time diffusion process for a given noise schedule."""

    schedule: Schedule

    # ---------------------------------------------------------------- forward

    def sample_q(
        self, x_0: torch.Tensor, ts: torch.Tensor, epsilon: torch.Tensor
    ) -> torch.Tensor:
        """Sample q(x_t | x_0) = sqrt(a) x_0 + sqrt(1-a) eps."""
        alphas = broadcast_to_batch(self.schedule(ts), x_0)
        return torch.sqrt(alphas) * x_0 + torch.sqrt(1.0 - alphas) * epsilon

    def eps_to_x0(
        self, x_t: torch.Tensor, ts: torch.Tensor, eps_pred: torch.Tensor
    ) -> torch.Tensor:
        alphas = broadcast_to_batch(self.schedule(ts), x_t)
        return (x_t - torch.sqrt(1.0 - alphas) * eps_pred) * torch.rsqrt(alphas)

    def x0_to_eps(
        self, x_t: torch.Tensor, ts: torch.Tensor, x_0: torch.Tensor
    ) -> torch.Tensor:
        alphas = broadcast_to_batch(self.schedule(ts), x_t)
        return (x_t - x_0 * torch.sqrt(alphas)) * torch.rsqrt(1.0 - alphas)

    # ---------------------------------------------------------------- reverse

    def ddpm_previous(
        self,
        x_t: torch.Tensor,
        ts: torch.Tensor,
        step: float,
        eps_pred: torch.Tensor,
        noise: torch.Tensor,
        sigma_large: bool = False,
        constrain: bool = False,
        cond_fn: Optional[CondFn] = None,
    ) -> torch.Tensor:
        """One reverse ancestral step x_t -> x_{t-step}. Guidance shifts the
        posterior mean by sigma^2 * cond_fn(mean, t - step) and folds it back
        into an equivalent epsilon; the x0 constraint subtracts the
        per-sequence mean before clamping to [-1, 1]."""
        alphas_t = broadcast_to_batch(self.schedule(ts), x_t)
        alphas_prev = broadcast_to_batch(self.schedule(ts - step), x_t)
        alphas = alphas_t / alphas_prev
        betas = 1.0 - alphas

        if sigma_large:
            sigmas = betas
        else:
            sigmas = betas * (1.0 - alphas_prev) / (1.0 - alphas_t)

        def eps_to_prev(eps: torch.Tensor) -> torch.Tensor:
            return torch.rsqrt(alphas) * (x_t - betas * torch.rsqrt(1.0 - alphas_t) * eps)

        if cond_fn is not None:
            mean_pred = eps_to_prev(eps_pred)
            mean_pred = mean_pred + sigmas * cond_fn(mean_pred, ts - step)
            eps_pred = (-mean_pred * torch.sqrt(alphas) + x_t) * torch.sqrt(
                1.0 - alphas_t
            ) / betas

        if constrain:
            x0 = _clamp_x0(self.eps_to_x0(x_t, ts, eps_pred))
            eps_pred = self.x0_to_eps(x_t, ts, x0)

        return eps_to_prev(eps_pred) + torch.sqrt(sigmas) * noise

    def ddpm_sample(
        self,
        x_T: torch.Tensor,
        predictor: PredictorFn,
        steps: int,
        generator: Optional[torch.Generator] = None,
        sigma_large: bool = False,
        constrain: bool = False,
        warp: Optional[TimeWarp] = None,
        cond_fn: Optional[CondFn] = None,
    ) -> torch.Tensor:
        """Ancestral sampling from x_T in ``steps`` reverse steps; the
        per-step noise is drawn from ``generator`` (none on the last step).
        ``warp`` remaps the times, with the warped step size
        warp(t) - warp(t - 1/steps)."""
        x_t = x_T
        for i in range(steps):
            with span("vvs.step"):
                t, dt = _step_time(i, steps, warp)
                ts = torch.full(
                    (x_T.shape[0],), t, dtype=torch.float32, device=x_T.device
                )
                eps = predictor(x_t, ts)
                if i == steps - 1:
                    noise = torch.zeros_like(x_t)
                else:
                    noise = draw_normal(x_T.shape, generator, x_T.dtype, x_T.device)
                x_t = self.ddpm_previous(
                    x_t, ts, dt, eps, noise, sigma_large=sigma_large,
                    constrain=constrain, cond_fn=cond_fn,
                )
        return x_t

    def ddim_previous(
        self,
        x_t: torch.Tensor,
        ts: torch.Tensor,
        step: float,
        eps_pred: torch.Tensor,
        noise: torch.Tensor,
        eta: float = 0.0,
        constrain: bool = False,
        cond_fn: Optional[CondFn] = None,
    ) -> torch.Tensor:
        """One DDIM reverse step x_t -> x_{t-step}; eta=0 is deterministic.
        Guidance shifts epsilon by -sqrt(1 - abar_t) * cond_fn(x_t, t)."""
        abar_t = broadcast_to_batch(self.schedule(ts), x_t)
        abar_prev = broadcast_to_batch(self.schedule(ts - step), x_t)

        if cond_fn is not None:
            eps_pred = eps_pred - torch.sqrt(1.0 - abar_t) * cond_fn(x_t, ts)

        x0 = self.eps_to_x0(x_t, ts, eps_pred)
        if constrain:
            x0 = _clamp_x0(x0)
        eps_pred = self.x0_to_eps(x_t, ts, x0)

        sigmas = eta * torch.sqrt(
            (1.0 - abar_prev) / (1.0 - abar_t)
        ) * torch.sqrt(1.0 - abar_t / abar_prev)
        dir_xt = torch.sqrt(
            torch.clamp(1.0 - abar_prev - torch.square(sigmas), min=0.0)
        ) * eps_pred
        return torch.sqrt(abar_prev) * x0 + dir_xt + sigmas * noise

    def ddim_sample(
        self,
        x_T: torch.Tensor,
        predictor: PredictorFn,
        steps: int,
        generator: Optional[torch.Generator] = None,
        eta: float = 0.0,
        constrain: bool = False,
        warp: Optional[TimeWarp] = None,
        cond_fn: Optional[CondFn] = None,
    ) -> torch.Tensor:
        """DDIM sampler; deterministic at eta=0. The final step lands on
        t=0, where it returns the predicted x0 exactly. Same warp semantics
        as ``ddpm_sample``."""
        x_t = x_T
        for i in range(steps):
            with span("vvs.step"):
                t, dt = _step_time(i, steps, warp)
                ts = torch.full(
                    (x_T.shape[0],), t, dtype=torch.float32, device=x_T.device
                )
                eps = predictor(x_t, ts)
                if eta and i < steps - 1:
                    noise = draw_normal(x_T.shape, generator, x_T.dtype, x_T.device)
                else:
                    noise = torch.zeros_like(x_t)
                x_t = self.ddim_previous(
                    x_t, ts, dt, eps, noise, eta=eta, constrain=constrain,
                    cond_fn=cond_fn,
                )
        return x_t

    def dpmpp_sample(
        self,
        x_T: torch.Tensor,
        predictor: PredictorFn,
        steps: int,
        constrain: bool = False,
        warp: Optional[TimeWarp] = None,
        cond_fn: Optional[CondFn] = None,
    ) -> torch.Tensor:
        """DPM-Solver++(2M) (Lu et al. 2022) in half-log-SNR space
        lambda = log(alpha / sigma), alpha = sqrt(abar), sigma = sqrt(1-abar):

            x <- (sigma_next / sigma) x - alpha_next (e^{-h} - 1) D,
            D = x0_i + (x0_i - x0_{i-1}) / (2 r),  r = h_{i-1} / h_i,

        first order (D = x0_i) on the first and the final step. e^{-h} is
        the ratio (alpha sigma_next) / (sigma alpha_next), exactly 0 on the
        final step (sigma_next = 0), so the sampler lands on x0 there and
        never forms the infinite lambda_next. Deterministic: it draws no
        noise. ``warp`` maps every grid time t to warp(t). Guidance shifts
        epsilon as ``ddim_previous`` does.
        """
        x = x_T
        x0_prev = lam_prev = None
        for i in range(steps):
            with span("vvs.step"):
                ts = torch.full(
                    (x_T.shape[0],), _grid_time(i, steps, warp),
                    dtype=torch.float32, device=x_T.device,
                )
                ts_next = torch.full_like(ts, _grid_time(i + 1, steps, warp))

                eps = predictor(x, ts)
                abar_t = broadcast_to_batch(self.schedule(ts), x)
                if cond_fn is not None:
                    eps = eps - torch.sqrt(1.0 - abar_t) * cond_fn(x, ts)
                x0 = self.eps_to_x0(x, ts, eps)
                if constrain:
                    x0 = _clamp_x0(x0)

                abar_n = broadcast_to_batch(self.schedule(ts_next), x)
                alpha_t, sigma_t = torch.sqrt(abar_t), torch.sqrt(1.0 - abar_t)
                alpha_n, sigma_n = torch.sqrt(abar_n), torch.sqrt(1.0 - abar_n)
                exp_neg_h = (alpha_t * sigma_n) / (sigma_t * alpha_n)
                lam_cur = 0.5 * (torch.log(abar_t) - torch.log1p(-abar_t))

                if 0 < i < steps - 1:
                    lam_next = 0.5 * (torch.log(abar_n) - torch.log1p(-abar_n))
                    r = (lam_cur - lam_prev) / (lam_next - lam_cur)
                    d = x0 + (x0 - x0_prev) * (0.5 / r)
                else:
                    d = x0
                x = (sigma_n / sigma_t) * x - alpha_n * (exp_neg_h - 1.0) * d
                x0_prev, lam_prev = x0, lam_cur
        return x

    # ---------------------------------------------------------------- losses

    def ddpm_losses(
        self,
        x: torch.Tensor,
        predictor: PredictorFn,
        ts: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Per-batch-element epsilon-MSE; ``ts``/``noise`` are drawn from
        ``generator`` when not given."""
        if ts is None:
            ts = torch.rand(
                (x.shape[0],), generator=generator, dtype=torch.float32,
                device=x.device,
            )
        if noise is None:
            noise = draw_normal(x.shape, generator, x.dtype, x.device)
        samples = self.sample_q(x, ts, epsilon=noise)
        noise_pred = predictor(samples, ts)
        sq = torch.square(noise - noise_pred)
        return sq.reshape(x.shape[0], -1).mean(dim=1)
