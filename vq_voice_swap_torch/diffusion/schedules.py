"""Noise schedules alpha(t) for continuous-time diffusion (float32 tensors)."""

import math
from dataclasses import dataclass

import torch

__all__ = ["Schedule", "ExpSchedule", "CosSchedule", "make_schedule"]


class Schedule:
    """alpha(t) for t in [0, 1]; alpha(0) ~ 1 (clean), alpha(1) ~ 0 (noise)."""

    name: str = "abstract"

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclass(frozen=True)
class ExpSchedule(Schedule):
    """alpha(t) = exp(-k * t^2), with alpha(1) = alpha_final."""

    alpha_final: float = 1e-5
    name: str = "exp"

    @property
    def k(self) -> float:
        return -math.log(self.alpha_final)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return torch.exp(-self.k * torch.square(t))


@dataclass(frozen=True)
class CosSchedule(Schedule):
    """alpha(t) = cos(t * pi / 2)^2."""

    name: str = "cos"

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return torch.square(torch.cos(t * (math.pi / 2)))


_SCHEDULES = {"exp": ExpSchedule, "cos": CosSchedule}


def make_schedule(name: str) -> Schedule:
    """Look up a schedule by name ("exp" | "cos")."""
    if name not in _SCHEDULES:
        raise ValueError(
            f"unknown schedule: {name!r} (available: {sorted(_SCHEDULES)})"
        )
    return _SCHEDULES[name]()
