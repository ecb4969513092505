"""Named sample-time timestep warps (counterpart of
``vq_voice_swap_tpu/diffusion/warp.py``).

A warp remaps the sampler's time grid, e.g. t -> t**2 ("quadratic", the
t = s^2 recipe). Warps are named rather than evaluated from user strings;
each is a torch function applied to float32 times, as the JAX samplers
apply theirs inside the scan.
"""

import re
from typing import Callable, Optional

import torch

__all__ = ["make_warp", "TimeWarp"]

TimeWarp = Callable[[torch.Tensor], torch.Tensor]

_POW_RE = re.compile(r"^pow:([0-9.]+)$")


def make_warp(name: Optional[str]) -> Optional[TimeWarp]:
    """Build a time warp from a name.

    Supported names:
      - None, "", "linear", "identity": no warp (returns None)
      - "quadratic": t -> t**2
      - "sqrt": t -> sqrt(t)
      - "pow:X": t -> t**X for float X
    """
    if name is None or name in ("", "linear", "identity"):
        return None
    if name == "quadratic":
        return torch.square
    if name == "sqrt":
        return torch.sqrt
    m = _POW_RE.match(name)
    if m:
        try:
            p = float(m.group(1))
        except ValueError:
            m = None  # e.g. "pow:1.2.3": fall through to the descriptive error
        if m:
            return lambda t: torch.pow(t, p)
    raise ValueError(
        f"unknown time warp: {name!r} "
        "(use 'linear', 'quadratic', 'sqrt', or 'pow:X')"
    )
