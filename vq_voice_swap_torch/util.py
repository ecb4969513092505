"""Device selection and seeded generators shared by the entry points."""

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "step_generator"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for but absent — never a silent CPU
    fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU"
        )
    return dev


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of step (or batch) ``step`` of a run, seeded from
    (seed, step) alone, so a resumed run draws what it would have."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)
