"""PyTorch/CUDA port of the vq-voice-swap system for NVIDIA Hopper GPUs.

The JAX package ``vq_voice_swap_tpu`` is the reference this package is held
against; nothing here imports it (or JAX). Module names mirror the JAX
package so each counterpart is easy to find. Public functions keep the JAX
package's channel-last ``[N, T, C]`` layout; modules run ``[N, C, T]``
internally (torch's ``conv1d`` layout).

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); they never fall back silently.
"""

from .util import resolve_device

__all__ = ["resolve_device"]
