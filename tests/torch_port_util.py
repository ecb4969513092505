"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py)."""

import numpy as np
import torch
from flax import traverse_util

from vq_voice_swap_torch.convert import params_from_jax


def randomize_params(params, seed: int):
    """Replace every leaf of a flax params tree with seeded numpy noise.

    Zero-init layers (ResBlock.conv_out, the MFCC out_conv) and 0.1-scaled
    ones would otherwise cut whole branches off the output and make a
    parity check vacuous."""
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(params, sep="/")
    out = {}
    for path in sorted(flat):
        shape = flat[path].shape
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            arr = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "scale":
            arr = 1.0 + 0.2 * rng.randn(*shape)
        elif leaf == "bias":
            arr = 0.2 * rng.randn(*shape)
        else:  # embeddings, the VQ dictionary
            arr = rng.randn(*shape)
        out[path] = arr.astype(np.float32)
    return traverse_util.unflatten_dict(out, sep="/")


def load_into(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load a flax params tree into the port's counterpart module."""
    flat = traverse_util.flatten_dict(params, sep="/")
    module.load_state_dict(
        params_from_jax({f"params/{k}": np.asarray(v) for k, v in flat.items()})
    )
    return module.eval()


def nct(x) -> torch.Tensor:
    """[N, T, C] array -> contiguous float [N, C, T] tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 2, 1))))


def ntc(y: torch.Tensor) -> np.ndarray:
    return y.detach().transpose(1, 2).numpy()
