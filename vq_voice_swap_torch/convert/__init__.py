"""Weight carriers between the JAX package's checkpoints and this port."""

from .from_jax import params_from_jax, params_to_jax, torch_key

__all__ = ["params_from_jax", "params_to_jax", "torch_key"]
