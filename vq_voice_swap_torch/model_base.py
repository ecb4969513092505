"""Self-describing models: a registry of model classes, save/load through the
JAX package's ``.npz`` format (``ModelBase.load`` builds whatever class the
manifest names), and the serving ``dtype`` override.

In the JAX package a model is a config object and its variables travel
separately; here a model is an ``nn.Module`` that owns its weights, so
``load`` returns the model alone.
"""

import importlib
from typing import Any, Dict, Optional, Type

from torch import nn

from .checkpoint import load_checkpoint, save_checkpoint
from .convert import params_from_jax, params_to_jax
from .util import resolve_device

__all__ = ["ModelBase", "register_model"]

_REGISTRY: Dict[str, Type["ModelBase"]] = {}


def register_model(cls: Type["ModelBase"]) -> Type["ModelBase"]:
    _REGISTRY[cls.__name__] = cls
    return cls


def _ensure_registered() -> None:
    """Import the modules that register the standard model classes."""
    for mod in (".diffusion_model", ".vq_vae"):
        importlib.import_module(mod, package=__package__)


class ModelBase(nn.Module):
    """Base for models that save their constructor kwargs beside weights."""

    def save_kwargs(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save(self, path: str) -> None:
        save_checkpoint(
            path, type(self).__name__, self.save_kwargs(), params_to_jax(self)
        )

    @classmethod
    def load(
        cls, path: str, dtype: Optional[str] = None, device=None
    ) -> "ModelBase":
        """Rebuild the model a checkpoint describes, on ``device`` (CUDA
        unless named). The class comes from the manifest and must be ``cls``
        or a subclass. ``dtype`` overrides the saved compute dtype (params
        stay float32), e.g. "bfloat16" for serving."""
        class_name, kwargs, flat = load_checkpoint(path)
        _ensure_registered()
        model_cls = _REGISTRY.get(class_name)
        if model_cls is None:
            raise ValueError(f"unknown model class in checkpoint: {class_name}")
        if cls is not ModelBase and not issubclass(model_cls, cls):
            raise ValueError(
                f"checkpoint contains {class_name}, expected {cls.__name__}"
            )
        if dtype is not None:
            kwargs = {**kwargs, "dtype": dtype}
        device = resolve_device(device)
        model = model_cls(**kwargs)
        model.load_state_dict(params_from_jax(flat))
        return model.to(device).eval()
