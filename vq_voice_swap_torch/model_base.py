"""Self-describing models: a registry of model classes, save/load through the
JAX package's ``.npz`` format (``ModelBase.load`` builds whatever class the
manifest names), and the serving overrides ``dtype``, ``fuse_levels`` and
``act_int8_min_t``.
``load`` also takes a released reference ``.pt`` checkpoint, converted on
the fly (``convert/torch_import.py``), as the JAX package's does, and a
``--checkpoint-format dcp`` run's ``model.dcp`` or ``model_ema_<rate>.dcp``
directory (``checkpoint.load_dcp_checkpoint``, with the ``.new`` fallback),
as the JAX package's reads an Orbax directory.

In the JAX package a model is a config object and its variables travel
separately; here a model is an ``nn.Module`` that owns its weights, so
``load`` returns the model alone.
"""

import importlib
import os
from typing import Any, Dict, Optional, Tuple, Type

from torch import nn

from .checkpoint import load_checkpoint, load_dcp_checkpoint, save_checkpoint
from .convert import params_from_jax, params_to_jax
from .convert.torch_import import looks_like_torch_file, state_dict_from_torch_checkpoint
from .util import resolve_device

__all__ = ["ModelBase", "register_model"]

_REGISTRY: Dict[str, Type["ModelBase"]] = {}


def register_model(cls: Type["ModelBase"]) -> Type["ModelBase"]:
    _REGISTRY[cls.__name__] = cls
    return cls


def _ensure_registered() -> None:
    """Import the modules that register the standard model classes."""
    for mod in (".diffusion_model", ".vq_vae", ".classifier_model"):
        importlib.import_module(mod, package=__package__)


def _load_any_checkpoint(path: str) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
    """(class name, kwargs, state_dict) of an npz checkpoint, a reference
    ``.pt`` or a dcp directory. A real torch file that fails to convert
    shows the conversion error, not the npz reader's."""
    if os.path.isdir(path) or os.path.isdir(path + ".new"):
        return load_dcp_checkpoint(path)
    try:
        class_name, kwargs, flat = load_checkpoint(path)
        return class_name, kwargs, params_from_jax(flat)
    except Exception as npz_err:
        try:
            return state_dict_from_torch_checkpoint(path)
        except Exception as torch_err:
            if looks_like_torch_file(path):
                raise torch_err from npz_err
            raise npz_err from torch_err


class ModelBase(nn.Module):
    """Base for models that save their constructor kwargs beside weights."""

    def save_kwargs(self) -> Dict[str, Any]:
        raise NotImplementedError

    def class_name(self) -> str:
        """The registered class a checkpoint names (FSDP wraps a sharded
        model in a subclass of its own)."""
        return next(c.__name__ for c in type(self).__mro__ if _REGISTRY.get(c.__name__) is c)

    def save(self, path: str, state: Optional[Dict[str, Any]] = None) -> None:
        """Write the model (or ``state``, a state_dict of its, such as a
        snapshot) as a JAX-format ``.npz``."""
        save_checkpoint(
            path, self.class_name(), self.save_kwargs(), params_to_jax(self, state)
        )

    @classmethod
    def from_manifest(cls, class_name: str, kwargs: Dict[str, Any]) -> "ModelBase":
        """A new model of the registered class ``class_name`` (``cls`` or a
        subclass of it) built from a checkpoint's kwargs, on the CPU."""
        _ensure_registered()
        model_cls = _REGISTRY.get(class_name)
        if model_cls is None:
            raise ValueError(f"unknown model class in checkpoint: {class_name}")
        if cls is not ModelBase and not issubclass(model_cls, cls):
            raise ValueError(
                f"checkpoint contains {class_name}, expected {cls.__name__}"
            )
        return model_cls(**kwargs)

    @classmethod
    def load(
        cls, path: str, dtype: Optional[str] = None, device=None,
        fuse_levels: int = 0, frozen: bool = False, act_int8_min_t: Optional[int] = None,
    ) -> "ModelBase":
        """Rebuild the model a checkpoint describes, on ``device`` (CUDA
        unless named). The class comes from the manifest and must be ``cls``
        or a subclass. ``dtype`` overrides the saved compute dtype (params
        stay float32), e.g. "bfloat16" for serving; ``fuse_levels`` > 0
        runs the UNet predictor's first levels through the fused ResBlock
        kernels. Neither is written back by ``save``. ``act_int8_min_t``
        overrides the saved int8 activation storage (levels whose time axis
        is at least that long serve int8; 0 forces it off; None keeps the
        checkpoint's), which ``save`` writes, as the JAX package does.
        ``frozen`` loads the parameters with ``requires_grad`` off."""
        class_name, kwargs, state = _load_any_checkpoint(path)
        if dtype is not None:
            kwargs = {**kwargs, "dtype": dtype}
        if fuse_levels:
            kwargs = {**kwargs, "fuse_levels": fuse_levels}
        if act_int8_min_t is not None:
            kwargs = {**kwargs, "act_int8_min_t": act_int8_min_t}
        device = resolve_device(device)
        model = cls.from_manifest(class_name, kwargs)
        model.load_state_dict(state)
        return model.to(device).eval().requires_grad_(not frozen)
