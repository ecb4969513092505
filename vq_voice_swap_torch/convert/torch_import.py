"""Import the released reference PyTorch checkpoints onto the port's modules
(counterpart of ``vq_voice_swap_tpu/convert/torch_import.py``).

The released vq-voice-swap checkpoints (unet32, unet64, vqvae-unet-mfcc,
...) are torch ``{"kwargs", "state_dict"}`` dicts. The class is inferred
from the parameter names (``vq.``: VQVAE; ``stem.``: Classifier;
``unet.``: EncoderPredictor; else DiffusionModel) and the kwargs are
translated as the JAX package translates them. The state_dict is mapped one
reference submodule at a time onto the flax paths of the JAX package's
checkpoints (``params/predictor/down_blocks_3/conv_in/conv/kernel``, in
flax layouts), which ``from_jax.params_from_jax`` then maps onto this
port's modules, so a reference file and the npz the JAX package converts
it to load the same weights. Files are read with ``weights_only=True``:
a checkpoint is tensors and plain kwargs, and no pickled code runs.
"""

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import save_checkpoint
from .from_jax import params_from_jax

__all__ = ["convert_state_dict", "convert_torch_checkpoint", "load_torch_checkpoint",
           "looks_like_torch_file"]

# The reference class names -> the registered names of this port's models.
_REGISTRY_NAMES = {"Classifier": "ClassifierModel", "EncoderPredictor": "EncoderPredictorModel"}


class _Mapper:
    """Collects the flax-path leaves of a reference state_dict."""

    def __init__(self, state_dict: Dict[str, np.ndarray]):
        self.src = state_dict
        self.out: Dict[str, np.ndarray] = {}
        self.used = set()

    def get(self, key: str) -> Optional[np.ndarray]:
        if key in self.src:
            self.used.add(key)
            return np.asarray(self.src[key])
        return None

    def _leaves(self, tkey: str, path: str, weight: str, layout=None) -> None:
        w = self.get(f"{tkey}.weight")
        if w is None:
            return
        self.out[f"{path}/{weight}"] = w if layout is None else layout(w)
        b = self.get(f"{tkey}.bias")
        if b is not None:
            self.out[f"{path}/bias"] = b

    def linear(self, tkey: str, path: str) -> None:
        """Linear [out, in] -> Dense kernel [in, out]."""
        self._leaves(tkey, path, "kernel", lambda w: w.T)

    def conv(self, tkey: str, path: str) -> None:
        """Conv1d [out, in, k] -> Conv kernel [k, in, out], in a Conv1d."""
        self._leaves(tkey, f"{path}/conv", "kernel", lambda w: np.transpose(w, (2, 1, 0)))

    def raw_conv(self, tkey: str, path: str) -> None:
        """A conv whose flax module is a bare nn.Conv (no Conv1d wrapper)."""
        self._leaves(tkey, path, "kernel", lambda w: np.transpose(w, (2, 1, 0)))

    def norm(self, tkey: str, path: str) -> None:
        self._leaves(tkey, path, "scale")

    def embed(self, tkey: str, path: str) -> None:
        w = self.get(f"{tkey}.weight")
        if w is not None:
            self.out[f"{path}/embedding"] = w

    def array(self, tkey: str, path: str) -> None:
        v = self.get(tkey)
        if v is not None:
            self.out[path] = v


def _map_resblock(m: _Mapper, t: str, o: str) -> None:
    """Reference unet.py ResBlock (pre_cond, cond_layers, post_cond, skip)."""
    m.norm(f"{t}.pre_cond.0.0", f"{o}/norm_in/norm")
    m.conv(f"{t}.pre_cond.2", f"{o}/conv_in")
    m.norm(f"{t}.pre_cond.3", f"{o}/norm_mid/norm")
    m.linear(f"{t}.cond_layers.1", f"{o}/cond_proj")
    # post_cond's index shifts by one when the reference block has dropout.
    if f"{t}.post_cond.2.weight" in m.src:
        m.conv(f"{t}.post_cond.2", f"{o}/conv_out")
    else:
        m.conv(f"{t}.post_cond.1", f"{o}/conv_out")
    m.conv(f"{t}.skip.1", f"{o}/skip_proj")


def _map_blocks(m: _Mapper, t: str, o: str) -> None:
    i = 0
    while f"{t}.{i}.pre_cond.2.weight" in m.src:
        _map_resblock(m, f"{t}.{i}", f"{o}_{i}")
        i += 1


def _map_unet_predictor(m: _Mapper, t: str, o: str) -> None:
    m.linear(f"{t}time_embed.proj", f"{o}time_embed/proj")
    m.linear(f"{t}time_embed_extra.1", f"{o}time_embed_extra")
    m.embed(f"{t}class_embed", f"{o}class_embed")
    m.conv(f"{t}cond_proj", f"{o}cond_proj")
    m.conv(f"{t}in_conv", f"{o}in_conv")
    for group in ("down_blocks", "middle_blocks", "up_blocks"):
        _map_blocks(m, f"{t}{group}", f"{o}{group}")
    m.norm(f"{t}out.0.0", f"{o}out_norm/norm")
    m.conv(f"{t}out.1", f"{o}out_conv")


def _map_unet_encoder(m: _Mapper, t: str, o: str) -> None:
    m.conv(f"{t}in_conv", f"{o}in_conv")
    _map_blocks(m, f"{t}blocks", f"{o}blocks")
    m.norm(f"{t}out.0.0", f"{o}out_norm/norm")
    m.conv(f"{t}out.1", f"{o}out_conv")


def _map_film(m: _Mapper, t: str, o: str) -> None:
    m.linear(f"{t}.time_emb.proj", f"{o}/time_emb/proj")
    m.embed(f"{t}.label_emb", f"{o}/label_emb")
    m.norm(f"{t}.cond_emb.0.ln", f"{o}/cond_norm")
    m.conv(f"{t}.cond_emb.1", f"{o}/cond_conv")
    m.conv(f"{t}.out_layer.1", f"{o}/out_conv")


def _map_ublock(m: _Mapper, t: str, o: str) -> None:
    m.conv(f"{t}.res_transform.1", f"{o}/res_conv")
    m.norm(f"{t}.block_1.0.ln", f"{o}/norm_1")
    m.conv(f"{t}.block_1.3", f"{o}/conv_1")
    m.conv(f"{t}.block_2.1", f"{o}/conv_2")
    m.norm(f"{t}.block_3.0.ln", f"{o}/norm_3")
    m.conv(f"{t}.block_3.2", f"{o}/conv_3")
    m.conv(f"{t}.block_4.1", f"{o}/conv_4")
    m.conv(f"{t}.block_4.3", f"{o}/conv_5")
    for film in ("film_1", "film_2", "film_3"):
        _map_film(m, f"{t}.{film}", f"{o}/{film}")


def _map_dblock(m: _Mapper, t: str, o: str) -> None:
    m.conv(f"{t}.res_transform.0", f"{o}/res_conv")
    m.norm(f"{t}.block_1.0.ln", f"{o}/norm_in")
    m.conv(f"{t}.block_1.3", f"{o}/conv_1")
    m.conv(f"{t}.block_1.5", f"{o}/conv_2")
    j = 0
    while f"{t}.extra.{j}.0.ln.weight" in m.src:
        m.norm(f"{t}.extra.{j}.0.ln", f"{o}/extra_norm_{j}")
        m.conv(f"{t}.extra.{j}.2", f"{o}/extra_conv_{j}_a")
        m.conv(f"{t}.extra.{j}.4", f"{o}/extra_conv_{j}_b")
        m.conv(f"{t}.extra.{j}.6", f"{o}/extra_conv_{j}_c")
        j += 1


def _map_wavegrad_predictor(m: _Mapper, t: str, o: str) -> None:
    m.conv(f"{t}d_blocks.0", f"{o}d_in_conv")
    for i in range(4):
        _map_dblock(m, f"{t}d_blocks.{i + 1}", f"{o}d_block_{i}")
    m.conv(f"{t}u_conv_1", f"{o}u_in_conv")
    for i in range(5):
        _map_ublock(m, f"{t}u_blocks.{i}", f"{o}u_block_{i}")
    m.norm(f"{t}u_ln.ln", f"{o}out_norm")
    m.conv(f"{t}u_conv_2", f"{o}out_conv")


def _map_wavegrad_encoder(m: _Mapper, t: str, o: str) -> None:
    m.conv(f"{t}d_blocks.0", f"{o}in_conv")
    for i in range(5):
        _map_dblock(m, f"{t}d_blocks.{i + 1}", f"{o}d_block_{i}")


def _map_mfcc_encoder(m: _Mapper, t: str, o: str) -> None:
    m.conv(f"{t}blocks.0.0", f"{o}conv_in")
    m.conv(f"{t}blocks.1.conv", f"{o}res_0")
    m.raw_conv(f"{t}blocks.2.0", f"{o}down_conv")
    m.conv(f"{t}blocks.3.conv", f"{o}res_3_0")
    m.conv(f"{t}blocks.4.conv", f"{o}res_3_1")
    for j in range(4):
        m.conv(f"{t}blocks.{5 + j}.conv", f"{o}res_1_{j}")
    m.conv(f"{t}blocks.9", f"{o}out_conv")


def _map_classifier(m: _Mapper) -> None:
    m.conv("stem.in_conv", "stem/in_conv")
    m.linear("stem.time_embed.proj", "stem/time_embed/proj")
    m.linear("stem.time_embed_extra.1", "stem/time_embed_extra")
    _map_blocks(m, "stem.blocks", "stem/block")
    m.norm("stem.out.0.0", "stem/out_norm/norm")
    m.conv("stem.out.1.qkv_proj", "stem/pool/qkv_proj")
    m.conv("stem.out.1.c_proj", "stem/pool/c_proj")
    m.linear("out.1", "head")


def _encoder_mapper(enc_name: str):
    if enc_name.startswith("unet"):
        return _map_unet_encoder
    if enc_name == "wavegrad":
        return _map_wavegrad_encoder
    if enc_name.startswith("conv-mfcc"):
        return _map_mfcc_encoder
    raise ValueError(f"unknown encoder name: {enc_name}")


def infer_class(state_dict: Dict[str, Any]) -> str:
    """The reference class of a state_dict, from its parameter names."""
    if any(k.startswith("vq.") for k in state_dict):
        return "VQVAE"
    if any(k.startswith("stem.") for k in state_dict):
        return "Classifier"
    if any(k.startswith("unet.") for k in state_dict):
        return "EncoderPredictor"
    return "DiffusionModel"


def convert_state_dict(class_name: str, kwargs: Dict[str, Any],
                       state_dict: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A reference state_dict -> flat flax-path arrays (``params/...``,
    ``buffers/vq/usage_count``) of a reference class."""
    m = _Mapper(state_dict)
    buffers: Dict[str, np.ndarray] = {}
    if class_name in ("DiffusionModel", "VQVAE"):
        pred_name = kwargs.get("pred_name", "unet")
        if pred_name == "unet":
            _map_unet_predictor(m, "predictor.", "predictor/")
        elif pred_name == "wavegrad":
            _map_wavegrad_predictor(m, "predictor.", "predictor/")
        else:
            raise ValueError(f"unknown predictor name: {pred_name}")
        if class_name == "VQVAE":
            _encoder_mapper(kwargs.get("enc_name", "unet"))(m, "encoder.", "encoder/")
            m.array("vq.dictionary", "vq/dictionary")
            usage = m.get("vq.usage_count")
            if usage is not None:
                buffers["vq/usage_count"] = usage.astype(np.int32)
    elif class_name == "Classifier":
        _map_classifier(m)
    elif class_name == "EncoderPredictor":
        _map_unet_predictor(m, "unet.", "unet/")
        m.conv("out", "out_proj")
    else:
        raise ValueError(f"unsupported model class: {class_name}")
    # torchaudio's MFCC module keeps constant buffers (the DCT matrix, the
    # window, the mel filterbank) that ops/mfcc.py computes instead.
    unused = {u for u in set(state_dict) - m.used
              if not u.endswith("num_batches_tracked") and ".mfcc." not in u}
    if unused:
        raise ValueError(f"unconverted torch parameters: {sorted(unused)[:10]}")
    flat = {f"params/{k}": v for k, v in m.out.items()}
    flat.update((f"buffers/{k}", v) for k, v in buffers.items())
    return flat


def _translate_kwargs(class_name: str, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    kwargs = dict(kwargs)
    # The reference may store dropout as a one-element tuple.
    if isinstance(kwargs.get("dropout"), (tuple, list)):
        kwargs["dropout"] = kwargs["dropout"][0]
    if class_name == "VQVAE":
        kwargs.pop("cond_channels", None)  # derived from cond_mult
    if "channel_mult" in kwargs:
        kwargs["channel_mult"] = list(kwargs["channel_mult"])
    return kwargs


def load_torch_checkpoint(path: str) -> Tuple[str, Dict[str, Any], Dict[str, np.ndarray]]:
    """Read and convert a reference ``.pt`` -> (registered class name,
    kwargs, flat flax-path arrays)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or not {"kwargs", "state_dict"} <= ckpt.keys():
        raise ValueError(f"{path} is not a reference checkpoint ({{'kwargs', 'state_dict'}})")
    state_dict = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
                  for k, v in ckpt["state_dict"].items()}
    class_name = infer_class(state_dict)
    flat = convert_state_dict(class_name, ckpt["kwargs"], state_dict)
    kwargs = _translate_kwargs(class_name, ckpt["kwargs"])
    return _REGISTRY_NAMES.get(class_name, class_name), kwargs, flat


def state_dict_from_torch_checkpoint(path: str) -> Tuple[str, Dict[str, Any],
                                                           Dict[str, torch.Tensor]]:
    """(registered class name, kwargs, the port's state_dict) of a
    reference ``.pt``."""
    name, kwargs, flat = load_torch_checkpoint(path)
    return name, kwargs, params_from_jax(flat)


def convert_torch_checkpoint(torch_path: str, out_path: str) -> Tuple[str, Dict[str, Any]]:
    """Write a reference ``.pt`` as the ``.npz`` both packages read;
    returns (class name, kwargs)."""
    name, kwargs, flat = load_torch_checkpoint(torch_path)
    save_checkpoint(out_path, name, kwargs, flat)
    return name, kwargs


def looks_like_torch_file(path: str) -> bool:
    """Whether a file is plausibly a torch checkpoint (a zip archive with a
    pickle inside, or the legacy pickle magic) rather than an npz."""
    import zipfile

    if path.endswith((".pt", ".pth")):
        return True
    try:
        if zipfile.is_zipfile(path):
            with zipfile.ZipFile(path) as z:
                return any(n.endswith("data.pkl") for n in z.namelist())
        with open(path, "rb") as f:
            return f.read(2) == b"\x80\x02"
    except OSError:
        return False
