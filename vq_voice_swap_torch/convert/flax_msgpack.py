"""Read the optimizer state of the JAX package's npz runs (``opt.npz``) into
the port's AdamW.

The JAX package writes ``opt.npz`` as flax msgpack bytes, not as an npz
(``serialization.msgpack_serialize`` of optax's state). This module keeps
its own numpy-only reader of the subset flax writes: maps, arrays, strings,
binaries, integers, floats, booleans and nil, and the msgpack extension
types flax registers (1: an ndarray, itself msgpack of (shape, dtype name,
bytes); 2: a complex; 3: a numpy scalar), with flax's chunked form of
arrays over 1 GiB put back together.

optax's AdamW state holds ``count``, ``mu`` and ``nu`` (``ScaleByAdamState``)
beside empty states (the clip's, the weight decay's) and a schedule's
count, inside ``multi_transform``'s ``inner_states`` when some leaves are
frozen; a frozen leaf's moments are empty (``MaskedNode``) and it has none
in the port either (``train/state.py``).
"""

import struct
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from .from_jax import params_from_jax

__all__ = ["load_optax_adamw", "msgpack_restore"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # strings stay bytes (flax's ndarray payloads)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def number(self, fmt: str) -> Any:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def unpack(self) -> Any:
        b = self.number("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}  # bin
        if b in sized:
            return bytes(self.take(self.number(sized[b])))
        sized = {0xD9: "B", 0xDA: "H", 0xDB: "I"}  # str
        if b in sized:
            return self.string(self.number(sized[b]))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.number(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        sized = {0xC7: "B", 0xC8: "H", 0xC9: "I"}  # ext
        if b in sized:
            return self.ext(self.number(sized[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.number("H" if b == 0xDC else "I"))
        if b in (0xDE, 0xDF):
            return self.map(self.number("H" if b == 0xDE else "I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not used by flax")

    def string(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def array(self, n: int) -> List[Any]:
        return [self.unpack() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.unpack()
            out[key] = self.unpack()
        return out

    def ext(self, n: int) -> Any:
        code = self.number("b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            real, imag = _unpack(payload)
            return complex(real, imag)
        raise ValueError(f"msgpack extension type {code} is not flax's")


def _unpack(data: bytes, raw: bool = False) -> Any:
    reader = _Reader(data, raw)
    obj = reader.unpack()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes after the msgpack object")
    return obj


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _unpack(payload, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        # numpy has no bfloat16: the high half of a float32.
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape, order="C")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """Decode flax msgpack bytes (``serialization.msgpack_serialize``) to
    nested dicts of numpy arrays and Python values, as
    ``flax.serialization.msgpack_restore`` does."""
    return _unchunk(_unpack(bytes(data)))


def _adam_states(tree: Any) -> List[Dict[str, Any]]:
    if not isinstance(tree, dict):
        return []
    if {"count", "mu", "nu"} <= tree.keys():
        return [tree]
    return [s for v in tree.values() for s in _adam_states(v)]


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, path))  # an empty dict: a frozen leaf
        else:
            flat[path] = np.asarray(v)
    return flat


def load_optax_adamw(optimizer, model: nn.Module, data: bytes) -> None:
    """Load the JAX package's optimizer state (``opt.npz`` bytes) into
    ``optimizer`` (a ``train.state.Optimizer`` of ``model``): every
    trainable parameter's moments and the update count."""
    states = _adam_states(msgpack_restore(data))
    if len(states) != 1:
        raise ValueError(f"expected one optax Adam state in the optimizer state, "
                         f"found {len(states)}")
    adam = states[0]
    count = int(adam["count"])
    moments = {}
    for key in ("mu", "nu"):
        flat = {f"params/{k}": v for k, v in _flatten(adam[key]).items()}
        moments[key] = params_from_jax(flat)
    trainable = {id(p) for p in optimizer.params}
    for name, p in model.named_parameters():
        has = name in moments["mu"]
        if id(p) not in trainable:
            if has:
                raise ValueError(f"{name} is frozen in this run but has Adam moments")
            continue
        if not has or name not in moments["nu"]:
            raise ValueError(f"the optimizer state has no Adam moments for {name}")
        mu, nu = moments["mu"][name], moments["nu"][name]
        if mu.shape != p.shape or nu.shape != p.shape:
            raise ValueError(f"{name}: moments {tuple(mu.shape)} for a parameter "
                             f"{tuple(p.shape)}")
        # The step count on the CPU, as the eager AdamW keeps it.
        optimizer.adamw.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu.to(p.device, p.dtype),
            "exp_avg_sq": nu.to(p.device, p.dtype),
        }
    optimizer.count = count
