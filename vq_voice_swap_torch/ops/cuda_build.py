"""Build the package's CUDA C++ sources with ``nvcc`` and load them through
``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, at first
use, into ``vq_voice_swap_torch/_build/lib<name>-<hash>.so``; the file name
carries a hash of the source, so an edited source never loads a stale
library. Builds write to a temporary name and rename, so concurrent
processes never load a half-written file.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional, Tuple

__all__ = ["build", "load_library", "NVCC_FLAGS"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _library_path(name: str) -> Tuple[str, str]:
    src = os.path.join(_CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(_BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> Optional[str]:
    """Compile ``csrc/<name>.cu`` unless its current library exists. Returns
    the compiler log (``-Xptxas -v`` register and shared-memory use) when it
    compiled, else None."""
    src, out = _library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(_library_path(name)[1])
        _LOADED[name] = lib
    return lib
