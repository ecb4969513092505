"""Build the package's CUDA C++ sources with ``nvcc`` and load them through
``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, at first
use, into its own ``vq_voice_swap_torch/_build/lib<name>-<hash>.so``; the
file name carries a hash of the source, so an edited source never loads a
stale library. One ``nvcc`` runs per source; ``build_all`` starts one for
every source together. Builds write to a temporary name and rename, so concurrent
processes never load a half-written file.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["build", "build_all", "load_library", "sources", "NVCC_FLAGS"]

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


def sources() -> List[str]:
    """The names of every ``csrc/<name>.cu``, as ``build`` takes them."""
    return sorted(f[:-3] for f in os.listdir(_CSRC_DIR) if f.endswith(".cu"))


def build(name: str) -> Optional[str]:
    """Compile ``csrc/<name>.cu`` unless its current library exists. Returns
    the compiler log (``-Xptxas -v`` register and shared-memory use) when it
    compiled, else None."""
    return build_all([name])[name]


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, Optional[str]]:
    """``build`` for several sources (default: all of ``sources()``) at once:
    one ``nvcc`` process per source whose library is missing, all started
    before any is waited on. Raises after all have ended if any failed,
    with every failed log."""
    names = sources() if names is None else list(names)
    missing = {}
    for name in names:
        src, out = _library_path(name)
        if not os.path.exists(out):
            missing[name] = (src, out)
    logs: Dict[str, Optional[str]] = {name: None for name in names}
    if not missing:
        return logs
    nvcc = _nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    procs = {}
    for name, (src, out) in missing.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"nvcc failed for {name}:\n{logs[name]}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(_library_path(name)[1])
        _LOADED[name] = lib
    return lib
