"""Build the package's native sources and load them through ``ctypes``:
the CUDA C++ kernels (``csrc/<name>.cu``, with ``nvcc``) and the host C
code of the data loader (``csrc/<name>.c``, with the host C compiler).

Each source exposes a plain C interface and compiles, at first use, into
its own ``vq_voice_swap_torch/_build/lib<name>-<hash>.so``; the file name
carries a hash of the source and the compiler flags, so an edited source
never loads a stale library. One compiler runs per source; ``build_all``
starts one for every source together. Builds write to a temporary name and
rename, so concurrent processes and threads never load a half-written
file. A failed build raises with the compiler's name and log.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["build", "build_all", "load_library", "sources", "CC_FLAGS", "NVCC_FLAGS"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CC_FLAGS = ("-O3", "-shared", "-fPIC")
_SUFFIXES = (".cu", ".c")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _cc() -> str:
    cc = os.environ.get("CC") or "cc"
    found = shutil.which(cc)
    if found is None:
        raise RuntimeError(f"the host C compiler {cc!r} was not found: set CC or put cc "
                           "on PATH")
    return found


def _source(name: str) -> str:
    for suffix in _SUFFIXES:
        src = os.path.join(_CSRC_DIR, name + suffix)
        if os.path.exists(src):
            return src
    raise FileNotFoundError(f"no source csrc/{name}.cu or csrc/{name}.c")


def _flags(src: str) -> Tuple[str, ...]:
    return NVCC_FLAGS if src.endswith(".cu") else CC_FLAGS


def _library_path(name: str) -> Tuple[str, str]:
    src = _source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(src)).encode())
    return src, os.path.join(_BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def sources() -> List[str]:
    """The names of every ``csrc/<name>.cu`` and ``csrc/<name>.c``, as
    ``build`` takes them."""
    return sorted(os.path.splitext(f)[0] for f in os.listdir(_CSRC_DIR)
                  if f.endswith(_SUFFIXES))


def build(name: str) -> Optional[str]:
    """Compile ``csrc/<name>.cu`` or ``.c`` unless its current library
    exists. Returns the compiler log (for CUDA, ``-Xptxas -v`` register and
    shared-memory use) when it compiled, else None."""
    return build_all([name])[name]


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, Optional[str]]:
    """``build`` for several sources (default: all of ``sources()``) at once:
    one compiler process per source whose library is missing, all started
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
    os.makedirs(_BUILD_DIR, exist_ok=True)
    procs = {}
    for name, (src, out) in missing.items():
        compiler = _nvcc() if src.endswith(".cu") else _cc()
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs[name] = (subprocess.Popen(
            [compiler, *_flags(src), "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), os.path.basename(compiler), tmp, out)
    failed = []
    for name, (proc, compiler, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{compiler} failed for {name}:\n{logs[name]}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.c``, building it if
    needed."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOAD_LOCK:  # one build and one load, whichever thread comes first
            lib = _LOADED.get(name)
            if lib is None:
                build(name)
                lib = ctypes.CDLL(_library_path(name)[1])
                _LOADED[name] = lib
    return lib
