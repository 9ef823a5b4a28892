"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``. The library
lands in ``_build/`` inside this package (git-ignored), named by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. Nothing here runs at import time: the CPU tests
import every module on a host with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel name -> source under csrc/
SOURCES = {"attention_fwd": "attention_fwd.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# kernel name -> nvcc's output (ptxas register / shared-memory report)
build_logs: Dict[str, str] = {}


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / SOURCES[name])]


def _build(name: str) -> None:
    """Compile ``name`` unless its library is built already; raises if
    nvcc is missing or fails."""
    out = library_path(name)
    if out.exists():
        return
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build the CUDA kernel {name!r}: nvcc not found on PATH, "
            "in $CUDA_HOME/bin or in /usr/local/cuda/bin")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(nvcc, name, tmp),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    build_logs[name] = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name!r} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _build(name)
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
