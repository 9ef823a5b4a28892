"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``. The library
lands in ``_build/`` inside this package (git-ignored), named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. The first
:func:`load` starts one ``nvcc`` for every library not built yet, all at
once, and waits for them. Nothing here runs at import time: the CPU tests
import every module on a host with no ``nvcc``.

Each kernel's wrapper counts its launches in :data:`LAUNCHES` (one count
per kernel name), so a run can show which kernels its path went through.
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

from ..utils.logging import Counter

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel name -> source under csrc/
SOURCES = {
    "attention_fwd": "attention_fwd.cu",
    "attention_bwd": "attention_bwd.cu",
    "sparc_fwd": "sparc_fwd.cu",
    "sparc_bwd": "sparc_bwd.cu",
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd_dq": "flash_bwd_dq.cu",
    "flash_bwd_dkdv": "flash_bwd_dkdv.cu",
    # ops/quant.py's seven entries: one library each, built from one
    # source (a few seconds apiece, in parallel), so each kernel name keeps
    # its own library and launch count. The last four are the split passes
    # of a dimension split over ranks.
    "quant_rows": "quant.cu",
    "quant_cols_t": "quant.cu",
    "dequant": "quant.cu",
    "absmax_rows": "quant.cu",
    "absmax_cols": "quant.cu",
    "quant_rows_given": "quant.cu",
    "quant_cols_t_given": "quant.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# kernel name -> nvcc's output (ptxas register / shared-memory report)
build_logs: Dict[str, str] = {}


# kernel name -> its launches since the last reset
LAUNCHES: Dict[str, Counter] = {name: Counter() for name in SOURCES}


def launch_counts() -> Dict[str, int]:
    return {name: c.value for name, c in LAUNCHES.items()}


def reset_launch_counts() -> None:
    for c in LAUNCHES.values():
        c.reset()


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / SOURCES[name])]


def _build_missing() -> None:
    """Compile every kernel whose library is not built yet, one ``nvcc``
    each, all started together; raises if nvcc is missing or any build
    fails (after every build has ended)."""
    missing = [n for n in SOURCES if not library_path(n).exists()]
    if not missing:
        return
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build the CUDA kernels {missing}: nvcc not found on "
            "PATH, in $CUDA_HOME/bin or in /usr/local/cuda/bin")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(nvcc, name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        build_logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name!r} (exit {proc.returncode}):\n"
                          f"{build_logs[name]}")
        else:
            # atomic: a concurrent loader sees all or nothing
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``; the first call builds every
    library that is not built yet."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if not library_path(name).exists():
                _build_missing()
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
