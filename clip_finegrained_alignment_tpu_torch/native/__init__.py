"""ctypes bindings for the native host data plane (``cfa_host.cc``), the
port of ``clip_finegrained_alignment_tpu/native/__init__.py``.

The first call builds ``libcfa_host-<hash>.so`` with ``g++`` into the
package's git-ignored ``_build/`` (named by a hash of the source and the
flags, written to a temporary name and renamed, so concurrent processes
never load half a library) and exposes:

* ``assemble_batch(paths, size, mode=...)``: threaded decode
  (libjpeg/libpng), geometry and PIL-compatible bicubic resize straight
  into one ``[N, S, S, 3]`` uint8 batch, one C call a batch with the GIL
  released (the live pipeline's);
* ``alpha_paste``: the synthetic generator's compositing primitive.

The JAX binding's other primitives (single-image decode and resizes, the
box filter) have no caller in the port and are not bound.

``available()`` gates every call. Where ``g++``, ``-ljpeg`` or ``-lpng``
is missing it is False and callers take the PIL/numpy path, as the JAX
package's callers do. This is host code; no device is involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "cfa_host.cc"
BUILD_DIR = _SRC.parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libcfa_host-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> Optional[str]:
    """Compile the shared library; returns an error string or None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"compiler unavailable: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return proc.stderr[-2000:]
    os.replace(tmp, out)
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        built = not path.exists()
        if built:
            _build_error = _build(path)
            if _build_error:
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            # A library built on another host may not load here: build it
            # again from the source once before giving up.
            _build_error = str(e) if built else _build(path)
            if _build_error:
                return None
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e2:
                _build_error = str(e2)
                return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.cfa_assemble_batch_v3.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, u8p, u8p, ctypes.c_int]
        lib.cfa_assemble_batch_v3.restype = ctypes.c_int
        lib.cfa_alpha_paste.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, u8p, u8p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.cfa_alpha_paste.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


#: Geometry modes of ``assemble_batch`` (those of cfa_host.cc).
MODE_PAD_SQUARE = 1     # white pad to square, then resize
MODE_CENTER_CROP = 2    # shorter-side resize + center crop (HF geometry)

#: cfa_host.cc's PIL-compatible antialiased bicubic resample filter.
FILTER_BICUBIC = 1


def assemble_batch(paths: Sequence[str], size: int,
                   mode: int = MODE_CENTER_CROP,
                   threads: Optional[int] = None) -> Optional[np.ndarray]:
    """Decode, shape and resize N images into one [N, S, S, 3] uint8
    batch; None when the library is unavailable (callers use PIL). The
    resize is PIL's bicubic to ≤ 1 LSB. A sample that fails to decode
    zero-fills its row and is logged with its path."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    failed = np.zeros(n, np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    nt = threads if threads is not None else min(8, os.cpu_count() or 1)
    failures = lib.cfa_assemble_batch_v3(arr, n, size, mode, FILTER_BICUBIC,
                                         _u8ptr(out), _u8ptr(failed), nt)
    if failures:
        bad = [paths[i] for i in np.nonzero(failed)[0]]
        logging.getLogger(__name__).warning(
            "native assembler: %d/%d images failed to decode "
            "(zero-filled): %s", failures, n, bad[:5])
    return out


def alpha_paste(dst: np.ndarray, obj_rgb: np.ndarray,
                obj_alpha: Optional[np.ndarray], x: int, y: int) -> bool:
    """In-place alpha-over paste of ``obj_rgb`` at (x, y), clipped at the
    borders; False → the caller takes the numpy path."""
    lib = _load()
    if lib is None or not dst.flags.c_contiguous or dst.dtype != np.uint8:
        return False
    obj_rgb = np.ascontiguousarray(obj_rgb, np.uint8)
    alpha = None if obj_alpha is None \
        else np.ascontiguousarray(obj_alpha, np.uint8)
    lib.cfa_alpha_paste(_u8ptr(dst), dst.shape[0], dst.shape[1],
                        _u8ptr(obj_rgb),
                        None if alpha is None else _u8ptr(alpha),
                        obj_rgb.shape[0], obj_rgb.shape[1], x, y)
    return True
