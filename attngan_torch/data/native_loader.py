"""ctypes bindings for the native C++ JPEG loader
(attngan_torch/native/jpeg_loader.cpp): port of
attngan_tpu/data/native_loader.py.

The library is built on first use with ``g++ -O3 -shared -fPIC ... -ljpeg
-lpthread`` into ``attngan_torch/native/build/`` (listed in .gitignore),
under a name keyed by a hash of the source, and moved into place whole, so
a concurrent loader never sees half a file. It is a host decoder, not a
device kernel: where g++ or libjpeg is missing the build fails,
``available()`` says so, and decoding falls back to Pillow, as in the JAX
package; files the native decoder rejects (non-JPEG inputs, grayscale or
CMYK exotica) are retried through Pillow one by one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native")
SOURCE = os.path.join(_NATIVE, "jpeg_loader.cpp")
BUILD_DIR = os.path.join(_NATIVE, "build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpthread")


class _Library:
    """The loaded library, built once a process; None where the build or
    the load failed (``error`` says why)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.tried = False
        self.lib: Optional[ctypes.CDLL] = None
        self.error = ""


_LIBRARY = _Library()


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    name = f"libjpeg_loader-{digest.hexdigest()[:16]}.so"
    return os.path.join(BUILD_DIR, name)


def _build(out: str) -> str:
    """Compile the source to ``out``; returns the failure, or ""."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, SOURCE, *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        return f"{cmd[0]}: {e}"
    if proc.returncode != 0:
        return f"g++ exit {proc.returncode}: {proc.stderr.strip()[-500:]}"
    os.replace(tmp, out)
    return ""


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it if needed; None if unavailable."""
    state = _LIBRARY
    with state.lock:
        if state.tried:
            return state.lib
        state.tried = True
        path = library_path()
        if not os.path.exists(path):
            state.error = _build(path)
            if state.error:
                return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            state.error = str(e)
            return None
        lib.ag_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.ag_decode_batch.restype = ctypes.c_int
        state.lib = lib
        return lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> str:
    """Why the library is unavailable ("" when it loaded or was not
    tried)."""
    return _LIBRARY.error


def decode_batch(paths: List[str], res: int = 256
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode and resize files in parallel, a thread per hardware thread.

    Returns (images (N, res, res, 3) uint8, ok (N,) bool). Files the native
    decoder rejects are retried through Pillow; entries that still fail
    have ok=False and zeroed pixels.
    """
    lib = get_lib()
    n = len(paths)
    out = np.zeros((n, res, res, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    if lib is not None and n:
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        lib.ag_decode_batch(
            c_paths, n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), res,
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 0)
    from attngan_torch.data.dataset import decode_image

    for i in range(n):
        if not ok[i]:
            try:
                out[i] = decode_image(paths[i], res)
                ok[i] = 1
            except OSError:
                pass
    return out, ok.astype(bool)
