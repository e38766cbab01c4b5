"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface and loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds. The libraries
go to ``csrc/build/`` (listed in .gitignore) under a name keyed by a hash of
every source and header in ``csrc/`` and of the flags, so an edited source
is rebuilt and a stale library is never loaded. All sources compile at once,
one ``nvcc`` process each.

A missing ``nvcc`` or a failed build raises: the kernels are the GPU path
and nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("word_attention", "upblock", "damsm_similarity", "dfblock",
           "bn_epilogue", "bilstm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# storage types the kernels take, as the C entry points number them
# (csrc/common.cuh::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def vector_values(dtype: torch.dtype) -> int:
    """Values of a 16-byte access: 8 bf16, 4 fp32."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels of "
            "attngan_torch are built at first use and need the CUDA toolkit")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                       + glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_source_hash()}.so")


def build_all() -> dict:
    """Compile every source whose library is missing, all at once.

    Returns {name: (library path, seconds, ptxas report)}; the report is
    empty for a library that was already built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    result = {name: (library_path(name), 0.0, "") for name in SOURCES}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)      # atomic: a concurrent loader never sees
        result[name] = (out, time.perf_counter() - t0, log)   # half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return result


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building every stale source first)."""
    path = library_path(name)
    if not os.path.exists(path):
        build_all()
    return ctypes.CDLL(path)


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
