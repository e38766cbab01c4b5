"""Where the DAMSM backward pass spends its cycles, phase by phase.

Builds csrc/damsm_similarity.cu with ``-DDAMSM_PHASE_CLOCKS`` (thread 0 of
each block of ``damsm_bwd_tc_kernel`` adds the ``clock64`` cycles of each
phase to a device counter, after a barrier that ends the phase for every
warp), runs the backward through the usual wrapper at the pretrain step's
full width (L=8, R=289, D=256, fp32), and prints one JSON line per batch:
cycles per block in each phase and their share. The extra barriers make
the pass a little slower than the built-in one; the shares are what to
read. Run on the GPU from the repository's root:

    python -m attngan_torch.tools.damsm_phases [batch ...]   # default 64
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from attngan_torch.ops import _build, cuda_damsm

# the kernel's PHASE slots, in order
PHASES = ["load_tile", "p1_chunk_wait", "p1_scores", "p1_softmax", "p1_v",
          "v_row_sums", "p2_chunk_wait", "p2_scores", "p2_softmax_bwd",
          "p2_d_ctx_store", "p2_d_w", "d_w_store", "cosine_words_bwd", "d_v",
          "p2_d_ctx_mma"]


def build_probe() -> ctypes.CDLL:
    out = os.path.join(_build.BUILD_DIR, "damsm_phases.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           "-DDAMSM_PHASE_CLOCKS", "-o", out,
                           os.path.join(_build.CSRC, "damsm_similarity.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    real = cuda_damsm._lib()
    for name in ("damsm_similarity_fwd", "damsm_similarity_bwd"):
        getattr(lib, name).argtypes = getattr(real, name).argtypes
        getattr(lib, name).restype = getattr(real, name).restype
    lib.damsm_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.damsm_phase_cycles.restype = ctypes.c_int
    return lib


def main(batches) -> None:
    lib = build_probe()
    cuda_damsm._lib = lambda: lib
    counts = (ctypes.c_ulonglong * 16)()
    gen = torch.Generator("cuda").manual_seed(11)
    for b in batches:
        img = torch.randn(b, 289, 256, generator=gen, device="cuda")
        words = torch.randn(b, 8, 256, generator=gen, device="cuda")
        lengths = torch.randint(1, 9, (b,), generator=gen, device="cuda")
        mask = (torch.arange(8, device="cuda")[None] < lengths[:, None]).int()
        g = torch.randn(b, b, generator=gen, device="cuda")
        cuda_damsm.damsm_similarity_bwd_tiled(img, words, mask, g)   # warm
        torch.cuda.synchronize()
        _build.check(lib.damsm_phase_cycles(counts), "damsm_phase_cycles")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        cuda_damsm.damsm_similarity_bwd_tiled(img, words, mask, g)
        end.record()
        torch.cuda.synchronize()
        _build.check(lib.damsm_phase_cycles(counts), "damsm_phase_cycles")
        _, _, splits = cuda_damsm.plan(b, b, 8, 256)
        blocks = splits * b
        per_block = {name: counts[i] / blocks for i, name in enumerate(PHASES)}
        total = sum(per_block.values())
        print(json.dumps({
            "batch": b, "blocks": blocks, "ms_with_probes": start.elapsed_time(end),
            "cycles_per_block": total,
            "phases": {k: [v, v / total] for k, v in per_block.items()}}),
            flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [64])
