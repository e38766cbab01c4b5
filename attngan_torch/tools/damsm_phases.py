"""Where the tensor-core DAMSM kernels spend their cycles, phase by phase.

Builds csrc/damsm_similarity.cu with ``-DDAMSM_PHASE_CLOCKS`` (thread 0 of
each block of ``damsm_bwd_tc_kernel`` and ``damsm_fwd_tc_kernel`` adds the
``clock64`` cycles of each phase to a device counter, after a barrier that
ends the phase for every warp), runs the backward and then the forward
through the usual wrappers at the pretrain step's full width (L=8, R=289,
D=256, fp32), and prints one JSON line per kernel and batch: cycles per
block in each phase and their share. The extra barriers make the kernels a
little slower than the built-in ones; the shares are what to read. Run on
the GPU from the repository's root:

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

# the kernels' PHASE slots, in order (the forward's are its pass 1, the
# backward's slots 0-5, and slot 12: the cosine and Eq. 10)
PHASES = ["load_tile", "p1_chunk_wait", "p1_scores", "p1_softmax", "p1_v",
          "v_row_sums", "p2_chunk_wait", "p2_scores", "p2_softmax_bwd",
          "p2_d_ctx_store", "p2_d_w", "d_w_store", "cosine_words_bwd", "d_v",
          "p2_d_ctx_mma"]
FWD_PHASES = {0: "load_tile", 1: "chunk_wait", 2: "scores", 3: "softmax",
              4: "v", 5: "v_row_sums", 12: "cosine_sims"}


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


def phase_cycles(lib, run, names: dict, blocks: int) -> dict:
    """Cycles per block by phase of one call of ``run`` (after a warm one),
    with the call's time under the probes."""
    counts = (ctypes.c_ulonglong * 16)()
    run()                                                        # warm
    torch.cuda.synchronize()
    _build.check(lib.damsm_phase_cycles(counts), "damsm_phase_cycles")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    _build.check(lib.damsm_phase_cycles(counts), "damsm_phase_cycles")
    per_block = {name: counts[i] / blocks for i, name in names.items()}
    total = sum(per_block.values())
    return {"blocks": blocks, "ms_with_probes": start.elapsed_time(end),
            "cycles_per_block": total,
            "phases": {k: [v, v / total] for k, v in per_block.items()}}


def main(batches) -> None:
    lib = build_probe()
    cuda_damsm._lib = lambda: lib
    gen = torch.Generator("cuda").manual_seed(11)
    for b in batches:
        img = torch.randn(b, 289, 256, generator=gen, device="cuda")
        words = torch.randn(b, 8, 256, generator=gen, device="cuda")
        lengths = torch.randint(1, 9, (b,), generator=gen, device="cuda")
        mask = (torch.arange(8, device="cuda")[None] < lengths[:, None]).int()
        g = torch.randn(b, b, generator=gen, device="cuda")
        _, _, splits = cuda_damsm.plan(b, b, 8, 256)
        _, _, fwd_splits = cuda_damsm.plan(b, b, 8, 256, slack=1.0)
        runs = {
            "backward": (lambda: cuda_damsm.damsm_similarity_bwd_tiled(
                img, words, mask, g), dict(enumerate(PHASES)), splits),
            "forward": (lambda: cuda_damsm.damsm_similarity(img, words, mask),
                        FWD_PHASES, fwd_splits)}
        for kernel, (run, names, s) in runs.items():
            print(json.dumps({"kernel": kernel, "batch": b,
                              **phase_cycles(lib, run, names, s * b)}),
                  flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [64])
