"""K1 (the streaming word-attention kernel) under other plans than its own.

Times ``word_attention_stream_kernel`` at the serving path's two shapes
(batch 64, bf16, C = 32 over 5 words; 64^2 and 128^2 pixels) with the plan
``ops/cuda_attention.py::plan`` picks and with variants of it (ring stages,
pixels a tile, persistent blocks, and a block per tile), beside two
yardsticks on the same bytes: the bytes bound at 3.35 TB/s and PyTorch's
own copy kernels moving them (the images copied into a tensor of ctx's
size, the attention maps filled). Device time of one call: the median of
20 between CUDA events, the L2 cache flushed before each call and the
stream held by a sleep kernel while they are enqueued (as chip_smoke.py's
``time_ms``). Prints one JSON line per shape and variant. With
``--clocks`` it builds csrc/word_attention.cu with ``-DK1_PHASE_CLOCKS``
instead and prints, per shape, the cycles thread 0 of a block spends in
each phase of its units under the wrapper's plan (the probes add a little
time; the shares are what to read). Run on the GPU from the repository's
root:

    python -m attngan_torch.tools.attention_plans [--clocks]
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

import torch

from attngan_torch.ops import _build
from attngan_torch.ops.cuda_attention import _lib, plan

BATCH, WORDS, CHANNELS = 64, 5, 32
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
# csrc/word_attention.cu's K1_MARK slots
PHASES = ["words", "wait", "tail_copy", "own_pixels", "barrier", "issue",
          "attn_rows"]


def build_probe() -> ctypes.CDLL:
    """csrc/word_attention.cu built with -DK1_PHASE_CLOCKS, bound as the
    wrapper binds the real one."""
    out = os.path.join(_build.BUILD_DIR, "word_attention_clocks.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           "-DK1_PHASE_CLOCKS", "-o", out,
                           os.path.join(_build.CSRC, "word_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    lib.word_attention.argtypes = _lib().word_attention.argtypes
    lib.word_attention.restype = ctypes.c_int
    lib.k1_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.k1_phase_cycles.restype = ctypes.c_int
    return lib


def device_ms(fn, iters: int = 20) -> float:
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(10 ** 8)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main(clocks: bool) -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator("cuda").manual_seed(0)
    lib = build_probe() if clocks else _lib()
    stream = torch.cuda.current_stream().cuda_stream
    for hw in (64, 128):
        p = hw * hw
        images = torch.randn((BATCH, hw, hw, CHANNELS), generator=gen,
                             device="cuda").bfloat16()
        words = torch.randn((BATCH, WORDS, CHANNELS), generator=gen,
                            device="cuda").bfloat16()
        mask = torch.ones((BATCH, WORDS), dtype=torch.int32, device="cuda")
        ctx = torch.empty_like(images)
        attn = torch.empty((BATCH, WORDS, hw, hw), device="cuda")
        moved = 2 * images.numel() * 2 + attn.numel() * 4
        base = plan(BATCH, p, CHANNELS, WORDS, 2, sms)
        variants = {"plan": (base.pt, base.stages, base.grid)}
        for stages in sorted({2, 3, 4} - {base.stages}):
            variants[f"stages{stages}"] = (base.pt, stages, base.grid)
        for pt, blocks in ((128, 2), (512, 1)):   # 512: one block fits an SM
            tiles = BATCH * -(-p // pt)
            variants[f"pt{pt}"] = (pt, base.stages, min(tiles, blocks * sms))
        variants["grid1x"] = (base.pt, base.stages, min(base.units, sms))
        variants["block_per_tile"] = (base.pt, base.stages, base.units)

        def launch(pt, stages, grid):
            status = lib.word_attention(
                1, images.data_ptr(), words.data_ptr(), mask.data_ptr(),
                ctx.data_ptr(), attn.data_ptr(), BATCH, p, CHANNELS, WORDS,
                pt, base.g, stages, grid, 1.0 / math.sqrt(CHANNELS), stream)
            _build.check(status, "word_attention")

        def copies():
            ctx.copy_(images)
            attn.fill_(0.0)

        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        if clocks:
            counts = (ctypes.c_ulonglong * 8)()
            launch(*variants["plan"])                         # warm
            torch.cuda.synchronize()
            _build.check(lib.k1_phase_cycles(counts), "k1_phase_cycles")
            launch(*variants["plan"])
            torch.cuda.synchronize()
            _build.check(lib.k1_phase_cycles(counts), "k1_phase_cycles")
            per_block = {n: counts[i] / base.grid
                         for i, n in enumerate(PHASES)}
            total = sum(per_block.values())
            print(json.dumps({
                "shape": f"{hw}x{hw}", "grid": base.grid,
                "units_per_block": base.units / base.grid,
                "cycles_per_block": total,
                "phases": {n: [c, c / total] for n, c in per_block.items()},
                "card": card}), flush=True)
            continue
        copy_ms = device_ms(copies)
        for name, args in variants.items():
            ms = device_ms(lambda: launch(*args))
            print(json.dumps({
                "shape": f"{hw}x{hw}", "variant": name, "pt": args[0],
                "stages": args[1], "grid": args[2], "ms": ms,
                "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                "copy_ms": copy_ms, "card": card}), flush=True)


if __name__ == "__main__":
    main("--clocks" in sys.argv[1:])
