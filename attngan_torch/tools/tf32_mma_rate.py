"""The card's rate of TF32 ``mma.sync.m16n8k8``, the DAMSM backward pass's
product instruction: a yardstick for the pass's phase clocks.

Builds a kernel in which every warp issues 16 independent m16n8k8 TF32
products per loop step (register operands, no memory traffic), launches
it at one and at two blocks of 256 threads per SM, and prints one JSON line
per launch: TFLOP/s and products per second per SM. Run on the GPU from
the repository's root:

    python -m attngan_torch.tools.tf32_mma_rate
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import torch

from attngan_torch.ops import _build

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void mma_loop(float* out, int iters) {
  float c[16][4] = {};
  uint32_t a[4], b[2];
  for (int e = 0; e < 4; ++e)
    a[e] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + e);
  for (int e = 0; e < 2; ++e) b[e] = __float_as_uint(1e-3f * e);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int k = 0; k < 16; ++k)
    for (int e = 0; e < 4; ++e) s += c[k][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(float* out, int blocks, int threads, int iters) {
  mma_loop<<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
THREADS, ITERS, PER_STEP = 256, 4000, 16


def main() -> None:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "tf32_mma_rate.cu")
    lib_path = os.path.join(_build.BUILD_DIR, "tf32_mma_rate.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2 * sms * THREADS, device="cuda")
    for per_sm in (1, 2):
        blocks = per_sm * sms
        _build.check(lib.run(out.data_ptr(), blocks, THREADS, 10), "mma_loop")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        _build.check(lib.run(out.data_ptr(), blocks, THREADS, ITERS),
                     "mma_loop")
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        mmas = blocks * THREADS // 32 * ITERS * PER_STEP
        print(json.dumps({
            "blocks_per_sm": per_sm, "threads": THREADS, "ms": ms,
            "tflop_s": mmas * 2 * 16 * 8 * 8 / ms / 1e9,
            "g_mma_per_s_per_sm": mmas / sms / ms / 1e6,
            "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
