"""K3: the fused eval-mode UpBlock specialised to Ci=64 -> Co=32.

Replaces attngan_tpu/ops/pallas_upblock_packed.py (``upblock_pallas_packed``),
the TPU kernel that packs column pairs into its 128-wide lanes for exactly
these dims. That packing has no meaning on Hopper; what carries over is the
specialisation: csrc/upblock.cu::upblock_packed_kernel compiles the dims in
(constant trip counts, one parity's weights staged in shared memory at a
time). It computes the same function as K2, so its plain version is
ops/cuda_upblock.py::upblock_fused_eval. Other dims raise ValueError, as the
TPU kernel's wrapper does.
"""

from __future__ import annotations

import torch

from attngan_torch.ops import _build
from attngan_torch.ops.cuda_upblock import (
    check_inputs,
    kernel_args,
    lib,
    upblock_fused_eval,
)

CI, CO = 64, 32


def upblock_fused_eval_packed_cuda(x: torch.Tensor, weight: torch.Tensor,
                                   bn_k: torch.Tensor,
                                   bn_b: torch.Tensor) -> torch.Tensor:
    """glu(bn_k * conv3x3(upsample_2x(x)) + bn_b) at Ci=64, Co=32.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version."""
    b, h, w, ci = x.shape
    co = weight.shape[0] // 2
    if ci != CI or co != CO:
        raise ValueError(f"packed kernel needs Ci={CI}, Co={CO}; got {ci}, {co}")
    if w % 2 or h % 2:
        raise ValueError(f"even spatial dims required; got {h}x{w}")
    if x.device.type == "cpu":
        return upblock_fused_eval(x, weight, bn_k, bn_b)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_inputs("upblock_fused_eval_packed_cuda", x, weight, bn_k, bn_b)
    wp, scale, bias, out = kernel_args(x, weight, bn_k, bn_b)
    status = lib().upblock_fused_eval_packed(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), wp.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "upblock_fused_eval_packed")
    upblock_fused_eval_packed_cuda.launches += 1
    return out


upblock_fused_eval_packed_cuda.launches = 0   # kernel launches
