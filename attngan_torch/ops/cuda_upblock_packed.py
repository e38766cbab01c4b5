"""K3: the fused eval-mode UpBlock at exactly Ci=64 -> Co=32.

Replaces attngan_tpu/ops/pallas_upblock_packed.py (``upblock_pallas_packed``),
the TPU kernel that packs column pairs into its 128-wide lanes for exactly
these dims. It computes K2's function, and that packing has no meaning on
Hopper: the Hopper kernel made for exactly these dims is K2's resident form
(csrc/upblock.cu::upblock_resident_kernel: persistent blocks, all four
parities' weights resident in shared memory, a cp.async input ring and
wgmma). So K3 launches that kernel in bf16 and the CUDA-core
``upblock_kernel`` in fp32 (``packed_form``), through the same entry points
as K2, and counts its own launches: K2's counters do not move. Its plain
version is ops/cuda_upblock.py::upblock_fused_eval. Other dims and odd
spatial dims raise ValueError, as the TPU kernel's wrapper does.
"""

from __future__ import annotations

import torch

from attngan_torch.ops.cuda_upblock import (
    check_inputs,
    launch,
    upblock_fused_eval,
)

CI, CO = 64, 32   # one of cuda_upblock.RESIDENT_DIMS


def packed_form(dtype: torch.dtype, ci: int, co: int, h: int, w: int) -> str:
    """The kernel K3 launches: "resident" (``upblock_resident_kernel``) in
    bf16, "cuda_cores" (``upblock_kernel``) in any other type, which the
    launch checks. Raises ValueError for dims other than K3's."""
    if ci != CI or co != CO:
        raise ValueError(f"packed kernel needs Ci={CI}, Co={CO}; got {ci}, {co}")
    if w % 2 or h % 2:
        raise ValueError(f"even spatial dims required; got {h}x{w}")
    return "resident" if dtype == torch.bfloat16 else "cuda_cores"


def upblock_fused_eval_packed_cuda(x: torch.Tensor, weight: torch.Tensor,
                                   bn_k: torch.Tensor,
                                   bn_b: torch.Tensor) -> torch.Tensor:
    """glu(bn_k * conv3x3(upsample_2x(x)) + bn_b) at Ci=64, Co=32.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version."""
    b, h, w, ci = x.shape
    form = packed_form(x.dtype, ci, weight.shape[0] // 2, h, w)
    if x.device.type == "cpu":
        return upblock_fused_eval(x, weight, bn_k, bn_b)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_inputs("upblock_fused_eval_packed_cuda", x, weight, bn_k, bn_b)
    out = launch(x, weight, bn_k, bn_b, resident=form == "resident")
    upblock_fused_eval_packed_cuda.resident_launches += form == "resident"
    upblock_fused_eval_packed_cuda.launches += 1
    return out


upblock_fused_eval_packed_cuda.launches = 0            # kernel launches
upblock_fused_eval_packed_cuda.resident_launches = 0   # of which resident
