"""K2: the fused eval-mode UpBlock as a CUDA kernel for Hopper.

Replaces attngan_tpu/ops/pallas_upblock.py (``upblock_pallas`` /
``upblock_fused_eval``): glu(bn_k * conv3x3(upsample_nearest_2x(x)) + bn_b)
without writing the upsampled or the pre-GLU tensor. The kernel is
csrc/upblock.cu: bf16 on the tensor cores (Ci % 16 == 0, Co % 8 == 0),
fp32 on the CUDA cores (Co % 4 == 0). In bf16 at the dims of
``RESIDENT_DIMS`` (the serving path's Ci=64 -> Co=32) it is the Hopper form,
``upblock_resident_kernel``: persistent blocks that keep every parity's
weights in shared memory, a cp.async ring of input tiles and wgmma
products; at ``CLUSTER_DIMS`` (DM-GAN's Ci=128 -> Co=64, whose weights
no SM holds) ``upblock_cluster_kernel``: persistent clusters of four CTAs,
each keeping one parity's weights in shared memory, that share each input
tile by TMA multicast; other bf16 dims take the warp-level
``upblock_mma_kernel`` (``form`` names the kernel a launch takes). The JAX
package's lane-packed kernel for the resident form's dims
(attngan_tpu/ops/pallas_upblock_packed.py) needs no kernel of its own
here: its packing fills the TPU's 128 lanes, and the resident form is
Hopper's kernel for those dims.
``upblock_fused_eval`` below is its
plain version (the same parity decomposition, products accumulated in
fp32), which the wrapper runs for a CPU tensor and nowhere else. Forward
only, like the TPU kernel.

Layouts: x (B, H, W, Ci) NHWC, the output (B, 2H, 2W, Co) NHWC; ``weight``
is the UpBlock's conv weight in PyTorch's (2*Co, Ci, 3, 3) layout.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from attngan_torch.ops import _build

# _ROWS[py][a][k] = 1 where row k of the 3x3 kernel falls on padded source
# row i+py+a for output row 2i+py of the upsampled grid: parity 0 takes row
# 0 at a=0 and rows 1+2 at a=1; parity 1 rows 0+1 at a=0 and row 2 at a=1.
# The same table serves the columns.
_ROWS = ((1, 0, 0), (0, 1, 1)), ((1, 1, 0), (0, 0, 1))


@functools.lru_cache(maxsize=None)
def _rows(device: torch.device) -> torch.Tensor:
    # made once per device: a copy from the host waits for the stream, and
    # inside every call it would stall the host in the middle of a forward
    return torch.tensor(_ROWS, dtype=torch.float32, device=device)


def parity_weights(weight: torch.Tensor) -> torch.Tensor:
    """(2Co, Ci, 3, 3) conv weight -> (4 parities, 4 taps * Ci, 2Co) fp32.

    Parity p = 2*py + px, tap t = 2*a + b reads source pixel
    xpad[i+py+a][j+px+b]; the algebra of attngan_tpu/ops/pallas_upblock.py::
    _parity_kernels. Sums are taken in fp32."""
    co2, ci = weight.shape[:2]
    rows = _rows(weight.device)
    wp = torch.einsum("yak,xbl,oikl->yxabio", rows, rows, weight.float())
    return wp.reshape(4, 4 * ci, co2)


# (Ci, Co) at which csrc/upblock.cu instantiates upblock_resident_kernel,
# the serving path's: its wgmma consumers take N = 2*Co = 64, and 4
# parities of 4*Ci x 64 bf16 weights must fit in shared memory beside the
# tile ring
RESIDENT_DIMS = frozenset({(64, 32)})
# (Ci, Co) at which csrc/upblock.cu instantiates upblock_cluster_kernel,
# DM-GAN's refinement stages': CTA rank r of a 4-CTA cluster keeps parity
# r's 4*Ci x 2*Co bf16 weights in shared memory beside the tile ring, and
# its wgmma consumers take N = 2*Co = 128
CLUSTER_DIMS = frozenset({(128, 64)})
# source pixels of one work unit of either kernel (res::kRows, res::kCols)
UNIT_ROWS, UNIT_COLS = 8, 16


def form(dtype: torch.dtype, ci: int, co: int) -> str:
    """The kernel of csrc/upblock.cu that a launch at these dims takes:
    "resident" (``upblock_resident_kernel``) in bf16 at ``RESIDENT_DIMS``,
    "cluster" (``upblock_cluster_kernel``) in bf16 at ``CLUSTER_DIMS``,
    "mma" (``upblock_mma_kernel``) in bf16 elsewhere, "cuda_cores"
    (``upblock_kernel``) in fp32."""
    if dtype != torch.bfloat16:
        return "cuda_cores"
    if (ci, co) in RESIDENT_DIMS:
        return "resident"
    return "cluster" if (ci, co) in CLUSTER_DIMS else "mma"


def resident_weights(wp: torch.Tensor,
                     dtype: torch.dtype | None = None) -> torch.Tensor:
    """Parity weights (4, 4Ci, 2Co) -> the resident and cluster kernels'
    B operand, in ``dtype`` (arranged and cast in one copy) or wp's.

    wgmma's canonical K-major layout without swizzle: 8 x 8 core matrices
    (8 output channels n, each with 8 consecutive K values k, 16 bytes a
    row), ordered [parity][K/8][2Co/8][n][k]."""
    p, k, n = wp.shape
    arranged = wp.reshape(p, k // 8, 8, n // 8, 8).permute(0, 1, 3, 4, 2)
    return torch.empty(arranged.shape, dtype=dtype or wp.dtype,
                       device=wp.device).copy_(arranged)


def resident_units(b: int, h: int, w: int) -> int:
    """Work units of the resident kernel: (image, 8 source rows, 16 source
    columns), the last row and column of units ragged."""
    return b * -(-h // UNIT_ROWS) * -(-w // UNIT_COLS)


def resident_grid(b: int, h: int, w: int, sms: int) -> int:
    """Persistent blocks: one per SM, fewer when there are fewer units.
    Block i takes units i, i + grid, i + 2*grid, ..."""
    return min(sms, resident_units(b, h, w))


def cluster_grid(b: int, h: int, w: int, clusters: int) -> int:
    """Persistent clusters of the cluster kernel: those the card holds at
    once, fewer when there are fewer units. Cluster i takes units i,
    i + grid, ..., and CTA rank r of it parity r of every pixel in them."""
    return min(clusters, resident_units(b, h, w))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _cluster_capacity(device: torch.device, ci: int, co: int) -> int:
    """Clusters of the cluster kernel at (Ci, Co) that the card holds at
    once (asked once, on the first launch, before any graph capture)."""
    with torch.cuda.device(device):
        n = lib().upblock_cluster_capacity(ci, co)
    if n < 1:
        raise RuntimeError(f"upblock_fused_eval (cluster): the card holds no "
                           f"cluster of four at ({ci}, {co}) (status {n})")
    return n


def upblock_fused_eval(x: torch.Tensor, weight: torch.Tensor,
                       bn_k: torch.Tensor, bn_b: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: four 2x2 parity convs in fp32 on the
    inputs as the kernel sees them (parity weights rounded to x's type),
    folded BN and GLU in fp32, one rounding to x's type at the end."""
    b, h, w, ci = x.shape
    co2 = weight.shape[0]
    wp = parity_weights(weight).to(x.dtype).float()
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    y = torch.empty((b, co2, 2 * h, 2 * w), dtype=torch.float32,
                    device=x.device)
    for p in range(4):
        py, px = divmod(p, 2)
        k = wp[p].reshape(2, 2, ci, co2).permute(3, 2, 0, 1)  # (2Co, Ci, a, b)
        y[:, :, py::2, px::2] = F.conv2d(
            xp[:, :, py:py + h + 1, px:px + w + 1], k)
    y = y * bn_k.float().view(1, -1, 1, 1) + bn_b.float().view(1, -1, 1, 1)
    a, g = y.chunk(2, dim=1)
    return (a * torch.sigmoid(g)).to(x.dtype).permute(0, 2, 3, 1).contiguous()


def check_inputs(name: str, x: torch.Tensor, weight: torch.Tensor,
                 bn_k: torch.Tensor, bn_b: torch.Tensor) -> None:
    """Raise on anything the kernels of csrc/upblock.cu do not take."""
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"{name}: x must be (B,H,W,Ci) and weight "
                         f"(2Co,Ci,3,3); got {tuple(x.shape)}, "
                         f"{tuple(weight.shape)}")
    ci = x.shape[3]
    co2 = weight.shape[0]
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name} takes fp32 or bf16; got {x.dtype}")
    if weight.shape[1] != ci:
        raise ValueError(f"{name}: weight {tuple(weight.shape)} does not fit "
                         f"Ci={ci}")
    # fp32 (CUDA cores): Co % 4; bf16 (16x16x16 mma tiles): Ci % 16, Co % 8
    if co2 % 8 or (x.dtype == torch.bfloat16 and (ci % 16 or co2 % 16)):
        raise ValueError(f"{name}: Ci={ci}, Co={co2 // 2} do not fit the "
                         f"kernel (Co a multiple of 4; in bf16 Ci a multiple "
                         f"of 16 and Co of 8)")
    if bn_k.shape != (co2,) or bn_b.shape != (co2,):
        raise ValueError(f"{name}: BN constants must be ({co2},)")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous NHWC, 16-byte aligned")
    for t in (weight, bn_k, bn_b):
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on {x.device}")


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """csrc/upblock.cu, built and bound (its entry points)."""
    so = _build.load("upblock")
    p, i = ctypes.c_void_p, ctypes.c_int
    so.upblock_fused_eval.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p]
    so.upblock_fused_eval.restype = i
    so.upblock_fused_eval_resident.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                               i, p]
    so.upblock_fused_eval_resident.restype = i
    so.upblock_fused_eval_cluster.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                              i, p]
    so.upblock_fused_eval_cluster.restype = i
    so.upblock_cluster_capacity.argtypes = [i, i]
    so.upblock_cluster_capacity.restype = i
    return so


def kernel_args(x: torch.Tensor, weight: torch.Tensor, bn_k: torch.Tensor,
                bn_b: torch.Tensor):
    """(scale, bias, output) as every kernel takes them."""
    b, h, w, _ = x.shape
    scale = bn_k.to(torch.float32).contiguous()
    bias = bn_b.to(torch.float32).contiguous()
    out = torch.empty((b, 2 * h, 2 * w, weight.shape[0] // 2), dtype=x.dtype,
                      device=x.device)
    return scale, bias, out


def upblock_fused_eval_cuda(x: torch.Tensor, weight: torch.Tensor,
                            bn_k: torch.Tensor,
                            bn_b: torch.Tensor) -> torch.Tensor:
    """glu(bn_k * conv3x3(upsample_2x(x)) + bn_b) -> (B, 2H, 2W, Co).

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version."""
    if x.device.type == "cpu":
        return upblock_fused_eval(x, weight, bn_k, bn_b)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_inputs("upblock_fused_eval_cuda", x, weight, bn_k, bn_b)
    b, h, w, ci = x.shape
    co = weight.shape[0] // 2
    scale, bias, out = kernel_args(x, weight, bn_k, bn_b)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kind = form(x.dtype, ci, co)
    if kind == "cluster":
        wr = resident_weights(parity_weights(weight), x.dtype)
        status = lib().upblock_fused_eval_cluster(
            x.data_ptr(), wr.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, w, ci, co,
            cluster_grid(b, h, w, _cluster_capacity(x.device, ci, co)),
            stream)
        _build.check(status, "upblock_fused_eval (cluster)")
    else:
        wp = parity_weights(weight).to(x.dtype).contiguous()
        if kind == "resident":
            status = lib().upblock_fused_eval_resident(
                x.data_ptr(), resident_weights(wp).data_ptr(),
                scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w,
                ci, co, resident_grid(b, h, w, _sm_count(x.device)), stream)
            _build.check(status, "upblock_fused_eval (resident)")
        else:
            status = lib().upblock_fused_eval(
                _build.DTYPE_CODES[x.dtype], x.data_ptr(), wp.data_ptr(),
                scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w,
                ci, co, stream)
            _build.check(status, "upblock_fused_eval")
    upblock_fused_eval_cuda.resident_launches += kind == "resident"
    upblock_fused_eval_cuda.cluster_launches += kind == "cluster"
    upblock_fused_eval_cuda.launches += 1
    return out


upblock_fused_eval_cuda.launches = 0            # kernel launches, any form
upblock_fused_eval_cuda.resident_launches = 0   # of which the resident form
upblock_fused_eval_cuda.cluster_launches = 0    # of which the cluster form
