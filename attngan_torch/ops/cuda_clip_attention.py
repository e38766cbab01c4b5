"""K11: the attention of CLIP's residual blocks at short sequences, as a
CUDA kernel for Hopper.

``softmax(q k^T / sqrt(64)) v`` per head, over the packed in_proj output
of nn.MultiheadAttention: qkv (B, L, 3W) with W = heads * 64 and q | k | v
side by side in each row; the output (B, L, W) is the layout out_proj
reads. ``causal`` masks the keys after each query (CLIP's text
transformer); the ViT blocks of GALIP's bridge run unmasked. The kernel is
csrc/clip_attention.cu; it replaces no TPU kernel (the JAX package has no
GALIP). Heads of 64 and 1 <= L <= 80: the text's 77 tokens, the bridge's
50 and 51. Scores, softmax and the weighted sum in fp32, one rounding of
the output to qkv's type. ``clip_attention`` below is its plain version,
which the wrapper runs for a CPU tensor and nowhere else. Forward only:
the port serves GALIP and does not train it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from attngan_torch.ops import _build

HEAD_DIM = 64
MAX_LEN = 80


def clip_attention(qkv: torch.Tensor, heads: int,
                   causal: bool = False) -> torch.Tensor:
    """Plain version of the kernel: each head's scores and softmax in
    fp32 on q, k and v as stored, the weighted sum in fp32, one rounding
    to qkv's type."""
    b, n, _ = qkv.shape
    q, k, v = (t.float().reshape(b, n, heads, HEAD_DIM).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    scores = q @ k.transpose(-1, -2) / math.sqrt(HEAD_DIM)
    if causal:
        above = torch.ones(n, n, dtype=torch.bool,
                           device=qkv.device).triu(1)
        scores = scores.masked_fill(above, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v
    return out.transpose(1, 2).reshape(b, n, heads * HEAD_DIM).to(qkv.dtype)


def check_inputs(qkv: torch.Tensor, heads: int) -> None:
    """Raise on anything csrc/clip_attention.cu does not take."""
    if qkv.dim() != 3 or qkv.shape[2] != 3 * heads * HEAD_DIM:
        raise ValueError(f"clip_attention_cuda: qkv must be (B, L, 3 x "
                         f"{heads} x {HEAD_DIM}); got {tuple(qkv.shape)}")
    if qkv.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"clip_attention_cuda takes fp32 or bf16; got "
                        f"{qkv.dtype}")
    b, n = qkv.shape[:2]
    if not 1 <= n <= MAX_LEN or b < 1:
        raise ValueError(f"clip_attention_cuda: L={n} must be in 1.."
                         f"{MAX_LEN}, B={b} at least 1")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("clip_attention_cuda: qkv must be contiguous, "
                         "16-byte aligned")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("clip_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.clip_attention.argtypes = [i, p, p, i, i, i, i, ctypes.c_float, p]
    lib.clip_attention.restype = i
    return lib


def clip_attention_cuda(qkv: torch.Tensor, heads: int,
                        causal: bool = False) -> torch.Tensor:
    """Every head's attention -> (B, L, heads * 64) in qkv's type.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version."""
    if qkv.device.type == "cpu":
        return clip_attention(qkv, heads, causal)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    check_inputs(qkv, heads)
    b, n, _ = qkv.shape
    out = torch.empty((b, n, heads * HEAD_DIM), dtype=qkv.dtype,
                      device=qkv.device)
    status = _lib().clip_attention(
        _build.DTYPE_CODES[qkv.dtype], qkv.data_ptr(), out.data_ptr(), b, n,
        heads, int(causal), 1.0 / math.sqrt(HEAD_DIM),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(status, "clip_attention")
    clip_attention_cuda.launches += 1
    return out


clip_attention_cuda.launches = 0   # kernel launches, for tests and smoke runs
