"""Int8 products of the quantized tiers (infer/quantize.py), and the hook
through which they reach the model's Conv / Dense sites.

The JAX package reaches its sites through flax's method interceptor
(attngan_tpu/infer/quantize.py). The port calls ``F.conv2d`` and the
matmuls on each layer's weight itself, so each such call asks
``intercept(layer, x)`` first: the interceptor in force (a calibration
recorder or a quantizer) returns the site's output, or None for the float
path. No interceptor is in force outside ``intercepting``.

The products are JAX's s8 x s8 -> s32 ``conv_general_dilated`` /
``dot_general`` (``preferred_element_type=int32``): ``torch._int_mm``
(cuBLASLt's IMMA on the card, exact integer arithmetic on the CPU too)
after an im2col of the int8 activations in NHWC. ``F.conv2d`` on int8
tensors would accumulate in int8 and wrap. ``_int_mm`` on CUDA takes
M > 16, K % 8 == 0 and N % 8 == 0: the weights are zero-padded to K and N
once, an im2col to K and a Dense input by 16 zero rows (all exact). An
im2col is built a few images at a time, each piece's product dequantized
into the output, so that a 256^2 tail at batch 64 never holds its whole
(2.4 GB) im2col; an exported program (infer/export.py) takes it in one
piece, since its batch may be symbolic.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# the im2col a piece of the batch may hold, in bytes
IM2COL_BYTES = 256 << 20

_interceptor: Optional[Callable] = None


@contextlib.contextmanager
def intercepting(interceptor: Callable):
    """Make ``interceptor(layer, x) -> Tensor | None`` the one that every
    site asks, for the duration of the block."""
    global _interceptor
    previous, _interceptor = _interceptor, interceptor
    try:
        yield interceptor
    finally:
        _interceptor = previous


def active() -> bool:
    """Whether an interceptor is in force."""
    return _interceptor is not None


def intercept(layer: nn.Module, x: torch.Tensor) -> Optional[torch.Tensor]:
    """The interceptor's output for ``layer``'s site on ``x``, or None:
    the site then runs its float path."""
    return None if _interceptor is None else _interceptor(layer, x)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` on ``x`` in x's type (fp32 where the callers keep it), or
    the interceptor's site: a Linear the model computes in full precision
    itself."""
    y = intercept(layer, x)
    return F.linear(x, layer.weight, layer.bias) if y is None else y


def quantizable(layer: nn.Module) -> bool:
    """JAX's ``_is_quantizable``: every Dense, and plain convs only
    (grouped or dilated ones stay float)."""
    if isinstance(layer, nn.Linear):
        return True
    return (isinstance(layer, nn.Conv2d) and layer.groups == 1
            and tuple(layer.dilation) == (1, 1))


def quantize(x: torch.Tensor, sx: float) -> torch.Tensor:
    """``clip(round(x / sx), -127, 127)`` as int8 (round half to even, as
    ``jnp.round``), from x in fp32."""
    return torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class Int8Site(nn.Module):
    """One Conv2d / Linear site with its weight quantized per output
    channel (``sw = max(max|w|, 1e-12) / 127``, JAX's rule), as the
    (K8, N8) int8 matrix of the product: rows in im2col order (kh, kw, c),
    zero-padded to multiples of 8, in column-major memory. ``forward(x, sx)`` computes JAX's
    quantized site: x quantized at ``sx``, the s32 product, ``y * (sx *
    sw)`` in fp32, the fp32 bias added, cast to x's dtype. Buffers, so that
    ``.to()`` moves them and ``torch.export`` keeps them."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        w = layer.weight.detach().float()
        self.out_features = w.shape[0]
        self.conv = isinstance(layer, nn.Conv2d)
        if self.conv:
            self.kernel_size = tuple(layer.kernel_size)
            self.stride = tuple(layer.stride)
            self.padding = tuple(layer.padding)
        sw = torch.clamp(w.abs().amax(dim=tuple(range(1, w.dim()))),
                         min=1e-12) / 127.0
        q = torch.clamp(torch.round(w / sw.view(-1, *[1] * (w.dim() - 1))),
                        -127, 127).to(torch.int8)
        if self.conv:
            q = q.permute(2, 3, 1, 0).reshape(-1, self.out_features)
        else:
            q = q.t()
        k, n = q.shape
        self.rows = k
        # kept as its (N8, K8) transpose, contiguous: the column-major
        # (K8, N8) operand, the "TN" form cuBLASLt's IMMA takes as it is
        mat = q.new_zeros((_round_up(n, 8), _round_up(k, 8)))
        mat[:n, :k] = q.t()
        self.register_buffer("wmat_t", mat)
        self.register_buffer("sw", sw)
        bias = getattr(layer, "bias", None)
        self.register_buffer("bias", None if bias is None
                             else bias.detach().float())

    @property
    def wmat(self) -> torch.Tensor:
        """The (K8, N8) int8 operand of the product (column-major)."""
        return self.wmat_t.t()

    def int8_weight(self) -> torch.Tensor:
        """The quantized weight in the layer's own layout (OIHW / (N, K))."""
        n = self.out_features
        if not self.conv:
            return self.wmat[:self.rows, :n].t()
        kh, kw = self.kernel_size
        return self.wmat[:self.rows, :n].reshape(
            kh, kw, -1, n).permute(3, 2, 0, 1)

    def _dequantize(self, y: torch.Tensor, sx: float, dtype) -> torch.Tensor:
        out = y.float() * (sx * self.sw)
        if self.bias is not None:
            out = out + self.bias
        return out.to(dtype)

    def forward(self, x: torch.Tensor, sx: float) -> torch.Tensor:
        if not self.conv:
            lead = x.shape[:-1]
            y = self.int_product(quantize(x, sx).reshape(-1, x.shape[-1]))
            return self._dequantize(y, sx, x.dtype).reshape(*lead, -1)
        # x NCHW (channels_last memory) -> NCHW in channels_last memory
        q = quantize(x.permute(0, 2, 3, 1), sx).contiguous()   # NHWC int8
        if torch.compiler.is_exporting():     # one piece: b may be symbolic
            return self._dequantize(self.int_product(q), sx,
                                    x.dtype).permute(0, 3, 1, 2)
        b, h, w = q.shape[:3]
        (kh, kw), (sh, sw_), (ph, pw) = (self.kernel_size, self.stride,
                                         self.padding)
        ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw_ + 1
        out = torch.empty((b, ho, wo, self.out_features), dtype=x.dtype,
                          device=x.device)
        step = max(1, IM2COL_BYTES // max(1, ho * wo * self.wmat.shape[0]))
        for start in range(0, b, step):
            out[start:start + step] = self._dequantize(
                self.int_product(q[start:start + step]), sx, x.dtype)
        return out.permute(0, 3, 1, 2)

    def int_product(self, q: torch.Tensor) -> torch.Tensor:
        """The exact s32 product of int8 activations: a Dense's (M, N)
        from (M, K); a conv's (B, Ho, Wo, N) from NHWC (B, H, W, C)."""
        k8 = self.wmat.shape[0]
        if self.conv:
            (kh, kw), (sh, sw_), (ph, pw) = (self.kernel_size, self.stride,
                                             self.padding)
            if ph or pw:
                q = F.pad(q, (0, 0, pw, pw, ph, ph))
            b, hp, wp, c = q.shape
            ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw_ + 1
            if (kh, kw, sh, sw_) == (1, 1, 1, 1):
                a = q.reshape(-1, c)
            else:
                a = torch.cat([q[:, i:i + sh * (ho - 1) + 1:sh,
                                 j:j + sw_ * (wo - 1) + 1:sw_]
                               for i in range(kh) for j in range(kw)],
                              dim=-1).reshape(b * ho * wo, -1)
        else:
            a = q
        m = a.shape[0]
        # zero columns to K8; a Dense always takes 16 zero rows (M > 16,
        # with no test of a batch that may be symbolic), a conv where small
        a = F.pad(a, (0, k8 - a.shape[1], 0, 16 if not self.conv or m <= 16
                      else 0))
        y = torch._int_mm(a, self.wmat)[:m, : self.out_features]
        return y.view(b, ho, wo, -1) if self.conv else y
