"""K9: the text encoder's masked bidirectional LSTM recurrence as a CUDA
kernel for Hopper.

From each direction's input projection (x W_ih^T, (B, L, 4H), no bias),
its W_hh (4H, H), its two biases and the lengths (B,) on the device, one
launch runs both directions over all L steps and returns
(words (B, L, 2H), sent (B, 2H)), as ``BiLSTMEncoder.forward`` returns
them: the carry frozen and the output zero at padded steps, the backward
direction from each row's last word, zeros for a row of length 0.

The kernel is csrc/bilstm.cu; it replaces no TPU kernel (the JAX package
scans in XLA), and takes the place of cuDNN's packed RNN on the eval path,
which needs the lengths on the host. ``bilstm`` below is its plain
version, the masked scan that ``torch.export`` traces
(``BiLSTMEncoder.forward_masked``); the wrapper runs it for a CPU tensor
and nowhere else. fp32 only, H = 128 only, forward only: training keeps
``nn.LSTM`` (models/rnn_encoder.py routes it there).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from attngan_torch.ops import _build

HIDDEN = 128        # units a direction that the kernel is built for

Pair = Tuple[torch.Tensor, torch.Tensor]     # (forward, backward)


def bilstm(gates: Pair, lengths: torch.Tensor, w_hh: Pair, b_ih: Pair,
           b_hh: Pair) -> Pair:
    """Plain version of the kernel: a scan over the fixed L with no host
    lengths and no branch on data, each row's words reversed for the
    backward direction (its padding left in place)."""
    seq_len = gates[0].shape[1]
    steps = torch.arange(seq_len, device=gates[0].device)
    lengths = lengths.to(gates[0].device, torch.int64)[:, None]
    valid = steps[None, :] < lengths                    # (B, L)
    # an involution: it also puts the reversed outputs back
    order = torch.where(valid, lengths - 1 - steps[None, :],
                        steps[None, :])[..., None]

    def run(g, w, bi, bh):
        g = g + bi + bh
        h = g.new_zeros((g.shape[0], w.shape[1]))
        c = torch.zeros_like(h)
        outputs = []
        for t in range(seq_len):
            i, f, z, o = (g[:, t] + h @ w.t()).chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            keep = valid[:, t, None]
            h = torch.where(keep, h_new, h)
            c = torch.where(keep, c_new, c)
            outputs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
        return torch.stack(outputs, dim=1), h

    fwd, h_fwd = run(gates[0], w_hh[0], b_ih[0], b_hh[0])
    reverse = gates[1].gather(1, order.expand(-1, -1, gates[1].shape[-1]))
    bwd, h_bwd = run(reverse, w_hh[1], b_ih[1], b_hh[1])
    bwd = bwd.gather(1, order.expand(-1, -1, bwd.shape[-1]))
    return torch.cat([fwd, bwd], dim=-1), torch.cat([h_fwd, h_bwd], dim=-1)


def takes_width(hidden: int, dtype: torch.dtype) -> bool:
    """Whether the kernel is built for an LSTM of ``hidden`` units a
    direction whose weights are of ``dtype``."""
    return hidden == HIDDEN and dtype == torch.float32


def check_inputs(gates: Pair, lengths: torch.Tensor, w_hh: Pair, b_ih: Pair,
                 b_hh: Pair) -> None:
    """Raise on anything csrc/bilstm.cu does not take."""
    g = gates[0]
    if g.device.type != "cuda":
        raise ValueError(f"bilstm_cuda: no kernel for device {g.device}")
    if g.dim() != 3 or g.shape[0] < 1 or g.shape[1] < 1:
        raise ValueError(f"bilstm_cuda: gates must be (B >= 1, L >= 1, "
                         f"{4 * HIDDEN}); got {tuple(g.shape)}")
    want = {"gates": (tuple(g.shape[:2]) + (4 * HIDDEN,), gates),
            "w_hh": ((4 * HIDDEN, HIDDEN), w_hh),
            "b_ih": ((4 * HIDDEN,), b_ih), "b_hh": ((4 * HIDDEN,), b_hh)}
    for name, (shape, pair) in want.items():
        for t in pair:
            if (tuple(t.shape) != shape or t.dtype != torch.float32
                    or t.device != g.device or not t.is_contiguous()
                    or (name == "w_hh" and t.data_ptr() % 16)):
                raise ValueError(
                    f"bilstm_cuda: {name} must be {shape} fp32, contiguous "
                    f"(w_hh 16-byte aligned), on {g.device}; got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if lengths.shape != (g.shape[0],) or lengths.device != g.device:
        raise ValueError(f"bilstm_cuda: lengths must be ({g.shape[0]},) on "
                         f"{g.device}; got {tuple(lengths.shape)} on "
                         f"{lengths.device}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bilstm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bilstm.argtypes = [p] * 11 + [i, i, p]
    lib.bilstm.restype = i
    lib.bilstm_rows_per_cluster.argtypes = [i]
    lib.bilstm_rows_per_cluster.restype = i
    return lib


def rows_per_cluster(batch: int) -> int:
    """The batch rows that one cluster of the kernel takes at ``batch``
    (1, 2, 4 or 8: the fewest with which the card holds every cluster at
    once)."""
    return _lib().bilstm_rows_per_cluster(batch)


def bilstm_cuda(gates: Pair, lengths: torch.Tensor, w_hh: Pair, b_ih: Pair,
                b_hh: Pair) -> Pair:
    """(words (B, L, 2H), sent (B, 2H)) of the masked BiLSTM, from each
    direction's (forward, backward) input projection (B, L, 4H), W_hh,
    bias_ih and bias_hh, and the lengths (B,).

    CUDA tensors launch the kernel (or raise), reading the lengths where
    they lie; CPU tensors run the plain version."""
    if gates[0].device.type == "cpu":
        return bilstm(gates, lengths, w_hh, b_ih, b_hh)
    lengths = lengths.to(torch.int64).contiguous()
    check_inputs(gates, lengths, w_hh, b_ih, b_hh)
    b, seq_len, _ = gates[0].shape
    words = torch.empty((b, seq_len, 2 * HIDDEN), device=gates[0].device)
    sent = torch.empty((b, 2 * HIDDEN), device=gates[0].device)
    status = _lib().bilstm(
        *(t.data_ptr() for t in (*gates, *w_hh)),
        *(t.data_ptr() for pair in zip(b_ih, b_hh) for t in pair),
        lengths.data_ptr(), words.data_ptr(), sent.data_ptr(), b, seq_len,
        torch.cuda.current_stream(gates[0].device).cuda_stream)
    _build.check(status, "bilstm")
    bilstm_cuda.launches += 1
    return words, sent


bilstm_cuda.launches = 0    # kernel launches, for tests and smoke runs
