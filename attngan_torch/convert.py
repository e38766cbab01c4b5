"""Weight bridge: a JAX ``InferState`` -> the port's modules.

The input is a flat ``{path: np.ndarray}`` dict keyed by the flax path
joined with "/" under the three subtrees sampling touches, e.g.
``gen_params/gen1/UpBlock_0/kernel``, ``gen_stats/gen2/ResBlock_0/
TorchBatchNorm_1/var``, ``rnn_params/w_ih_fwd`` (what ``np.savez`` of a
flattened JAX InferState holds). Layouts:

  conv kernel HWIO                -> weight OIHW
  Dense kernel (in, out)          -> Linear weight (out, in)
  word_proj kernel (1, 1, E, gf)  -> Linear weight (gf, E)
  TorchBatchNorm scale / bias     -> weight / bias
  batch_stats mean / var          -> running_mean / running_var
  BiLSTM w_ih_* (E, 4H), w_hh_* (H, 4H), b_* (4H)
                                  -> weight_ih_l0[_reverse] (4H, E),
                                     weight_hh_l0[_reverse] (4H, H),
                                     bias_ih = b, bias_hh = 0
                                     (gate order is already i, f, g, o)

Coverage is strict: every JAX leaf is consumed exactly once and every port
parameter and buffer is filled; a missing or extra key raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_SUBTREES = ("rnn_params", "gen_params", "gen_stats")
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}


def _generator_key(path: str) -> str:
    """'gen2/ResBlock_1/TorchBatchNorm_0/scale' -> 'gen2.res.1.bn1.weight'."""
    parts = path.split("/")
    out = []
    for i, seg in enumerate(parts[:-1]):
        parent = parts[i - 1] if i else ""
        if seg == "CondAugment_0":
            out.append("ca")
        elif seg == "Dense_0":
            out.append("fc")
        elif seg == "word_proj" or re.fullmatch(r"gen\d|img_out\d", seg):
            out.append(seg)
        elif m := re.fullmatch(r"UpBlock_(\d)", seg):
            out.append(f"up.{m[1]}" if parts[0] == "gen1" else "up")
        elif m := re.fullmatch(r"ResBlock_(\d)", seg):
            out.append(f"res.{m[1]}")
        elif m := re.fullmatch(r"(Conv|TorchBatchNorm)_(\d)", seg):
            if parent.startswith("ResBlock_"):
                out.append(("conv" if m[1] == "Conv" else "bn")
                           + str(int(m[2]) + 1))
            elif parent.startswith("UpBlock_") or parent.startswith("img_out"):
                out.append("conv" if m[1] == "Conv" else "bn")
            else:
                out.append("bn")
        else:
            raise KeyError(f"unknown generator path segment {seg!r} in {path}")
    if parts[-1] not in _LEAVES:
        raise KeyError(f"unknown leaf {parts[-1]!r} in {path}")
    # an UpBlock's own kernel is its conv's weight
    if parts[-1] == "kernel" and parts[-2].startswith("UpBlock_"):
        out.append("conv")
    return ".".join(out + [_LEAVES[parts[-1]]])


def _generator_value(path: str, a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    if path.endswith("word_proj/kernel"):
        return t.reshape(t.shape[-2], t.shape[-1]).t().contiguous()
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1).contiguous()      # HWIO -> OIHW
    if t.dim() == 2:
        return t.t().contiguous()                      # (in, out) -> (out, in)
    return t


def _rnn_state(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    def get(name):
        return torch.from_numpy(np.array(flat[name], dtype=np.float32))

    sd = {"embedding.weight": get("embedding")}
    for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
        sd[f"lstm.weight_ih_l0{suffix}"] = get(f"w_ih_{direction}").t().contiguous()
        sd[f"lstm.weight_hh_l0{suffix}"] = get(f"w_hh_{direction}").t().contiguous()
        b = get(f"b_{direction}")
        sd[f"lstm.bias_ih_l0{suffix}"] = b
        sd[f"lstm.bias_hh_l0{suffix}"] = torch.zeros_like(b)
    return sd


_RNN_LEAVES = {"embedding", "w_ih_fwd", "w_hh_fwd", "b_fwd", "w_ih_bwd",
               "w_hh_bwd", "b_bwd"}


def convert_flat(flat: Mapping[str, np.ndarray]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Flat JAX InferState -> {"rnn": state_dict, "generator": state_dict}."""
    rnn_flat, gen_sd = {}, {}
    for key, value in flat.items():
        tree, _, path = key.partition("/")
        if tree not in _SUBTREES or not path:
            raise KeyError(f"unexpected key {key!r}: not under {_SUBTREES}")
        if tree == "rnn_params":
            if path not in _RNN_LEAVES:
                raise KeyError(f"unexpected BiLSTM leaf {key!r}")
            rnn_flat[path] = value
            continue
        port_key = _generator_key(path)
        if port_key in gen_sd:
            raise KeyError(f"{key!r} maps onto {port_key!r} twice")
        gen_sd[port_key] = _generator_value(path, value)
    missing = _RNN_LEAVES - set(rnn_flat)
    if missing:
        raise KeyError(f"missing BiLSTM leaves: {sorted(missing)}")
    return {"rnn": _rnn_state(rnn_flat), "generator": gen_sd}


def load_flat(flat: Mapping[str, np.ndarray], rnn: torch.nn.Module,
              generator: torch.nn.Module) -> None:
    """Fill ``rnn`` and ``generator`` in place; raises on any key that is
    missing or left over on either side, or a shape that disagrees."""
    sd = convert_flat(flat)
    rnn.load_state_dict(sd["rnn"], strict=True)
    generator.load_state_dict(sd["generator"], strict=True)
