"""The one traffic generator: a traffic mix's parameters and a seed -> a
pool of distinct batches, cycled by the window.

Parameters (``perfbench/mixes/<traffic>.json``):
  rows         captions a call
  words        [least, most] words a caption; every pool holds the same
               multiset of lengths (least..most, each as often, over all
               its rows), in an order drawn from the seed, so that seeds
               change the order of the work and not its amount
  pool         distinct batches, cycled
  synchronous  true: each call ends in a synchronize before the next
               starts (one user who waits for each image), and each call
               is timed; absent: back to back, from one client,
               synchronized at the window's end

Tokens are uniform over the configuration's vocabulary and padded with 0
to its ``seq_len``. Noise and eps are standard normal. Everything but the lengths, which the port reads on
the host, is made on the device with one ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def sub_seeds(seed: int, n: int = 4):
    """n independent 32-bit seeds from any whole number."""
    return [int(s) for s in np.random.SeedSequence(
        abs(int(seed))).generate_state(n)]


def lengths_pool(words, pool: int, rows: int, rng: np.random.Generator
                 ) -> np.ndarray:
    lo, hi = words
    span = np.arange(lo, hi + 1)
    flat = np.resize(span, pool * rows)
    return rng.permutation(flat).reshape(pool, rows)


def make_pool(traffic: dict, cfg: dict, seed: int, device) -> Dict[str, object]:
    """{"tokens" (P, B, L) int64, "lengths" (P, B) int64 on the host,
    "noise" (P, B, z), "eps" (P, B, cond)}."""
    p, b, seq = traffic["pool"], traffic["rows"], cfg["seq_len"]
    host_seed, dev_seed = sub_seeds(seed, 2)
    rng = np.random.default_rng(host_seed)
    gen = torch.Generator(device).manual_seed(dev_seed)
    lengths = torch.from_numpy(lengths_pool(traffic["words"], p, b, rng))
    tokens = torch.randint(0, cfg["vocab"], (p, b, seq), generator=gen,
                           device=device)
    steps = torch.arange(seq, device=device)
    tokens = torch.where(steps < lengths.to(device)[..., None], tokens, 0)
    return {"tokens": tokens, "lengths": lengths,
            "noise": torch.randn((p, b, cfg["z_dim"]), generator=gen,
                                 device=device),
            "eps": torch.randn((p, b, cfg["cond_dim"]), generator=gen,
                               device=device)}


def batch(pool: Dict[str, object], i: int) -> Dict[str, object]:
    """The i-th call's batch: entry i mod P of every field."""
    k = i % pool["tokens"].shape[0]
    return {key: v[k] for key, v in pool.items()}
