"""The reference against the port's plain path on the CPU, at tiny widths
with the same seeded weights: a wrong reference is caught here, not on
the chip. In fp32 both compute the same function, so the gaps are
rounding."""

from __future__ import annotations

import torch

from perfbench import traffic as tr
from perfbench.drivers import serve
from perfbench.reference import fp32
from perfbench.reference.generator import Serving

from conftest import CPU, tiny


def test_serving_matches_the_port():
    from attngan_torch.infer.sampler import InferState, Sampler

    cell, cfg = tiny("cub-serve-b1", rows=3, dtype="float32")
    w_seed, c_seed, p_seed, _ = tr.sub_seeds(11, 4)
    weights = serve.calibrated_state(cfg, w_seed, c_seed, CPU)
    state = InferState(serve.gan_config(cfg), cfg["vocab"])
    state.load_state_dict(weights, strict=True)
    sampler = Sampler(state, device="cpu")
    ref = Serving(cfg, cfg["vocab"])
    ref.load_state_dict(weights, strict=True)
    ref.eval()
    b = tr.batch(tr.make_pool(cell["mix"], cfg, p_seed, CPU), 0)
    got = sampler.generate_stages(b["tokens"], b["lengths"], b["noise"],
                                  b["eps"])
    with torch.no_grad(), fp32():
        want = ref(b["tokens"], b["lengths"], b["noise"], b["eps"])
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) < 1e-4
    # the images have contrast: the calibrated statistics are the batch's
    assert float(want[0][-1].std()) > 0.02
