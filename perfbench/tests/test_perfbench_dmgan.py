"""The DM-GAN cell at a size a CPU test run holds: the benchmark's
reference (``reference/dmgan.py``) against the port's plain path through
``Sampler``; the cell's check passing the sound program and failing the
control and each planted fault; the memory form's counts, the driver's
bounds and the two readers of the cell's own metrics."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness
from perfbench import traffic as tr
from perfbench.counts import PEAK_HBM_BYTES
from perfbench.counts import dmgan as counts
from perfbench.counts import kernels
from perfbench.drivers import serve_dmgan
from perfbench.reference.dmgan import Serving
from perfbench.trace import Trace
from perfbench.weights import seeded_state

from conftest import CPU, run_tiny, tiny

CELL = "dmgan-serve-b64"


def test_serving_matches_the_port():
    """In fp32 both compute the same function: the gaps are rounding."""
    from attngan_torch.infer.sampler import InferState, Sampler

    cell, cfg = tiny(CELL, rows=3, dtype="float32")
    w_seed, p_seed = tr.sub_seeds(12, 2)
    ref = Serving(cfg, cfg["vocab"])
    weights = seeded_state(ref, w_seed, CPU)
    ref.load_state_dict(weights, strict=True)
    ref.eval()
    state = InferState(serve_dmgan.gan_config(cfg), cfg["vocab"])
    state.load_state_dict(weights, strict=True)
    sampler = Sampler(state, device="cpu")
    b = tr.batch(tr.make_pool(cell["mix"], cfg, p_seed, CPU), 0)
    got = sampler.generate_stages(b["tokens"], b["lengths"], b["noise"],
                                  b["eps"])
    with torch.no_grad():
        want = ref(b["tokens"], b["lengths"], b["noise"], b["eps"])
    assert [g.shape for g in got[0]] == [(3, r, r, 3) for r in (64, 128, 256)]
    assert [a.shape for a in got[1]] == [(3, 6, 64, 64), (3, 6, 128, 128)]
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert float((g - w).abs().max()) < 1e-5
    assert float(want[0][-1].std()) > 0.02       # the images have contrast


def test_sound_program_passes():
    cell, cfg = tiny(CELL, dtype="float32")
    out = run_tiny(CELL, cell, cfg)
    assert out["correct"], out["compared"]
    assert [c["name"] for c in out["compared"]] == [
        "image_mean_abs", "attn_max_abs", "nonfinite"]


def test_control_fails():
    cell, cfg = tiny(CELL)
    out = run_tiny(CELL, cell, cfg, variant="control")
    assert not out["correct"], out["compared"]


def _alter(monkeypatch, change):
    from attngan_torch.infer.sampler import Sampler

    real = Sampler.generate_stages

    def altered(self, tokens, lengths, noise=None, eps=None, *a, **k):
        return change(real, self, tokens, lengths, noise, eps, *a, **k)

    monkeypatch.setattr(Sampler, "generate_stages", altered)


def _alter_one_image(real, self, *args, **k):
    images, attns = real(self, *args, **k)
    images = [i.clone() for i in images]
    images[-1][0] = 1.0 - images[-1][0]
    return images, attns


def _leave_out_half(real, self, tokens, lengths, noise, eps, *a, **k):
    h = len(tokens) // 2
    images, attns = real(self, tokens[:h], lengths[:h], noise[:h], eps[:h],
                         *a, **k)
    n = len(tokens) - h
    return ([torch.cat([i, i[:n]]) for i in images],
            [torch.cat([m, m[:n]]) for m in attns])


def _no_response_gate(real, self, *args, **k):
    """r' = o: the gate's bias pushed to 1e4 in every memory stage."""
    stages = [m for name, m in self.state.generator.named_children()
              if name in ("gen2", "gen3")]
    saved = [s.response_gate.bias.detach().clone() for s in stages]
    for s in stages:
        s.response_gate.bias.data.fill_(1e4)
    try:
        return real(self, *args, **k)
    finally:
        for s, b in zip(stages, saved):
            s.response_gate.bias.data.copy_(b)


@pytest.mark.parametrize("change", [_alter_one_image, _leave_out_half,
                                    _no_response_gate])
def test_serving_faults_fail(change, monkeypatch):
    cell, cfg = tiny(CELL, dtype="float32")
    _alter(monkeypatch, change)
    out = run_tiny(CELL, cell, cfg)
    assert not out["correct"], out["compared"]


def test_a_port_without_dmgan_fails_at_once(monkeypatch):
    """The parent's GENERATORS has no "dmgan": the driver refuses before
    the reference's calibration."""
    from attngan_torch.infer import sampler

    monkeypatch.setattr(sampler, "GENERATORS",
                        {k: v for k, v in sampler.GENERATORS.items()
                         if k != "dmgan"})
    monkeypatch.setattr(serve_dmgan, "calibrated_state", None)
    cell, cfg = tiny(CELL, dtype="float32")
    with pytest.raises(ValueError, match="generator must be one of"):
        serve_dmgan.Driver(cell, cfg, 5, CPU)


def test_memread_counts_by_hand():
    # 64 images, 128^2, C 64, 18 words, bf16
    b, h, c, l = 64, 128, 64, 18
    p = h * h
    want = 2 * (b * p * c + 2 * b * l * c + b * p * 2 * c) + 4 * (
        b * l * p + b * l + 2 * c + 1)
    assert counts.memread_bytes(b, h, h, c, l) == want
    assert counts.memread_flops(b, h, h, c, l) == b * p * (4 * l * c + 7 * c)
    assert counts.memread_bound_s(b, h, h, c, l) == pytest.approx(
        want / PEAK_HBM_BYTES)


def test_the_memory_reads_of_a_call():
    reads = list(counts.serve_memory_reads(64, 64, 18, 3))
    assert reads == [(64, 64, 64, 64, 18), (64, 128, 128, 64, 18)]
    # about 0.6 GB a call, 0.18 ms at the HBM rate
    total = sum(counts.memread_bytes(*s) for s in reads)
    assert 0.59e9 < total < 0.61e9
    bound = sum(counts.memread_bound_s(*s) for s in reads)
    assert 0.17e-3 < bound < 0.19e-3
    # K2 at (Ci, Co) = (128, 64) on the memory stages' UpBlocks
    assert [s[3:] for s in kernels.serve_upblocks(64, 64, 3)] == [
        (128, 64), (128, 64)]


def test_the_driver_gives_both_bounds():
    cell, cfg = tiny(CELL, dtype="float32")
    drv = serve_dmgan.Driver(cell, cfg, 7, CPU)
    bounds = drv.bounds_per_call()
    assert set(bounds) == {"memread", "upblock"}
    assert bounds["memread"] == pytest.approx(sum(
        counts.memread_bound_s(*s) for s in counts.serve_memory_reads(
            2, cfg["gf_dim"], cfg["seq_len"], 3)))
    assert drv.flops_per_call() > 0


def _readings(ops, calls=2, bounds=None):
    return harness.Readings(Trace(1.0, calls, ops, []), None, 0.0,
                            bounds or {})


@pytest.mark.parametrize("metric", ["memread_roofline", "memread_ms.serve"])
def test_readers_find_nothing_without_the_memory_form(metric):
    ops = [("void attngan::(anonymous namespace)::word_attention_stream_"
            "kernel<__nv_bfloat16, 4, 32>(...)", 0.0, 1e-3)]
    assert harness.reader(metric)(_readings(ops, bounds={"memread": 1e-4})) \
        is None


def test_readers_of_the_memory_form_by_hand():
    ops = [("void attngan::(anonymous namespace)::memread_stream_kernel<"
            "__nv_bfloat16, 8, 32>(...)", 0.0, 1e-4),
           ("void attngan::(anonymous namespace)::memread_stream_kernel<"
            "__nv_bfloat16, 8, 32>(...)", 1e-3, 1.4e-3),
           ("Memcpy DtoD", 2e-3, 3e-3)]
    r = _readings(ops, calls=2, bounds={"memread": 1.5e-4})
    assert harness.reader("memread_ms.serve")(r) == pytest.approx(0.25)
    assert harness.reader("memread_roofline")(r) == pytest.approx(
        100 * 1.5e-4 * 2 / 5e-4)


def test_the_tiny_traced_cell_reports_its_metrics():
    cell, cfg = tiny(CELL, dtype="float32")
    out = run_tiny(CELL, cell, cfg, trace=True)
    wanted = {m["name"] for m in harness.metrics_of(
        CELL, harness.benchmark_spec())["per_layer"]}
    assert {"memread_roofline", "memread_ms.serve", "upblock_roofline",
            "bn_epilogue_ms.serve", "graph_replay.serve"} <= wanted
    assert not {"host_ms.upblock", "dfblock_roofline",
                "dfblock_ms.serve"} & wanted
    # on the CPU no kernel runs: the device readers find nothing
    assert "memread_roofline" not in out["metrics"]
    assert "memread_ms.serve" not in out["metrics"]
    assert out["metrics"]["graph_replay.serve"]["value"] == 0.0
