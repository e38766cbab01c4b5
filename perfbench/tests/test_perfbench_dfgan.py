"""The DF-GAN cell at a size a CPU test run holds: the benchmark's
reference (``reference/dfgan.py``) against the port's plain path through
``Sampler``; the cell's check passing the sound program and failing the
control and each planted fault; K7's counts and the two readers of the
cell's own metrics."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness
from perfbench import traffic as tr
from perfbench.counts import PEAK_HBM_BYTES
from perfbench.counts import dfgan as counts
from perfbench.drivers import serve_dfgan
from perfbench.reference.dfgan import Serving
from perfbench.trace import Trace
from perfbench.weights import seeded_state

from conftest import CPU, run_tiny
from conftest import tiny as tiny_cell

CELL = "dfgan-serve-b64"


def tiny(name: str, **kw) -> tuple:
    """The cell at conftest's tiny widths, with the noise cut beside the
    sentence (16 wide there) to 6, near the published 100 : 256 of the
    condition, so that the text weighs in it as it does at full width."""
    cell, cfg = tiny_cell(name, **kw)
    cfg["z_dim"] = 6
    return cell, cfg


def test_serving_matches_the_port():
    """In fp32 both compute the same function: the gaps are rounding."""
    from attngan_torch.infer.sampler import InferState, Sampler

    cell, cfg = tiny(CELL, rows=3, dtype="float32")
    w_seed, p_seed = tr.sub_seeds(11, 2)
    ref = Serving(cfg, cfg["vocab"])
    weights = seeded_state(ref, w_seed, CPU)
    ref.load_state_dict(weights, strict=True)
    state = InferState(serve_dfgan.gan_config(cfg), cfg["vocab"])
    state.load_state_dict(weights, strict=True)
    sampler = Sampler(state, device="cpu")
    b = tr.batch(tr.make_pool(cell["mix"], cfg, p_seed, CPU), 0)
    got = sampler.generate_stages(b["tokens"], b["lengths"], b["noise"],
                                  b["eps"])
    with torch.no_grad():
        want = ref(b["tokens"], b["lengths"], b["noise"])
    assert got[1] == want[1] == []
    assert got[0][0].shape == want[0][0].shape == (3, 256, 256, 3)
    assert float((got[0][0] - want[0][0]).abs().max()) < 1e-5
    assert float(want[0][0].std()) > 0.02        # the images have contrast


def test_sound_program_passes():
    cell, cfg = tiny(CELL, dtype="float32")
    out = run_tiny(CELL, cell, cfg)
    assert out["correct"], out["compared"]
    assert [c["name"] for c in out["compared"]] == ["image_mean_abs",
                                                    "nonfinite"]


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
    images = [images[0].clone()]
    images[0][0] = 1.0 - images[0][0]
    return images, attns


def _leave_out_half(real, self, tokens, lengths, noise, eps, *a, **k):
    h = len(tokens) // 2
    images, attns = real(self, tokens[:h], lengths[:h], noise[:h], eps[:h],
                         *a, **k)
    return [torch.cat([images[0], images[0][:len(tokens) - h]])], attns


def _zero_the_sentence(real, self, *args, **k):
    """The sentence embedding zeroed before the generator: the check sees
    the text conditioning."""
    generator = self._generator

    def no_text(noise, sent, *rest):
        return generator(noise, torch.zeros_like(sent), *rest)

    self._generator = no_text
    try:
        return real(self, *args, **k)
    finally:
        del self._generator


@pytest.mark.parametrize("change", [_alter_one_image, _leave_out_half,
                                    _zero_the_sentence])
def test_serving_faults_fail(change, monkeypatch):
    cell, cfg = tiny(CELL, dtype="float32")
    _alter(monkeypatch, change)
    out = run_tiny(CELL, cell, cfg)
    assert not out["correct"], out["compared"]


def test_a_port_without_dfgan_fails_at_once(monkeypatch):
    """The parent's GanConfig has no ``generator``: the driver refuses
    before it builds anything."""
    import dataclasses

    from attngan_torch.core import config

    @dataclasses.dataclass(frozen=True)
    class OldGanConfig:
        gf_dim: int = 32
        emb_dim: int = 256
        z_dim: int = 100
        cond_dim: int = 100
        seq_len: int = 5
        compute_dtype: str = "bfloat16"

    monkeypatch.setattr(config, "GanConfig", OldGanConfig)
    cell, cfg = tiny(CELL, dtype="float32")
    with pytest.raises(RuntimeError, match="cannot build dfgan-cub"):
        serve_dfgan.Driver(cell, cfg, 5, CPU)


def test_dfblock_bytes_by_hand():
    # 64 images, 128^2 -> 256^2 at 64 channels, bf16
    b, h, c = 64, 128, 64
    want = 2 * b * c * (h * h + 4 * h * h) + 4 * 4 * b * c
    assert counts.dfblock_bytes(b, h, h, c, True) == want
    assert counts.dfblock_bound_s(b, h, h, c, True) == pytest.approx(
        want / PEAK_HBM_BYTES)
    assert counts.dfblock_bytes(b, 2 * h, 2 * h, 32, False) == (
        2 * b * 32 * 2 * (2 * h) ** 2 + 4 * 4 * b * 32)


def test_the_df_layers_of_a_call():
    layers = list(counts.serve_df_layers(64, 32))
    assert len(layers) == 12
    assert layers[0] == (64, 4, 4, 256, True)
    assert layers[1] == (64, 8, 8, 256, False)
    assert layers[-2:] == [(64, 128, 128, 64, True),
                           (64, 256, 256, 32, False)]
    # the bytes of a call: about 2.3 GB with the upsample folded in
    total = sum(counts.dfblock_bytes(*s) for s in layers)
    assert 2.2e9 < total < 2.4e9


def _readings(ops, calls=2, bounds=None):
    return harness.Readings(Trace(1.0, calls, ops, []), None, 0.0,
                            bounds or {})


@pytest.mark.parametrize("metric", ["dfblock_roofline", "dfblock_ms.serve"])
def test_readers_find_nothing_without_k7(metric):
    ops = [("sm90_xmma_fprop_implicit_gemm", 0.0, 1e-3)]
    assert harness.reader(metric)(_readings(ops, bounds={"dfblock": 1e-4})) \
        is None


def test_readers_of_k7_by_hand():
    ops = [("void attngan::dfb::dfblock_kernel<__nv_bfloat16, true>(...)",
            0.0, 2e-4),
           ("void attngan::dfb::dfblock_kernel<__nv_bfloat16, false>(...)",
            1e-3, 1.4e-3),
           ("Memcpy DtoD", 2e-3, 3e-3)]
    r = _readings(ops, calls=2, bounds={"dfblock": 1.5e-4})
    assert harness.reader("dfblock_ms.serve")(r) == pytest.approx(0.3)
    assert harness.reader("dfblock_roofline")(r) == pytest.approx(
        100 * 1.5e-4 * 2 / 6e-4)


def test_the_tiny_traced_cell_reports_its_metrics():
    cell, cfg = tiny(CELL, dtype="float32")
    out = run_tiny(CELL, cell, cfg, trace=True)
    wanted = {m["name"] for m in harness.metrics_of(
        CELL, harness.benchmark_spec())["per_layer"]}
    assert {"dfblock_roofline", "dfblock_ms.serve", "graph_replay.serve",
            "host_ms.generator"} <= wanted
    assert "upblock_roofline" not in wanted
    # on the CPU no kernel runs: the device readers find nothing
    assert "dfblock_roofline" not in out["metrics"]
    assert out["metrics"]["graph_replay.serve"]["value"] == 0.0
