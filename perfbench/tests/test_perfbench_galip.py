"""The GALIP cell at a size a CPU test run holds (the published depth, CLIP's
context of 77 and imsize 224; CLIP text width 64, ViT width 128, nf 4):
the benchmark's reference (``reference/galip.py``) against the port's
plain path through ``Sampler``; the token layout and the LayerNorm
seeding of the driver; the cell's check passing the sound program and
failing the control, the variant without the bridge's map and each
planted fault; K11's and K7's counts and the two readers of the cell's
own metrics."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness
from perfbench import traffic as tr
from perfbench.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES
from perfbench.counts import galip as counts
from perfbench.drivers import serve_galip
from perfbench.reference.galip import LayerNorm, Serving
from perfbench.trace import Trace

from conftest import CPU, run_tiny

CELL = "galip-serve-b64"
SMALL = {"gf_dim": 4, "emb_dim": 32, "z_dim": 8, "vocab": 100,
         "clip_width": 64, "clip_heads": 1, "vit_width": 128,
         "vit_heads": 2}


def tiny(rows: int = 2, dtype: str = "float32", **check) -> tuple:
    """(cell, configuration) cut to a CPU test's size; the depth, the
    context and the image's side as published."""
    cell = harness.cell_spec(CELL, harness.benchmark_spec())
    cfg = dict(harness.config_spec(cell["config"]), **SMALL)
    cfg["compute_dtype"] = dtype
    cell["mix"] = dict(cell["mix"], rows=rows, pool=3, words=[2, 6])
    cell["check"] = dict(cell["check"], sample=2, **check)
    cell["traced_calls"] = 2
    return cell, cfg


def test_the_configuration_is_galips_published_one():
    cfg = harness.config_spec("galip-coco")
    assert cfg["reduced"] == []
    assert (cfg["gf_dim"], cfg["z_dim"], cfg["emb_dim"], cfg["imsize"]) == (
        64, 100, 512, 224)
    assert (cfg["clip_width"], cfg["clip_heads"], cfg["clip_layers"],
            cfg["vit_width"], cfg["vit_heads"], cfg["vit_layers"]) == (
        512, 8, 12, 768, 12, 12)
    assert (cfg["seq_len"], cfg["vocab"], cfg["prompt_layers"]) == (
        77, 49408, list(range(1, 9)))


def test_serving_matches_the_port():
    """In fp32 both compute the same function: the gaps are rounding."""
    from attngan_torch.infer.sampler import InferState, Sampler

    cell, cfg = tiny(rows=3)
    w_seed, p_seed = tr.sub_seeds(13, 2)
    weights = serve_galip.galip_state(cfg, w_seed, CPU)
    ref = Serving(cfg, cfg["vocab"])
    ref.load_state_dict(weights, strict=True)
    state = InferState(serve_galip.gan_config(cfg), cfg["vocab"])
    state.load_state_dict(weights, strict=True)
    b = tr.batch(serve_galip.clip_pool(
        tr.make_pool(cell["mix"], cfg, p_seed, CPU), cfg["vocab"]), 0)
    got = Sampler(state, device="cpu").generate_stages(
        b["tokens"], b["lengths"], b["noise"], b["eps"])
    with torch.no_grad():
        want = ref(b["tokens"], None, b["noise"])
    assert got[1] == want[1] == []
    assert got[0][0].shape == want[0][0].shape == (3, 224, 224, 3)
    assert float((got[0][0] - want[0][0]).abs().max()) < 1e-4
    assert float(want[0][0].std()) > 0.02        # the images have contrast


def test_the_pool_in_clips_layout():
    cell, cfg = tiny(rows=4)
    pool = tr.make_pool(dict(cell["mix"], words=[8, 30]), cfg, 5, CPU)
    vocab = cfg["vocab"]
    out = serve_galip.clip_pool(pool, vocab)
    toks, lengths = out["tokens"], out["lengths"]
    assert toks.shape == (3, 4, 77) and torch.equal(lengths, pool["lengths"])
    for row, n in zip(toks.reshape(-1, 77), lengths.reshape(-1).tolist()):
        assert int(row[0]) == vocab - 2 and int(row[n + 1]) == vocab - 1
        assert int(row.argmax()) == n + 1          # the EOT is pooled
        assert bool((row[1:n + 1] >= 1).all() and
                    (row[1:n + 1] <= vocab - 3).all())
        assert bool((row[n + 2:] == 0).all())
    with pytest.raises(ValueError, match="do not fit"):
        serve_galip.clip_pool(dict(pool, lengths=pool["lengths"] + 60),
                              vocab)


def test_layernorms_are_seeded_as_batchnorms_are():
    from perfbench.counts.flops import on_meta
    from perfbench.weights import seeded_state

    _, cfg = tiny()
    plain = seeded_state(on_meta(Serving(cfg, cfg["vocab"])), 3, CPU)
    state = serve_galip.galip_state(cfg, 3, CPU)
    norms = [n for n, m in Serving(cfg, cfg["vocab"]).named_modules()
             if isinstance(m, LayerNorm)]
    assert len(norms) == 2 * (12 + 12) + 2        # blocks, final, pre
    for name in norms:
        w, b = state[f"{name}.weight"], state[f"{name}.bias"]
        torch.testing.assert_close(w, 1 + 2 * plain[f"{name}.weight"])
        torch.testing.assert_close(b, 2 * plain[f"{name}.bias"])
        assert 0.8 < float(w.mean()) < 1.2
    others = [k for k in state if k.rpartition(".")[0] not in norms]
    assert all(torch.equal(state[k], plain[k]) for k in others)


def test_sound_program_passes():
    cell, cfg = tiny()
    out = run_tiny(CELL, cell, cfg)
    assert out["correct"], out["compared"]
    assert [c["name"] for c in out["compared"]] == ["image_mean_abs",
                                                    "nonfinite"]


@pytest.mark.parametrize("variant", ["control", "no_bridge", "no_causal",
                                     "no_sentence"])
def test_control_and_the_missing_bridge_fail(variant):
    """The int8 tier in bf16, the port without its bridge's map, its text
    tower without the causal mask and its sentence zeroed, each against
    the cell's limit."""
    cell, cfg = tiny(dtype="bfloat16" if variant == "control" else
                     "float32")
    out = run_tiny(CELL, cell, cfg, variant=variant)
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


@pytest.mark.parametrize("change", [_alter_one_image, _zero_the_sentence])
def test_serving_faults_fail(change, monkeypatch):
    cell, cfg = tiny()
    _alter(monkeypatch, change)
    out = run_tiny(CELL, cell, cfg)
    assert not out["correct"], out["compared"]


def test_a_port_without_galip_fails_at_once(monkeypatch):
    """The parent's GanConfig has no CLIP sizes: the driver refuses before
    it builds anything."""
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
        generator: str = "attngan"

    monkeypatch.setattr(config, "GanConfig", OldGanConfig)
    cell, cfg = tiny()
    with pytest.raises(RuntimeError, match="cannot build galip-coco"):
        serve_galip.Driver(cell, cfg, 5, CPU)


def test_k11_counts_by_hand():
    # the text's layer at 64 x 77, 8 heads, causal; a bridge layer at 51
    assert counts.clip_attn_bytes(64, 77, 8) == 2 * 64 * 77 * 512 * 4
    assert counts.clip_attn_flops(64, 77, 8, True) == (
        4 * 64 * 8 * 64 * 77 * 78 // 2)
    assert counts.clip_attn_flops(64, 51, 12, False) == (
        4 * 64 * 12 * 64 * 51 * 51)
    assert counts.clip_attn_bound_s(64, 51, 12, False) == pytest.approx(max(
        2 * 64 * 51 * 768 * 4 / PEAK_HBM_BYTES,
        4 * 64 * 12 * 64 * 51 * 51 / PEAK_BF16_FLOPS))
    cfg = harness.config_spec("galip-coco")
    layers = list(counts.serve_attention(64, cfg))
    assert len(layers) == 24
    assert layers[:12] == [(64, 77, 8, True)] * 12
    assert [s[1] for s in layers[12:]] == [50] + [51] * 8 + [50] * 3
    # bytes bound it: about 0.15 ms a call
    total = sum(counts.clip_attn_bound_s(*s) for s in layers)
    assert 1.3e-4 < total < 1.6e-4


def test_the_df_layers_of_a_call():
    cfg = harness.config_spec("galip-coco")
    layers = list(counts.serve_df_layers(64, cfg))
    assert len(layers) == 18
    assert layers[:2] == [(64, 7, 7, 7, 7, 32), (64, 7, 7, 7, 7, 64)]
    assert layers[8] == (64, 7, 7, 8, 8, 512)        # the 7 -> 8 resize
    assert layers[-2:] == [(64, 64, 64, 224, 224, 128),
                           (64, 224, 224, 224, 224, 64)]
    b, c = 64, 128
    assert counts.dfblock_bytes(*layers[-2]) == (
        2 * b * c * (64 * 64 + 224 * 224) + 16 * b * c)
    total = sum(counts.dfblock_bytes(*s) for s in layers)
    assert 2.2e9 < total < 2.3e9                     # about 0.67 ms
    assert sum(counts.dfblock_bound_s(*s) for s in layers) == pytest.approx(
        total / PEAK_HBM_BYTES)


def _readings(ops, calls=2, bounds=None):
    return harness.Readings(Trace(1.0, calls, ops, []), None, 0.0,
                            bounds or {})


@pytest.mark.parametrize("metric", ["clip_attn_roofline",
                                    "clip_attn_ms.serve"])
def test_readers_find_nothing_without_k11(metric):
    ops = [("void attngan::dfb::dfblock_kernel<__nv_bfloat16, true>(...)",
            0.0, 1e-3)]
    assert harness.reader(metric)(_readings(
        ops, bounds={"clip_attn": 1e-4})) is None


def test_readers_of_k11_by_hand():
    ops = [("void attngan::clip::clip_attn_kernel<__nv_bfloat16, 3>(...)",
            0.0, 2e-4),
           ("void attngan::clip::clip_attn_kernel<__nv_bfloat16, 2>(...)",
            1e-3, 1.4e-3),
           ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 2e-3, 3e-3)]
    r = _readings(ops, calls=2, bounds={"clip_attn": 1.5e-4})
    assert harness.reader("clip_attn_ms.serve")(r) == pytest.approx(0.3)
    assert harness.reader("clip_attn_roofline")(r) == pytest.approx(
        100 * 1.5e-4 * 2 / 6e-4)


def test_the_tiny_traced_cell_reports_its_metrics():
    cell, cfg = tiny()
    out = run_tiny(CELL, cell, cfg, trace=True)
    wanted = {m["name"] for m in harness.metrics_of(
        CELL, harness.benchmark_spec())["per_layer"]}
    assert {"clip_attn_ms.serve", "clip_attn_roofline", "dfblock_roofline",
            "dfblock_ms.serve", "graph_replay.serve", "mfu.serve"} <= wanted
    assert not wanted & {"upblock_roofline", "host_ms.upblock",
                         "bn_epilogue_ms.serve", "bilstm_ms.serve",
                         "memread_ms.serve", "memread_roofline"}
    # on the CPU no kernel runs: the device readers find nothing
    assert "clip_attn_roofline" not in out["metrics"]
    assert "clip_attn_ms.serve" not in out["metrics"]
    assert out["metrics"]["graph_replay.serve"]["value"] == 0.0
    assert out["metrics"]["mfu.serve"]["value"] > 0


@pytest.mark.parametrize("cell", ["lsun-serve-b64", "cub-serve-b1",
                                  "dfgan-serve-b64", "dmgan-serve-b64"])
def test_the_other_cells_do_not_report_k11(cell):
    wanted = {m["name"] for m in harness.metrics_of(
        cell, harness.benchmark_spec())["per_layer"]}
    assert not wanted & {"clip_attn_ms.serve", "clip_attn_roofline"}
