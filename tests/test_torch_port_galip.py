"""GALIP in the port (models/clip.py, models/galip.py, K7's resize form and
K11's plain versions, the serving path, the CLI) against the plain fp32
reference tests/galip_reference.py, on the CPU at small widths but the
published depth: CLIP text width 64 (one head), ViT width 128 (two
heads), 12 layers each, the prompts in blocks 1-8, CLIP's context of 77,
imsize 224, nf 4, sentence 32, noise 8, vocabulary 100; one seeded state
dict loaded strictly into both. Seeding: weights of two or more
dimensions N(0, 1/fan-in), the token embedding N(0, 0.1^2), LayerNorm
scales 1 + 0.1 n and shifts 0.1 n, other vectors N(0, 0.05^2).

Tolerances, the readings on four seeds:
- fp32, the sentence embedding: 2e-5 absolute (its entries ~1.1-1.3 on
  average). Both compute the same function; the port pools before
  ln_final, adds its residuals in place and runs K11's plain version; the
  gaps read 0.0. Dropping the causal mask moves it by 3.2-4.1.
- fp32, the bridge's output (the adapter's conv) and the mapper's
  (entries ~3 on average, up to 15): 1e-4 absolute; the gaps read
  9.1e-6-1.1e-5. Dropping the prompts moves the mapper's by 1.4-2.3 and
  the adapter's by 0.074-0.147.
- fp32, the image in [-1, 1]: 1e-4 absolute; the gaps read 4.1e-6-
  1.0e-5. Leaving out the bridge's 0.1 map moves it by 0.59-0.91.
- bf16 against the fp32 reference: the worst image's mean gap 0.02 and
  the widest 0.25, where they read 0.0027-0.0076 and 0.036-0.158; the
  residual streams and LayerNorms stay fp32, every GEMM, conv and DF
  layer is rounded to bf16 (2^-9 relative each), about 100 roundings
  deep.
- K7's and K11's plain versions: K7's resize form picks F.interpolate's
  pixels, equal bits; K11 against the reference's written-out attention,
  3e-6 (fp32: the products in another order).
"""

import json
import math
import os

import pytest
import torch
import torch.nn.functional as F

import galip_reference as ref
import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.core.config import SHAPE_FIELDS, GanConfig
from attngan_torch.infer.sampler import (
    InferState,
    Sampler,
    denormalize,
    load_infer_state,
    save_infer_state,
)
from attngan_torch.models import galip
from attngan_torch.models.clip import CLIPText, clip_layout
from attngan_torch.models.galip import GALIPGenerator, block_sizes
from attngan_torch.ops.cuda_clip_attention import (
    check_inputs,
    clip_attention,
    clip_attention_cuda,
)
from attngan_torch.ops.cuda_dfblock import dfblock, dfblock_cuda

NF, EMB, Z, CTX, VOCAB = 4, 32, 8, 77, 100
TW, TH, VW, VH = 64, 1, 128, 2
SENT_ATOL, BRIDGE_ATOL, IMAGE_ATOL = 2e-5, 1e-4, 1e-4
BF16_MEAN, BF16_MAX = 0.02, 0.25


def seeded(module, seed):
    """Every tensor of ``module``'s state dict from one seed."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in module.state_dict().items():
        x = torch.randn(v.shape, generator=gen)
        parent = k.rpartition(".")[0]
        if ".ln_" in k or parent.endswith(("ln_final", "ln_pre")):
            out[k] = 1.0 + 0.1 * x if k.endswith("weight") else 0.1 * x
        elif parent.endswith("token_embedding"):
            out[k] = 0.1 * x
        elif v.dim() > 1:
            out[k] = x / math.sqrt(math.prod(v.shape[1:]))
        else:
            out[k] = 0.05 * x
    return out


def reference(seed=1):
    text = ref.TextTower(VOCAB, CTX, TW, TH, 12, EMB)
    text.load_state_dict(seeded(text, seed), strict=True)
    net = ref.NetG(NF, Z, EMB, 224, VW, VH, 12)
    net.load_state_dict(seeded(net, seed + 100), strict=True)
    return text, net


def config(dtype="float32"):
    return GanConfig(generator="galip", gf_dim=NF, emb_dim=EMB, z_dim=Z,
                     seq_len=CTX, clip_width=TW, clip_heads=TH,
                     vit_width=VW, vit_heads=VH, compute_dtype=dtype)


def port(text, net, dtype="float32"):
    state = InferState(config(dtype), VOCAB)
    state.text_encoder.load_state_dict(text.state_dict(), strict=True)
    state.generator.load_state_dict(net.state_dict(), strict=True)
    return state.eval()


def tokens(b=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lengths = torch.tensor([8, 30, 19, 12][:b])
    ids = torch.randint(1, VOCAB - 2, (b, 30), generator=gen)
    return clip_layout(ids, lengths, CTX, VOCAB), lengths


def inputs(b=2, seed=0):
    gen = torch.Generator().manual_seed(seed + 7)
    return (*tokens(b, seed), torch.randn((b, Z), generator=gen))


def gaps(got, want):
    d = (got.float() - want.float()).abs()
    return float(d.max()), float(d.flatten(1).mean(1).max())


def test_parameters_are_the_references_names_and_shapes():
    """At the published widths (on the meta device): ~63 M in CLIP's text
    tower, ~85 M in the ViT blocks, ~42 M in the rest of the generator."""
    with torch.device("meta"):
        state = InferState(GanConfig(generator="galip", gf_dim=64,
                                     emb_dim=512, seq_len=77), 49408)
        text = ref.TextTower(49408, 77, 512, 8, 12, 512)
        net = ref.NetG()
    for got, want in ((state.text_encoder, text), (state.generator, net)):
        assert {k: v.shape for k, v in got.state_dict().items()} == {
            k: v.shape for k, v in want.state_dict().items()}

    def count(m):
        return sum(p.numel() for p in m.parameters())
    vit = count(state.generator.mapping.CLIP_ViT.transformer)
    assert 6.2e7 < count(state.text_encoder) < 6.4e7
    assert 8.4e7 < vit < 8.6e7
    assert 4.1e7 < count(state.generator) - vit < 4.3e7


def test_block_sizes_and_channels_are_galips():
    assert block_sizes(224, 5) == [8, 16, 32, 64, 224]
    assert galip.channel_pairs(64, 224) == ref.get_G_in_out_chs(64, 224) \
        == [(512, 512), (512, 512), (512, 256), (256, 128), (128, 64)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_text_tower_matches_the_reference(seed):
    text, net = reference(seed)
    toks, lengths = tokens(4, seed)
    state = port(text, net)
    with torch.no_grad():
        words, got = state.text_encoder(toks, lengths)
        want = text(toks)
        unmasked = text(toks, causal=False)
    assert words is None and got.shape == want.shape == (4, EMB)
    assert gaps(got, want)[0] < SENT_ATOL
    assert gaps(got, unmasked)[0] > 100 * SENT_ATOL     # the mask counts
    assert float(want.std()) > 0.1


def _bridge_inputs(seed):
    gen = torch.Generator().manual_seed(seed)
    code = torch.randn((2, 64, 7, 7), generator=gen)
    cond = torch.cat([torch.randn((2, Z), generator=gen),
                      torch.tanh(torch.randn((2, EMB), generator=gen))], 1)
    return code, cond


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bridge_matches_the_reference(seed):
    """The adapter's output and the mapper's, which the adapter adds at
    0.1; without the prompts both move far past the tolerance."""
    text, net = reference(seed)
    mapping = port(text, net).generator.mapping
    code, cond = _bridge_inputs(seed)
    seen = {}
    mapping.CLIP_ViT.register_forward_hook(
        lambda m, a, out: seen.setdefault("map", out))
    with torch.no_grad(), ref.fp32():
        got = mapping(code.contiguous(memory_format=torch.channels_last),
                      cond)
        want, want_map = net.mapping(code, cond)
        bare, bare_map = net.mapping(code, cond, faults=("no_prompts",))
    assert got.shape == want.shape == (2, 8 * NF, 7, 7)
    assert seen["map"].shape == want_map.shape == (2, VW, 7, 7)
    assert gaps(got, want)[0] < BRIDGE_ATOL
    assert gaps(seen["map"], want_map)[0] < BRIDGE_ATOL
    assert gaps(seen["map"], bare_map)[0] > 100 * BRIDGE_ATOL
    assert gaps(got, bare)[0] > 100 * BRIDGE_ATOL


@pytest.mark.parametrize("seed", [1, 2])
def test_generator_matches_the_reference_in_fp32(seed):
    text, net = reference(seed)
    _, _, noise = inputs(2, seed)
    gen = torch.Generator().manual_seed(seed)
    sent = torch.tanh(torch.randn((2, EMB), generator=gen))
    gen = port(text, net).generator
    with torch.no_grad():
        want, _ = net(noise, sent)
        no_bridge, _ = net(noise, sent, faults=("no_bridge",))
        fakes, attns, mu, logvar = gen(noise, sent, None, None)
    assert len(fakes) == 1 and attns == [] and mu is None and logvar is None
    assert fakes[0].shape == want.shape == (2, 224, 224, 3)
    assert gaps(fakes[0], want)[0] < IMAGE_ATOL
    assert gaps(fakes[0], no_bridge)[0] > 100 * IMAGE_ATOL
    assert float(want.std()) > 0.05          # the images have contrast


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serving_in_bf16_within_its_rounding(seed):
    text, net = reference(seed)
    toks, lengths, noise = inputs(2, seed)
    state = port(text, net, "bfloat16")
    images, attns = Sampler(state, device="cpu").generate_stages(
        toks, lengths, noise)
    with torch.no_grad():
        want = denormalize(net(noise, text(toks))[0])
    widest, worst_mean = gaps(images[0], want)
    assert attns == [] and widest < BF16_MAX and worst_mean < BF16_MEAN
    assert widest > IMAGE_ATOL               # it did run in bf16


def test_sampler_serves_galip_on_the_one_path():
    """``generate_stages`` on tokens in CLIP's layout: one 224^2 stage in
    [0, 1], no maps; the reference's image of the reference's sentence;
    eps is taken and not read."""
    text, net = reference()
    state = port(text, net)
    sampler = Sampler(state, device="cpu")
    toks, lengths, noise = inputs(2)
    images, attns = sampler.generate_stages(toks, lengths, noise,
                                            torch.randn(2, 100))
    again, _ = sampler.generate_stages(toks, lengths, noise,
                                       torch.randn(2, 3))
    assert attns == [] and len(images) == 1
    assert images[0].shape == (2, 224, 224, 3)
    assert float(images[0].min()) >= 0 and float(images[0].max()) <= 1
    assert torch.equal(images[0], again[0])
    with torch.no_grad():
        want = denormalize(net(noise, text(toks))[0])
    assert gaps(images[0], want)[0] < IMAGE_ATOL
    assert sampler.eager_calls == 2 and sampler.replays == 0


def test_clip_layout():
    toks, lengths = tokens(2)
    assert toks.shape == (2, CTX)
    assert toks[:, 0].tolist() == [VOCAB - 2] * 2
    for row, n in zip(toks, lengths.tolist()):
        assert int(row.argmax()) == n + 1 and int(row[n + 1]) == VOCAB - 1
        assert bool((row[1:n + 1] >= 1).all())
        assert bool((row[1:n + 1] < VOCAB - 2).all())
        assert bool((row[n + 2:] == 0).all())
    with pytest.raises(ValueError, match="does not fit"):
        clip_layout(torch.ones((1, 80), dtype=torch.long), [76], CTX, VOCAB)


# ---- K11 and K7's resize form: the plain versions ----

def _written_out(qkv, heads, causal):
    """The reference's attention (galip_reference.MHA) between in_proj
    and out_proj."""
    b, n, _ = qkv.shape
    q, k, v = (t.reshape(b, n, heads, 64).transpose(1, 2)
               for t in qkv.float().chunk(3, dim=-1))
    scores = q @ k.transpose(-1, -2) / math.sqrt(64)
    if causal:
        scores = scores + torch.full((n, n), float("-inf")).triu(1)
    out = torch.softmax(scores, dim=-1) @ v
    return out.transpose(1, 2).reshape(b, n, heads * 64)


@pytest.mark.parametrize("b,n,heads,causal", [
    (3, 77, 8, True), (2, 51, 12, False), (2, 50, 12, False),
    (2, 1, 8, True), (2, 80, 2, False), (1, 33, 1, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k11_plain_version_is_the_written_out_attention(b, n, heads, causal,
                                                        dtype):
    gen = torch.Generator().manual_seed(n)
    qkv = (2 * torch.randn((b, n, 3 * heads * 64), generator=gen)).to(dtype)
    got = clip_attention(qkv, heads, causal)
    want = _written_out(qkv, heads, causal)
    assert got.dtype == dtype and got.shape == (b, n, heads * 64)
    if dtype == torch.float32:
        assert gaps(got, want)[0] < 3e-6
    else:
        assert torch.equal(got, want.to(dtype)) or \
            gaps(got, want)[0] <= 2 ** -7 * float(want.abs().max())
    if causal and n > 1:    # the first query sees only the first key
        torch.testing.assert_close(got[:, 0].float(),
                                   qkv[:, 0, 2 * heads * 64:].float(),
                                   atol=1e-6, rtol=0)


def test_k11_wrapper_on_the_cpu_is_the_plain_version():
    qkv = torch.randn((2, 77, 3 * 128)).bfloat16()
    before = clip_attention_cuda.launches
    assert torch.equal(clip_attention_cuda(qkv, 2, True),
                       clip_attention(qkv, 2, True))
    assert clip_attention_cuda.launches == before


@pytest.mark.parametrize("case", [
    ("rank", lambda x: x[0], ValueError),
    ("width", lambda x: x[..., :-64], ValueError),
    ("dtype", lambda x: x.half(), TypeError),
    ("long", lambda x: torch.cat([x, x[:, :5]], 1), ValueError),
    ("layout", lambda x: x.transpose(0, 1), ValueError),
], ids=lambda c: c[0])
def test_k11_refuses_what_the_kernel_does_not_take(case):
    _, make, error = case
    x = torch.zeros((2, 77, 3 * 128), dtype=torch.bfloat16)
    check_inputs(x, 2)
    with pytest.raises(error):
        check_inputs(make(x), 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,size", [(7, 8), (64, 224), (5, 13), (9, 4)])
def test_k7_resize_form_picks_f_interpolates_pixels(hw, size, dtype):
    """The plain resize form against the DF layer followed by
    F.interpolate, index for index: equal bits."""
    gen = torch.Generator().manual_seed(hw)
    c = 16
    x = (2 * torch.randn((2, hw, hw + 1, c), generator=gen)).to(dtype)
    consts = [torch.randn((2, c), generator=gen) for _ in range(4)]
    got = dfblock(x, *consts, size=(size, size + 3))
    layer = dfblock(x, *consts).permute(0, 3, 1, 2)
    want = F.interpolate(layer.float(), size=(size, size + 3),
                         mode="nearest").to(dtype).permute(0, 2, 3, 1)
    assert got.shape == (2, size, size + 3, c) and got.dtype == dtype
    assert torch.equal(got, want)
    before = dfblock_cuda.launches
    assert torch.equal(dfblock_cuda(x, *consts, size=(size, size + 3)), got)
    assert dfblock_cuda.launches == before


def test_k7_sizes_of_2x_and_1x_are_its_other_forms():
    x = torch.randn((1, 4, 5, 8))
    consts = [torch.randn((1, 8)) for _ in range(4)]
    assert torch.equal(dfblock(x, *consts, size=(8, 10)),
                       dfblock(x, *consts, upsample=True))
    assert torch.equal(dfblock(x, *consts, size=(4, 5)), dfblock(x, *consts))


# ---- the serving surface ----

def test_spans_of_a_galip_call():
    """One ``attngan.clip_bridge`` and five ``attngan.gblock`` inside one
    ``attngan.generator``; the text tower inside
    ``attngan.text_encoder``."""
    text, net = reference()
    sampler = Sampler(port(text, net), device="cpu")
    toks, lengths, noise = inputs(1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sampler.generate_stages(toks, lengths, noise)
    names = [e.name for e in prof.events()]
    assert names.count("attngan.serve") == 1
    assert names.count("attngan.text_encoder") == 1
    assert names.count("attngan.generator") == 1
    assert names.count("attngan.clip_bridge") == 1
    assert names.count("attngan.gblock") == 5
    assert names.count("attngan.upblock") == 0


def test_infer_state_round_trip_records_the_clip_sizes(tmp_path):
    text, net = reference()
    state = port(text, net)
    path = str(tmp_path / "galip.pt")
    save_infer_state(path, state)
    blob = torch.load(path, weights_only=True)
    assert {"clip_width", "vit_width"} <= set(SHAPE_FIELDS)
    assert blob["shapes"]["generator"] == "galip"
    assert (blob["shapes"]["clip_width"], blob["shapes"]["vit_heads"]) == (
        TW, VH)
    back = load_infer_state(path, device="cpu")
    assert all(getattr(back.cfg, k) == getattr(state.cfg, k)
               for k in SHAPE_FIELDS)
    assert isinstance(back.generator, GALIPGenerator)
    assert isinstance(back.encoder, CLIPText) and not hasattr(back, "rnn")
    for k, v in state.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)


def test_config_resolution():
    assert config().resolutions == (224,)


def test_the_gan_trainer_refuses_galip_by_name():
    from attngan_torch.train.gan_trainer import GanTrainer

    with pytest.raises(ValueError, match="generator='galip'.*CLIP"):
        GanTrainer(GanConfig(generator="galip"), VOCAB, device="cpu")


def test_int8_tier_quantizes_every_linear_and_conv():
    from attngan_torch.infer.quantize import Int8Sampler, generator_sites

    text, net = reference()
    state = port(text, net)
    sites = generator_sites(state.generator)
    gen = state.generator
    want = {m for m in gen.modules()
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))}
    assert set(sites) == want
    # fc_code, fc_prompt, the bridge's 2 convs and each M_Block's 2 and
    # 4 x 2 x 2 MLP Linears, 12 ViT blocks x 3, five G_Blocks' c1, c2,
    # MLPs and the 3 c_sc, to_rgb
    assert len(sites) == 2 + 2 + 4 * (2 + 16) + 36 + 5 * (2 + 16) + 3 + 1
    toks, lengths, noise = inputs(2)
    float_images, _ = Sampler(state, device="cpu").generate_stages(
        toks, lengths, noise)
    sampler = Int8Sampler(state, device="cpu")
    images, attns = sampler.generate_stages(toks, lengths, noise)
    assert set(sampler.act_scales) == set(sites.values())
    assert attns == [] and bool(torch.isfinite(images[0]).all())
    assert 0 < gaps(images[0], float_images[0])[1] < 0.3


def test_cli_benchmarks_a_galip_state_and_refuses_captions(tmp_path):
    from attngan_torch.cli.infer import main

    text, net = reference()
    ckpt = str(tmp_path / "galip.pt")
    save_infer_state(ckpt, port(text, net))
    line = main(["--checkpoint", ckpt, "--benchmark", "--batch-size", "2",
                 "--device", "cpu", "--generator", "galip",
                 "--captions-path", str(tmp_path / "none.json")])
    assert line["metric"] == "gen_images_per_sec" and line["value"] > 0
    caps = tmp_path / "caps.json"
    caps.write_text(json.dumps({"imgs/a001.jpg": [["c1", "c7"], 0]}))
    for flags in (["--checkpoint", ckpt], ["--generator", "galip",
                                            "--checkpoint", ""]):
        with pytest.raises(SystemExit, match="BPE tokenizer"):
            main([*flags, "--image-names", "a001", "--device", "cpu",
                  "--captions-path", str(caps),
                  "--out", str(tmp_path / "out")])
    with pytest.raises(SystemExit, match="GALIP"):
        main(["--checkpoint", ckpt, "--export", str(tmp_path / "x.zip"),
              "--export-platforms", "cpu", "--device", "cpu",
              "--captions-path", str(tmp_path / "none.json")])
    assert not os.path.exists(tmp_path / "out")
