"""DF-GAN's generator in the port (models/dfgan.py, K7's plain version in
ops/cuda_dfblock.py, the serving path, the CLI) against the plain fp32
reference tests/dfgan_reference.py, on the CPU at tiny widths (nf 4,
sentence 16, noise 8: channels 32 -> 4, the published 256^2 and six
blocks), with one seeded state dict loaded strictly into both.

Tolerances:
- fp32: 1e-5 absolute on images in [-1, 1]. Both compute the same function
  in fp32; the port runs the shortcut before the upsample, each DF layer
  in one expression and the convs' biases where it folds them, and its
  gaps read up to 1.9e-6. Rounding the DF layers' outputs to bf16 moves
  the images by 4e-3 and more
  (``test_bf16_df_layers_fail_the_fp32_tolerance``).
- bf16 against the fp32 reference: the worst image's mean gap 0.008 and
  the widest gap 0.08. Every conv's input and output, every DF layer's
  output and the shortcut with its biases are rounded to bf16 (2^-9
  relative each), 18 roundings deep; the gaps read up to 0.0046 and 0.040
  on three seeds.
- K7's plain version against the reference's DFBLK: equal bits. Both do
  the same fp32 multiplies, adds and LeakyReLUs, and round once to the
  storage type.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import dfgan_reference as ref
import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.core.config import SHAPE_FIELDS, GanConfig
from attngan_torch.infer.sampler import (
    GENERATORS,
    InferState,
    Sampler,
    denormalize,
    load_infer_state,
    save_infer_state,
)
from attngan_torch.models import dfgan
from attngan_torch.models.dfgan import DFBlock, DFGenerator, channel_pairs
from attngan_torch.ops.cuda_dfblock import check_inputs, dfblock, dfblock_cuda

NF, EMB, Z, SEQ, VOCAB = 4, 16, 8, 6, 50
FP32_ATOL = 1e-5
BF16_MEAN, BF16_MAX = 0.008, 0.08


def seeded(module, seed):
    """Every tensor of ``module``'s state dict from one seed: weights of
    two or more dimensions N(0, 1/fan-in), vectors N(0, 0.05^2)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in module.state_dict().items():
        x = torch.randn(v.shape, generator=gen)
        out[k] = (x / math.sqrt(math.prod(v.shape[1:])) if v.dim() > 1
                  else 0.05 * x)
    return out


def reference(seed=1):
    net = ref.NetG(NF, Z, EMB)
    net.load_state_dict(seeded(net, seed), strict=True)
    return net


def inputs(seed=0, b=3):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((b, Z), generator=gen),
            torch.tanh(torch.randn((b, EMB), generator=gen)))


def port(net, dtype=torch.float32):
    gen = DFGenerator(NF, EMB, Z, dtype)
    gen.load_state_dict(net.state_dict(), strict=True)
    return gen.eval()


def gaps(got, want):
    d = (got.float() - want).abs()
    return float(d.max()), float(d.flatten(1).mean(1).max())


def test_channel_pairs_are_dfgans_bird_setting():
    assert channel_pairs(32) == [(256, 256)] * 3 + [(256, 128), (128, 64),
                                                    (64, 32)]
    assert channel_pairs(32) == ref.get_G_in_out_chs(32)


def test_parameters_are_the_references_names_and_shapes():
    full = DFGenerator()
    want = ref.NetG()
    assert {k: v.shape for k, v in full.state_dict().items()} == {
        k: v.shape for k, v in want.state_dict().items()}
    assert 9.5e6 < sum(p.numel() for p in full.parameters()) < 1.0e7


@pytest.mark.parametrize("seed", [1, 2])
def test_generator_matches_the_reference_in_fp32(seed):
    net = reference(seed)
    noise, sent = inputs(seed)
    with torch.no_grad():
        want = net(noise, sent)
        fakes, attns, mu, logvar = port(net)(noise, sent, None, None)
    assert len(fakes) == 1 and attns == [] and mu is None and logvar is None
    assert fakes[0].shape == want.shape == (3, 256, 256, 3)
    assert gaps(fakes[0], want)[0] < FP32_ATOL
    assert float(want.std()) > 0.1       # the images have contrast


def test_bf16_df_layers_fail_the_fp32_tolerance(monkeypatch):
    """The fp32 comparison sees a DF layer computed in bf16."""
    net = reference()
    noise, sent = inputs()
    real = dfgan.dfblock_cuda
    monkeypatch.setattr(dfgan, "dfblock_cuda", lambda *a, **k: real(
        *a, **k).bfloat16().float())
    with torch.no_grad():
        got = port(net)(noise, sent, None, None)[0][0]
        want = net(noise, sent)
    assert gaps(got, want)[0] > 10 * FP32_ATOL


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_generator_in_bf16_within_its_rounding(seed):
    net = reference(seed)
    noise, sent = inputs(seed)
    with torch.no_grad():
        got = port(net, torch.bfloat16)(noise, sent, None, None)[0][0]
        want = net(noise, sent)
    widest, worst_mean = gaps(got, want)
    assert widest < BF16_MAX and worst_mean < BF16_MEAN
    assert widest > FP32_ATOL            # it did run in bf16


def test_text_conditions_the_image():
    net = reference()
    noise, sent = inputs()
    with torch.no_grad():
        a = port(net)(noise, sent, None, None)[0][0]
        b = port(net)(noise, torch.zeros_like(sent), None, None)[0][0]
    assert gaps(a, b)[1] > 0.05


def _df_layers(c, seed=0):
    """A reference DFBLK and the port's DFBlock with the same weights."""
    want = ref.DFBLK(Z + EMB, c)
    want.load_state_dict(seeded(want, seed), strict=True)
    got = DFBlock(Z + EMB, c)
    got.load_state_dict(want.state_dict(), strict=True)
    return want, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("upsample", [False, True], ids=["plain", "upsample"])
@pytest.mark.parametrize("b,h,w,c", [(2, 4, 4, 32), (3, 7, 5, 8),
                                     (1, 9, 13, 16)])
def test_k7_plain_version_equals_the_reference_df_layer(b, h, w, c, upsample,
                                                        dtype):
    """Odd H and W included; with ``upsample`` the layer reads the map
    before the 2x nearest upsample."""
    layer, block = _df_layers(c)
    gen = torch.Generator().manual_seed(c)
    x = (2 * torch.randn((b, c, h, w), generator=gen)).to(dtype)
    cond = torch.randn((b, Z + EMB), generator=gen)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        up = (torch.nn.functional.interpolate(x.float(), scale_factor=2)
              if upsample else x.float())
        want = layer(up, cond).to(dtype)
        got = block(x, cond, upsample=upsample)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("upsample", [False, True], ids=["plain", "upsample"])
def test_a_shift_folds_into_the_first_affine(upsample):
    """DFBlock(x, shift=s) is the reference's DFBLK of x + s: how a conv's
    bias reaches the next DF layer without a pass of its own (fp32, the
    sum in another order)."""
    layer, block = _df_layers(16)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 16, 5, 7), generator=gen).contiguous(
        memory_format=torch.channels_last)
    cond, shift = (torch.randn((2, Z + EMB), generator=gen),
                   torch.randn(16, generator=gen))
    with torch.no_grad():
        moved = x + shift[:, None, None]
        if upsample:
            moved = torch.nn.functional.interpolate(moved, scale_factor=2)
        want = layer(moved, cond)
        got = block(x, cond, upsample=upsample, shift=shift)
    torch.testing.assert_close(got, want, atol=FP32_ATOL, rtol=1e-6)


def test_k7_wrapper_on_the_cpu_is_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 5, 16), generator=gen).bfloat16()
    consts = [torch.randn((2, 16), generator=gen) for _ in range(4)]
    before = dfblock_cuda.launches
    for up in (False, True):
        assert torch.equal(dfblock_cuda(x, *consts, upsample=up),
                           dfblock(x, *consts, upsample=up))
    assert dfblock_cuda.launches == before     # counts kernel launches only
    assert dfblock(x, *consts, upsample=True).shape == (2, 6, 10, 16)


@pytest.mark.parametrize("case", [
    ("rank", lambda x, k: (x[0], k), ValueError),
    ("dtype", lambda x, k: (x.half(), k), TypeError),
    ("channels", lambda x, k: (x[..., :12].contiguous(),
                               [t[:, :12].contiguous() for t in k]),
     ValueError),
    ("layout", lambda x, k: (x.transpose(1, 2), k), ValueError),
    ("constants", lambda x, k: (x, [k[0][:, :8]] + k[1:]), ValueError),
], ids=lambda c: c[0])
def test_k7_refuses_what_the_kernel_does_not_take(case):
    _, make, error = case
    x = torch.zeros((2, 4, 6, 16), dtype=torch.bfloat16)
    consts = [torch.zeros((2, 16)) for _ in range(4)]
    check_inputs(x, *consts)
    x, consts = make(x, consts)
    with pytest.raises(error):
        check_inputs(x, *consts)


def _state(dtype="float32", seed=1):
    cfg = GanConfig(generator="dfgan", gf_dim=NF, emb_dim=EMB, z_dim=Z,
                    seq_len=SEQ, compute_dtype=dtype)
    state = InferState(cfg, VOCAB)
    state.generator.load_state_dict(reference(seed).state_dict(), strict=True)
    return state


def _batch(b=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(1, VOCAB, (b, SEQ), generator=gen)
    lengths = torch.tensor([SEQ, 2, 4][:b])
    tokens[torch.arange(SEQ) >= lengths[:, None]] = 0
    return tokens, lengths, torch.randn((b, Z), generator=gen)


def test_sampler_serves_dfgan_on_the_one_path():
    """``generate_stages`` returns one 256^2 stage in [0, 1] and no
    attention maps: the reference's image of the port's sentence
    embedding; eps is taken and not read."""
    state = _state()
    sampler = Sampler(state, device="cpu")
    tokens, lengths, noise = _batch()
    images, attns = sampler.generate_stages(tokens, lengths, noise,
                                            torch.randn(3, 100))
    again, _ = sampler.generate_stages(tokens, lengths, noise,
                                       torch.randn(3, 7))
    assert attns == [] and len(images) == 1
    assert images[0].shape == (3, 256, 256, 3)
    assert float(images[0].min()) >= 0 and float(images[0].max()) <= 1
    assert torch.equal(images[0], again[0])
    with torch.no_grad():
        _, sent = state.rnn(tokens, lengths)
        want = denormalize(reference()(noise, sent))
    assert gaps(images[0], want)[0] < FP32_ATOL
    assert torch.equal(sampler.generate_from_tokens(tokens, lengths, noise),
                       images[0])
    assert sampler.eager_calls == 3 and sampler.replays == 0


def test_spans_of_a_dfgan_call():
    """One ``attngan.generator`` a call and one ``attngan.gblock`` a
    block, inside ``attngan.serve``."""
    sampler = Sampler(_state(), device="cpu")
    tokens, lengths, noise = _batch(2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sampler.generate_stages(tokens, lengths, noise)
    names = [e.name for e in prof.events()]
    assert names.count("attngan.serve") == 1
    assert names.count("attngan.generator") == 1
    assert names.count("attngan.gblock") == 6
    assert names.count("attngan.upblock") == 0


def test_config_names_the_family():
    cfg = GanConfig(generator="dfgan")
    assert "generator" in SHAPE_FIELDS
    assert cfg.resolutions == (256,)
    assert GanConfig().generator == "attngan"
    assert GanConfig().resolutions == (64, 128, 256)
    with pytest.raises(ValueError, match="generator must be one of"):
        InferState(GanConfig(generator="stylegan"), VOCAB)


@pytest.mark.parametrize("family", sorted(GENERATORS))
def test_each_family_states_its_own_facts(family):
    """What the CLI and the int8 tier ask of a generator, answered by its
    class: whether its serving call returns attention maps, whether
    infer/export.py can write it, and its int8 sites, each one of its own
    modules under a name of its own."""
    cfg = GanConfig(generator=family, gf_dim=NF, emb_dim=EMB, z_dim=Z,
                    seq_len=SEQ, num_stages=2)
    state = InferState(cfg, VOCAB)
    gen = state.generator
    assert isinstance(gen, GENERATORS[family])
    tokens, lengths, noise = _batch()
    _, attns = Sampler(state, device="cpu").generate_stages(
        tokens, lengths, noise)
    assert bool(attns) == gen.has_attention
    assert (gen.unexportable is None) == (family == "attngan")
    sites = gen.int8_sites()
    assert sites and set(sites) <= set(gen.modules())
    assert len(set(sites.values())) == len(sites)


def test_infer_state_round_trip_records_the_family(tmp_path):
    state = _state()
    path = str(tmp_path / "dfgan.pt")
    save_infer_state(path, state)
    blob = torch.load(path, weights_only=True)
    assert blob["shapes"]["generator"] == "dfgan"
    back = load_infer_state(path, device="cpu")
    assert back.cfg.generator == "dfgan"
    assert isinstance(back.generator, DFGenerator)
    for k, v in state.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)


def test_a_checkpoint_without_the_field_loads_as_attngan(tmp_path):
    """A file written before the field existed holds AttnGAN's generator,
    whatever family the caller's config names."""
    cfg = GanConfig(gf_dim=4, emb_dim=16, seq_len=4, num_stages=2)
    path = str(tmp_path / "old.pt")
    save_infer_state(path, InferState(cfg, VOCAB))
    blob = torch.load(path, weights_only=True)
    del blob["shapes"]["generator"]
    torch.save(blob, path)
    back = load_infer_state(path, GanConfig(generator="dfgan"), device="cpu")
    assert back.cfg.generator == "attngan" and back.cfg.num_stages == 2
    assert not isinstance(back.generator, DFGenerator)


def test_the_gan_trainer_refuses_dfgan():
    from attngan_torch.train.gan_trainer import GanTrainer

    with pytest.raises(ValueError, match="AttnGAN's generator only"):
        GanTrainer(GanConfig(generator="dfgan"), VOCAB, device="cpu")


def test_int8_tier_quantizes_every_dfgan_site():
    from attngan_torch.infer.quantize import Int8Sampler, generator_sites

    state = _state()
    sites = generator_sites(state.generator)
    # fc, to_rgb's conv; each block's c1, c2, 8 MLPs of 2 Linears, and
    # c_sc in the three blocks whose channels change
    assert len(sites) == 2 + 6 * (2 + 16) + 3
    assert sites[state.generator.to_rgb[1]] == "to_rgb.1"
    tokens, lengths, noise = _batch()
    float_images, _ = Sampler(state, device="cpu").generate_stages(
        tokens, lengths, noise)
    sampler = Int8Sampler(state, device="cpu")
    images, attns = sampler.generate_stages(tokens, lengths, noise)
    assert set(sampler.act_scales) == set(sites.values())
    assert attns == [] and bool(torch.isfinite(images[0]).all())
    assert 0 < gaps(images[0], float_images[0])[1] < 0.2


def _captions(tmp_path):
    caps = {"imgs/a001.jpg": [["c1", "c7", "f3"], 0],
            "imgs/b002.jpg": [["c2", "f9"], 1]}
    path = tmp_path / "caps.json"
    path.write_text(json.dumps(caps))
    return str(path)


def test_cli_serves_a_dfgan_checkpoint(tmp_path, capsys):
    from attngan_torch.cli.infer import main

    caps = _captions(tmp_path)
    cfg = GanConfig(generator="dfgan", gf_dim=NF, emb_dim=EMB, seq_len=4)
    ckpt = str(tmp_path / "dfgan.pt")
    save_infer_state(ckpt, InferState(cfg, vocab_size=6))
    out = tmp_path / "out"
    paths = main(["--captions-path", caps, "--checkpoint", ckpt,
                  "--image-names", "a001", "b002", "--out", str(out),
                  "--device", "cpu", "--all-stages"])
    from PIL import Image

    assert [os.path.basename(p) for p in paths] == ["a001_256px.png",
                                                    "b002_256px.png"]
    for p in paths:
        assert np.asarray(Image.open(p)).shape == (256, 256, 3)
    assert "restored" in capsys.readouterr().out
    line = main(["--captions-path", caps, "--checkpoint", ckpt,
                 "--benchmark", "--batch-size", "2", "--device", "cpu",
                 "--generator", "dfgan"])
    assert line["metric"] == "gen_images_per_sec" and line["value"] > 0


@pytest.mark.parametrize("flags, match", [
    (["--image-names", "a001", "--generator", "attngan"], "contradicts"),
    (["--image-names", "a001", "--save-attention"], "no word attention"),
    (["--export", "x.zip", "--export-platforms", "cpu"], "DF-GAN"),
], ids=["family", "attention", "export"])
def test_cli_refuses_what_dfgan_has_not(tmp_path, flags, match):
    from attngan_torch.cli.infer import main

    cfg = GanConfig(generator="dfgan", gf_dim=NF, emb_dim=EMB, seq_len=4)
    ckpt = str(tmp_path / "dfgan.pt")
    save_infer_state(ckpt, InferState(cfg, vocab_size=6))
    with pytest.raises(SystemExit, match=match):
        main(["--captions-path", _captions(tmp_path), "--checkpoint", ckpt,
              "--device", "cpu", "--out", str(tmp_path / "out"), *flags])
