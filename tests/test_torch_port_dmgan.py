"""DM-GAN's generator in the port (models/dmgan.py, the memory form's plain
version ops/attention.py::memory_read, the serving path, the CLI) against
the plain fp32 reference tests/dmgan_reference.py (model.py's modules and
names), on the CPU at small widths (gf 4, emb 16, cond 8, noise 8: the
published 64 / 128 / 256 resolutions and two ResBlocks a stage), with one
seeded state dict of the reference carried into the port by ``to_port``.

Tolerances:
- fp32, the generator: 1e-5 absolute on images in [-1, 1] and on the
  attention maps. Both compute the same function in fp32; the port folds
  each eval BatchNorm into a scale and shift, runs the memory layers as
  Linears and the gate as one dot over [r; o], and its gaps read up to
  1.0e-6 on three seeds. Two faults fail it by orders of magnitude: the
  response gate dropped (r' = o: 0.18 on the last image,
  ``test_dropping_the_response_gate_fails``) and the int8 tier
  (``test_int8_tier_fails_the_tolerance``).
- bf16 against the fp32 reference: the worst image's mean gap 0.01 and
  the attention maps' widest gap 0.02. Every conv's input and output, the
  key and value and r' are rounded to bf16 (2^-9 relative each), some 20
  roundings deep; the gaps read 0.0009-0.0018 and 0.0056-0.0104 on three
  seeds (the keys at ``KEY_GAIN``).
- The memory form's plain version against the reference's Memory and
  response gate: 2e-6 in fp32 (one formula, summed in other orders).
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import dmgan_reference as ref
import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.core.config import GanConfig
from attngan_torch.data.dataset import word_mask
from attngan_torch.infer.sampler import (
    GENERATORS,
    InferState,
    Sampler,
    denormalize,
    load_infer_state,
    save_infer_state,
)
from attngan_torch.models.dmgan import DMGenerator, MemoryStage
from attngan_torch.ops import attention
from attngan_torch.ops.attention import memory_read
from attngan_torch.ops.cuda_attention import (
    _launch_memory_read,
    memory_read_cuda,
    plan,
    smem_bytes,
)

GF, EMB, COND, Z, SEQ, VOCAB = 4, 16, 8, 8, 6, 50
ATOL = 1e-5
BF16_MEAN, BF16_ATTN = 0.01, 0.02
READ_ATOL = 2e-6


def seeded(module, seed):
    """Every tensor of ``module``'s state dict from one seed: weights of
    two or more dimensions N(0, 1/fan-in), vectors N(0, 0.05^2); BatchNorm
    scales 1 + 0.1 N, shifts 0.1 N, running means 0.1 N, running variances
    0.5 + U(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = v
            continue
        x = torch.randn(v.shape, generator=gen)
        if k.endswith("running_var"):
            x = 0.5 + torch.rand(v.shape, generator=gen)
        elif k.endswith("running_mean"):
            x = 0.1 * x
        elif ".bn" in k or _is_bn(module, k):
            x = (1.0 + 0.1 * x) if k.endswith("weight") else 0.1 * x
        elif v.dim() > 1:
            x = x / math.sqrt(math.prod(v.shape[1:]))
        else:
            x = 0.05 * x
        out[k] = x
    return out


def _is_bn(module, key):
    parent = module.get_submodule(key.rpartition(".")[0])
    return isinstance(parent, torch.nn.modules.batchnorm._BatchNorm)


# the memory keys' weights scaled up: at gf 4 the seeded logits are a few
# hundredths and every map near uniform; at 30 a 6-word row's largest
# weight averages ~0.27
KEY_GAIN = 30.0


def reference(seed=1, stages=3):
    net = ref.G_NET(GF, EMB, COND, Z, stages)
    state = seeded(net, seed)
    for k in state:
        if ".key.0.weight" in k:
            state[k] = KEY_GAIN * state[k]
    net.load_state_dict(state, strict=True)
    return net.eval()


def to_port(sd, gf=GF):
    """model.py's G_NET state dict -> the port's DMGenerator keys: the
    initial stage's features reordered from (C, 4, 4) to the port's
    (4, 4, C) and its input from (c, z) to (z, c); the 1x1 Conv1d / Conv2d
    weights squeezed; BatchNorm's step counters dropped."""
    ng = 16 * gf
    n = ng * 16
    hw = torch.arange(16)
    perm = torch.cat([half * n + (torch.arange(ng)[None, :] * 16
                                  + hw[:, None]).reshape(-1)
                      for half in (0, 1)])
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        parts = k.split(".")
        head, rest = parts[0], parts[1:]
        if head == "ca_net":
            out["ca." + ".".join(rest)] = v
        elif head == "h_net1" and rest[0] == "fc":
            if rest[1] == "0":
                out["gen1.fc.weight"] = torch.cat(
                    [v[:, COND:], v[:, :COND]], 1)[perm]
            else:
                out["gen1.bn." + rest[2]] = v[perm]
        elif head == "h_net1":
            i = int(rest[0][len("upsample"):]) - 1
            name = "conv.weight" if rest[1] == "1" else "bn." + rest[2]
            out[f"gen1.up.{i}.{name}"] = v
        elif head.startswith("img_net"):
            out[f"img_out{head[-1]}.conv.weight"] = v
        else:
            stage = f"gen{head[-1]}"
            if rest[0] in ("A", "B"):
                out[f"{stage}.{rest[0]}.weight"] = v
            elif rest[0] in ("M_w", "M_r", "key", "value", "response_gate"):
                out[f"{stage}.{rest[0]}.{rest[2]}"] = (
                    v.reshape(v.shape[0], -1) if v.dim() > 1 else v)
            elif rest[0] == "residual":
                j, layer = rest[1], rest[3]
                name = {"0": "conv1", "1": "bn1", "3": "conv2",
                        "4": "bn2"}[layer]
                out[f"{stage}.res.{j}.{name}.{rest[4]}"] = v
            else:                                           # upsample
                name = "conv.weight" if rest[1] == "1" else "bn." + rest[2]
                out[f"{stage}.up.{name}"] = v
    return out


def port(net, dtype=torch.float32, stages=3):
    gen = DMGenerator(GF, EMB, Z, COND, stages, dtype, fused_attention=True,
                      fused_upsample=True)
    gen.load_state_dict(to_port(net.state_dict()), strict=True)
    return gen.eval()


def inputs(seed=0, b=3, lengths=(SEQ, 2, 4)):
    gen = torch.Generator().manual_seed(seed)
    lengths = torch.tensor(lengths[:b])
    return (torch.randn((b, Z), generator=gen),
            torch.tanh(torch.randn((b, EMB), generator=gen)),
            torch.tanh(torch.randn((b, SEQ, EMB), generator=gen)),
            word_mask(lengths, SEQ),
            torch.randn((b, COND), generator=gen))


def run_reference(net, noise, sent, words, mask, eps):
    with torch.no_grad():
        fakes, attns, _, _ = net(noise, sent, words.transpose(1, 2),
                                 mask == 0, eps)
    return [f.permute(0, 2, 3, 1) for f in fakes], attns


def run_port(gen, noise, sent, words, mask, eps):
    with torch.no_grad():
        fakes, attns, _, _ = gen(noise, sent, words, mask, eps=eps)
    return fakes, attns


def gaps(got, want):
    d = (got.float() - want).abs()
    return float(d.max()), float(d.flatten(1).mean(1).max())


def test_to_port_fills_every_port_tensor():
    net = reference()
    gen = DMGenerator(GF, EMB, Z, COND, 3)
    mapped = to_port(net.state_dict())
    assert set(mapped) == set(gen.state_dict())
    for k, v in gen.state_dict().items():
        assert mapped[k].shape == v.shape, k


@pytest.mark.parametrize("seed", [1, 2])
def test_generator_matches_the_reference_in_fp32(seed):
    net = reference(seed)
    x = inputs(seed)
    want_images, want_attns = run_reference(net, *x)
    got_images, got_attns = run_port(port(net), *x)
    assert [g.shape for g in got_images] == [(3, r, r, 3)
                                             for r in (64, 128, 256)]
    assert [a.shape for a in got_attns] == [(3, SEQ, 64, 64),
                                            (3, SEQ, 128, 128)]
    for g, w in zip(got_images, want_images):
        assert gaps(g, w)[0] < ATOL
    for g, w in zip(got_attns, want_attns):
        assert gaps(g, w)[0] < ATOL
        # padded words weigh nothing, real ones sum to 1
        assert float(g[1, 2:].abs().max()) == 0.0
        torch.testing.assert_close(g.sum(1), torch.ones_like(g[:, 0]))
    assert float(want_images[-1].std()) > 0.02   # the images have contrast


def test_dropping_the_response_gate_fails(monkeypatch):
    """r' = o (the gate left out) moves the images far past the
    tolerance."""
    net = reference(1)
    x = inputs(1)
    want_images, _ = run_reference(net, *x)

    def no_gate(images, key, value, mask, gate_w, gate_b):
        return memory_read(images, key, value, mask, gate_w,
                           torch.full_like(gate_b, 1e4))

    monkeypatch.setattr(attention, "memory_read", no_gate)
    from attngan_torch.ops import cuda_attention
    monkeypatch.setattr(cuda_attention, "memory_read", no_gate)
    got_images, _ = run_port(port(net), *x)
    assert gaps(got_images[-1], want_images[-1])[0] > 100 * ATOL


def test_int8_tier_fails_the_tolerance():
    """The int8 tier (the cell's control) covers the memory write and the
    ResBlocks, and lands far outside the fp32 tolerance."""
    from attngan_torch.infer.quantize import Int8Sampler, generator_sites

    state = _state(seed=3)
    sites = generator_sites(state.generator)
    # CondAugment, gen1's Dense, 3 image convs; a memory stage's 6
    # Linears and 2 ResBlocks' 4 convs
    assert len(sites) == 2 + 3 + 2 * (6 + 4)
    assert sites[state.generator.gen2.M_w] == "gen2/M_w"
    tokens, lengths, noise, eps = _batch()
    want, _ = Sampler(state, device="cpu").generate_stages(
        tokens, lengths, noise, eps)
    sampler = Int8Sampler(state, device="cpu")
    got, attns = sampler.generate_stages(tokens, lengths, noise, eps)
    assert set(sampler.act_scales) == set(sites.values())
    assert len(attns) == 2 and bool(torch.isfinite(got[-1]).all())
    assert 100 * ATOL < gaps(got[-1], want[-1])[0] < 0.5


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_generator_in_bf16_within_its_rounding(seed):
    net = reference(seed)
    x = inputs(seed)
    want_images, want_attns = run_reference(net, *x)
    got_images, got_attns = run_port(port(net, torch.bfloat16), *x)
    for g, w in zip(got_images, want_images):
        assert gaps(g, w)[1] < BF16_MEAN
    for g, w in zip(got_attns, want_attns):
        assert gaps(g, w)[0] < BF16_ATTN


def reference_read(images, key, value, mask, gate_w, gate_b):
    """The reference's Memory and response gate on the port's layouts."""
    b, h, w, c = images.shape
    memory = ref.Memory()
    memory.applyMask(mask == 0)
    x = images.permute(0, 3, 1, 2).float()
    o, att = memory(x, key.float().transpose(1, 2),
                    value.float().transpose(1, 2))
    gate = torch.sigmoid(torch.einsum(
        "bchw,c->bhw", torch.cat([x, o], 1), gate_w) + gate_b)[:, None]
    r = x * (1 - gate) + gate * o
    return torch.cat([r, r], 1).permute(0, 2, 3, 1), att


def read_inputs(b, h, w, c, l, lengths, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn((b, h, w, c), generator=gen).to(dtype)
    key = torch.relu(torch.randn((b, l, c), generator=gen)).to(dtype)
    value = torch.relu(torch.randn((b, l, c), generator=gen)).to(dtype)
    mask = word_mask(torch.tensor(lengths), l)
    gate_w = torch.randn((2 * c,), generator=gen) / math.sqrt(2 * c)
    gate_b = 0.05 * torch.randn((1,), generator=gen)
    return images, key, value, mask, gate_w, gate_b


@pytest.mark.parametrize("b,h,w,c,l,lengths", [
    (2, 4, 4, 64, 1, (1, 1)),
    (2, 5, 7, 64, 8, (8, 3)),
    (3, 9, 5, 32, 18, (18, 8, 1)),
    (1, 64, 64, 64, 18, (13,)),
], ids=["L1", "L8-odd", "L18-odd", "L18-64sq"])
def test_memory_read_matches_the_reference(b, h, w, c, l, lengths):
    args = read_inputs(b, h, w, c, l, lengths)
    got, attn = memory_read(*args)
    want, want_attn = reference_read(*args)
    assert got.shape == (b, h, w, 2 * c) and attn.shape == (b, l, h, w)
    torch.testing.assert_close(got, want, atol=READ_ATOL, rtol=0)
    torch.testing.assert_close(attn, want_attn, atol=READ_ATOL, rtol=0)
    assert torch.equal(got[..., :c], got[..., c:])


def test_memory_read_rounds_once_in_bf16():
    """bf16 inputs: the fp32 result rounded once to bf16."""
    args = read_inputs(2, 5, 7, 64, 8, (8, 3), dtype=torch.bfloat16)
    got, attn = memory_read(*args)
    want, want_attn = reference_read(*args)
    assert got.dtype == torch.bfloat16 and attn.dtype == torch.float32
    assert torch.equal(got, want.to(torch.bfloat16))
    torch.testing.assert_close(attn, want_attn, atol=READ_ATOL, rtol=0)


def test_memory_read_logits_are_unscaled():
    """Doubling the keys doubles the logits: the softmax sharpens, which a
    1/sqrt(C) scale would not undo."""
    images, key, value, mask, gate_w, gate_b = read_inputs(
        1, 4, 4, 64, 8, (8,))
    _, attn = memory_read(images, key, value, mask, gate_w, gate_b)
    scores = torch.einsum("bhwc,blc->blhw", images, key)
    torch.testing.assert_close(attn, torch.softmax(scores, 1), atol=1e-6,
                               rtol=0)


def test_memory_read_wrapper_on_the_cpu_is_the_plain_version():
    args = read_inputs(2, 5, 7, 64, 8, (8, 3))
    before = memory_read_cuda.launches
    for a, b in zip(memory_read_cuda(*args), memory_read(*args)):
        assert torch.equal(a, b)
    assert memory_read_cuda.launches == before


@pytest.mark.parametrize("case", ["dtype", "value_dtype", "shape", "words",
                                  "chunks", "gate", "grad"])
def test_memory_read_kernel_refuses_what_it_does_not_take(case):
    images, key, value, mask, gate_w, gate_b = read_inputs(
        2, 4, 4, 64, 8, (8, 3), dtype=torch.bfloat16)
    error = ValueError
    if case == "dtype":
        images, key, value, error = (images.half(), key.half(), value.half(),
                                     TypeError)
    elif case == "value_dtype":
        value, error = value.float(), TypeError
    elif case == "shape":
        value = value[:, :4]
    elif case == "words":
        images, key, value, mask, gate_w, gate_b = read_inputs(
            1, 2, 2, 64, 33, (33,), dtype=torch.bfloat16)
    elif case == "chunks":      # 24 bf16 channels: 3 chunks a row
        images, key, value, mask, gate_w, gate_b = read_inputs(
            2, 4, 4, 24, 8, (8, 3), dtype=torch.bfloat16)
    elif case == "gate":
        gate_w = gate_w[:64]
    else:
        gate_w, error = gate_w.requires_grad_(), RuntimeError
    with pytest.raises(error):
        _launch_memory_read(images, key, value, mask, gate_w, gate_b)


@pytest.mark.parametrize("p,l", [(64 * 64, 18), (128 * 128, 18),
                                 (128 * 128, 8), (64 * 64, 1)])
def test_memory_plan_at_the_cells_shapes(p, l):
    """The memory form's blocks hold two tables and the gate beside K1's
    layout, and still fit two to an SM at C = 64 in bf16."""
    pl = plan(64, p, 64, l, 2, 132, memory=True)
    assert pl.g == 8 and pl.blocks == 2
    words = 32 if l > 16 else 16 if l > 8 else l
    extra = (smem_bytes(64, l, 2, pl.pt, pl.g, pl.stages, memory=True)
             - smem_bytes(64, l, 2, pl.pt, pl.g, pl.stages))
    # the value table and the gate's 129 floats, up to the ring's
    # 128-byte alignment
    assert abs(extra - (words * 64 * 4 + 528)) < 128


def _state(seed=0, dtype="float32"):
    torch.manual_seed(seed)
    state = InferState(GanConfig(generator="dmgan", gf_dim=GF, emb_dim=EMB,
                                 cond_dim=COND, z_dim=Z, seq_len=SEQ,
                                 compute_dtype=dtype), VOCAB)
    net = reference(seed + 1)
    state.generator.load_state_dict(to_port(net.state_dict()), strict=True)
    return state


def _batch(b=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(1, VOCAB, (b, SEQ), generator=gen)
    lengths = torch.tensor([SEQ, 2, 4][:b])
    tokens[torch.arange(SEQ) >= lengths[:, None]] = 0
    return (tokens, lengths, torch.randn((b, Z), generator=gen),
            torch.randn((b, COND), generator=gen))


def test_sampler_serves_dmgan_on_the_one_path():
    """``generate_stages`` returns three stages in [0, 1] and two memory
    maps: the reference's, fed the port's text encoder outputs."""
    state = _state()
    sampler = Sampler(state, device="cpu")
    tokens, lengths, noise, eps = _batch()
    images, attns = sampler.generate_stages(tokens, lengths, noise, eps)
    assert [i.shape for i in images] == [(3, r, r, 3)
                                         for r in (64, 128, 256)]
    assert [a.shape for a in attns] == [(3, SEQ, 64, 64),
                                        (3, SEQ, 128, 128)]
    assert all(float(i.min()) >= 0 and float(i.max()) <= 1 for i in images)
    with torch.no_grad():
        words, sent = state.rnn(tokens, lengths)
    want_images, want_attns = run_reference(
        reference(1), noise, sent, words, word_mask(lengths, SEQ), eps)
    for g, w in zip(images, want_images):
        assert gaps(g, denormalize(w))[0] < ATOL
    for g, w in zip(attns, want_attns):
        assert gaps(g, w)[0] < ATOL
    assert torch.equal(sampler.generate_from_tokens(tokens, lengths, noise,
                                                    eps), images[-1])
    assert sampler.eager_calls == 2 and sampler.replays == 0


def test_spans_of_a_dmgan_call():
    """One ``attngan.memory`` a memory stage, inside ``attngan.generator``;
    the UpBlock and stage spans as AttnGAN's."""
    sampler = Sampler(_state(), device="cpu")
    tokens, lengths, noise, eps = _batch(2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sampler.generate_stages(tokens, lengths, noise, eps)
    names = [e.name for e in prof.events()]
    assert names.count("attngan.serve") == 1
    assert names.count("attngan.generator") == 1
    assert names.count("attngan.memory") == 2
    assert names.count("attngan.upblock") == 4 + 2
    assert all(names.count(f"attngan.stage{s}") == 1 for s in (1, 2, 3))


def test_config_and_registry_name_dmgan():
    cfg = GanConfig(generator="dmgan", gf_dim=64)
    assert cfg.resolutions == (64, 128, 256)
    assert GENERATORS["dmgan"] is DMGenerator
    gen = InferState(replace_cfg(cfg), VOCAB).generator
    assert isinstance(gen.gen2, MemoryStage) and gen.has_attention
    assert gen.unexportable and "DM-GAN" in gen.unexportable


def replace_cfg(cfg):
    from attngan_torch.core.config import replace

    return replace(cfg, gf_dim=GF, emb_dim=EMB, seq_len=SEQ)


def test_infer_state_round_trip_records_the_family(tmp_path):
    state = _state()
    path = str(tmp_path / "dmgan.pt")
    save_infer_state(path, state)
    blob = torch.load(path, weights_only=True)
    assert blob["shapes"]["generator"] == "dmgan"
    back = load_infer_state(path, GanConfig(compute_dtype="float32"),
                            device="cpu")
    assert back.cfg.generator == "dmgan"
    assert isinstance(back.generator, DMGenerator)
    for k, v in state.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)
    tokens, lengths, noise, eps = _batch()
    a = Sampler(state, device="cpu").generate_stages(tokens, lengths, noise,
                                                     eps)
    b = Sampler(back, device="cpu").generate_stages(tokens, lengths, noise,
                                                    eps)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)


def test_the_gan_trainer_refuses_dmgan_by_name():
    from attngan_torch.train.gan_trainer import GanTrainer

    with pytest.raises(ValueError, match="'dmgan'.*memory read"):
        GanTrainer(GanConfig(generator="dmgan"), VOCAB, device="cpu")
    with pytest.raises(ValueError, match="'dfgan'.*DF-GAN"):
        GanTrainer(GanConfig(generator="dfgan"), VOCAB, device="cpu")


def _captions(tmp_path):
    caps = {"imgs/a001.jpg": [["c1", "c7", "f3"], 0],
            "imgs/b002.jpg": [["c2", "f9"], 1]}
    path = tmp_path / "caps.json"
    path.write_text(json.dumps(caps))
    return str(path)


def test_cli_serves_a_dmgan_checkpoint(tmp_path, capsys):
    from PIL import Image

    from attngan_torch.cli.infer import main

    caps = _captions(tmp_path)
    cfg = GanConfig(generator="dmgan", gf_dim=GF, emb_dim=EMB, seq_len=4)
    ckpt = str(tmp_path / "dmgan.pt")
    save_infer_state(ckpt, InferState(cfg, vocab_size=6))
    out = tmp_path / "out"
    paths = main(["--captions-path", caps, "--checkpoint", ckpt,
                  "--image-names", "a001", "b002", "--out", str(out),
                  "--device", "cpu", "--all-stages", "--save-attention",
                  "--generator", "dmgan"])
    names = sorted(os.path.basename(p) for p in paths)
    assert "a001_256px.png" in names and "b002_64px.png" in names
    assert any("attn" in n for n in names)
    assert np.asarray(Image.open(str(out / "a001_256px.png"))).shape == (
        256, 256, 3)
    assert "restored" in capsys.readouterr().out
    line = main(["--captions-path", caps, "--checkpoint", ckpt,
                 "--benchmark", "--batch-size", "2", "--device", "cpu"])
    assert line["metric"] == "gen_images_per_sec" and line["value"] > 0
    with pytest.raises(SystemExit, match="DM-GAN"):
        main(["--captions-path", caps, "--checkpoint", ckpt, "--device",
              "cpu", "--export", str(tmp_path / "x.zip"),
              "--export-platforms", "cpu"])
    with pytest.raises(SystemExit, match="contradicts"):
        main(["--captions-path", caps, "--checkpoint", ckpt, "--device",
              "cpu", "--image-names", "a001", "--generator", "attngan"])
