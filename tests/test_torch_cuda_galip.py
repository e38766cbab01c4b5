"""K11 (ops/cuda_clip_attention.py, csrc/clip_attention.cu), K7's resize
form (ops/cuda_dfblock.py, csrc/dfblock.cu) and GALIP's serving path on
the card, at the published widths (CLIP ViT-B/32, nf 64, imsize 224).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_galip.py

- K11 against its plain version at the ``galip-serve-b64`` cell's shapes
  (batch 64: the text's 77 tokens, 8 heads, causal; the bridge's 51 and
  50, 12 heads, unmasked), at L = 1 and L = 80, in bf16 and fp32. fp32:
  1e-5 absolute (the sums in another order). bf16: one rounding step of
  the output, 2^-7 relative plus 1e-2 absolute, as
  tests/test_torch_cuda_kernels.py allows.
- K7's resize form against F.interpolate followed by K7's plain form, at
  the cell's 7 -> 8 (512 channels) and 64 -> 224 (128) and at odd sizes;
  a 2x size takes the upsampling form, whose own tests
  (tests/test_torch_cuda_dfgan.py) stand as they were.
- The GALIP sampler: a shape's first call eager, its second a capture
  (which replays too), the rest replays, agreeing within the bf16
  tolerance; K11 launched 24 times and K7 18 times by the host on the
  eager call and on the capture, never on a replay, whose own kernels
  CUPTI counts instead: the eager call's. fp32 at batch 2 (TF32 off):
  eager, captured and replayed images against the port's CPU run at
  2e-3. On CUDA tensors neither wrapper runs its plain version.
"""

from collections import Counter

import pytest
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.core.config import GanConfig
from attngan_torch.infer.sampler import InferState, Sampler
from attngan_torch.models.clip import clip_layout
from attngan_torch.ops import cuda_clip_attention, cuda_dfblock
from attngan_torch.ops.cuda_clip_attention import (
    clip_attention,
    clip_attention_cuda,
)
from attngan_torch.ops.cuda_dfblock import dfblock, dfblock_cuda
from attngan_torch.ops.int8 import intercepting

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-5, rtol=0.0),
       torch.bfloat16: dict(atol=1e-2, rtol=2.0 ** -7)}
VOCAB, CTX = 49408, 77
IMAGE_ATOL = 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.Generator("cuda").manual_seed(0)


def check_k11(gen, b, n, heads, causal, dtype):
    qkv = (2 * torch.randn((b, n, 3 * heads * 64), generator=gen,
                           device="cuda")).to(dtype)
    before = clip_attention_cuda.launches
    got = clip_attention_cuda(qkv, heads, causal)
    torch.cuda.synchronize()
    assert clip_attention_cuda.launches == before + 1
    want = clip_attention(qkv, heads, causal)
    assert got.shape == want.shape == (b, n, heads * 64)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    # the same bits on a second launch
    assert torch.equal(clip_attention_cuda(qkv, heads, causal), got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,heads,causal", [
    (64, 77, 8, True), (64, 51, 12, False), (64, 50, 12, False),
    (64, 1, 8, True), (64, 1, 12, False), (3, 80, 12, False),
    (3, 80, 8, True), (5, 33, 2, True), (2, 64, 1, False)],
    ids=lambda v: str(v))
def test_k11_matches_plain(cuda, b, n, heads, causal, dtype):
    check_k11(cuda, b, n, heads, causal, dtype)


def test_k11_refuses_what_it_does_not_take(cuda):
    qkv = torch.zeros((2, 81, 3 * 128), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        clip_attention_cuda(qkv, 2)
    with pytest.raises(ValueError):
        clip_attention_cuda(qkv[:, :77, :300], 2)
    with pytest.raises(TypeError):
        clip_attention_cuda(qkv[:, :77].half(), 2)


def k7_args(gen, b, h, w, c, dtype):
    x = (2 * torch.randn((b, h, w, c), generator=gen, device="cuda")).to(dtype)
    consts = [torch.randn((b, c), generator=gen, device="cuda")
              for _ in range(4)]
    return x, consts


@pytest.mark.parametrize("b,h,w,c,ho,wo,dtype", [
    (64, 7, 7, 512, 8, 8, torch.bfloat16),
    (64, 64, 64, 128, 224, 224, torch.bfloat16),
    (3, 7, 5, 32, 13, 9, torch.float32),
    (2, 9, 13, 64, 4, 5, torch.bfloat16),
    (2, 5, 5, 8, 16, 16, torch.float32)], ids=lambda v: str(v))
def test_k7_resize_form_is_f_interpolate_then_k7(cuda, b, h, w, c, ho, wo,
                                                  dtype):
    x, consts = k7_args(cuda, b, h, w, c, dtype)
    before = dfblock_cuda.launches
    got = dfblock_cuda(x, *consts, size=(ho, wo))
    torch.cuda.synchronize()
    assert dfblock_cuda.launches == before + 1
    resized = F.interpolate(x.permute(0, 3, 1, 2), size=(ho, wo),
                            mode="nearest").permute(0, 2, 3, 1).contiguous()
    want = dfblock(resized, *consts)
    assert got.shape == want.shape == (b, ho, wo, c)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    # the pixels are the plain resize form's, which picks F.interpolate's
    torch.testing.assert_close(
        got.float(), dfblock(x, *consts, size=(ho, wo)).float(),
        **TOL[dtype])


def make_state(dtype="bfloat16", seed=0) -> InferState:
    torch.manual_seed(seed)
    return InferState(GanConfig(generator="galip", gf_dim=64, emb_dim=512,
                                seq_len=CTX, compute_dtype=dtype), VOCAB)


def batch(gen, rows: int) -> tuple:
    lengths = torch.randint(8, 31, (rows,), generator=gen,
                            device="cuda").cpu()
    ids = torch.randint(1, VOCAB - 2, (rows, 30), generator=gen,
                        device="cuda")
    return (clip_layout(ids, lengths, CTX, VOCAB), lengths,
            torch.randn((rows, 100), generator=gen, device="cuda"),
            torch.randn((rows, 512), generator=gen, device="cuda"))


def image(out) -> torch.Tensor:
    images, attns = out
    assert len(images) == 1 and attns == []
    return images[0]


def test_graph_path_agrees_and_launches_from_the_host_once(cuda):
    sampler = Sampler(make_state(), device="cuda")
    b = batch(cuda, 64)
    rises, outs = [], []
    for _ in range(3):                              # eager, capture, replay
        before = (clip_attention_cuda.launches, dfblock_cuda.launches)
        outs.append(image(sampler.generate_stages(*b)).clone())
        rises.append((clip_attention_cuda.launches - before[0],
                      dfblock_cuda.launches - before[1]))
    assert rises == [(24, 18), (24, 18), (0, 0)]
    paths = (sampler.eager_calls, sampler.captures, sampler.replays)
    assert paths == (1, 1, 2)
    assert outs[0].shape == (64, 224, 224, 3)
    for got in outs[1:]:
        torch.testing.assert_close(got, outs[0], **TOL[torch.bfloat16])
    # another batch through the graph: the replay reads its inputs
    other = image(sampler.generate_stages(*batch(cuda, 64)))
    assert not torch.equal(other, outs[0])


def device_kernels(call) -> Counter:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return Counter({e.key: e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation
                    and "memset" not in e.key.lower()
                    and "memcpy" not in e.key.lower()})


def test_a_replay_runs_the_eager_calls_kernels(cuda):
    sampler = Sampler(make_state(), device="cuda")
    b = batch(cuda, 64)
    sampler.generate_stages(*b)
    with intercepting(lambda layer, x: None):     # eager, the float path
        sampler.generate_stages(*b)
        eager = device_kernels(lambda: sampler.generate_stages(*b))
    sampler.generate_stages(*b)                     # capture
    replayed = device_kernels(lambda: sampler.generate_stages(*b))
    k11 = sum(n for k, n in replayed.items() if "clip_attn" in k)
    k7 = sum(n for k, n in replayed.items() if "dfblock" in k)
    assert (k11, k7) == (24, 18), replayed
    assert replayed == eager


def test_no_plain_version_on_the_card(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(cuda_clip_attention, "clip_attention", refuse)
    monkeypatch.setattr(cuda_dfblock, "dfblock", refuse)
    sampler = Sampler(make_state(), device="cuda")
    b = batch(cuda, 4)
    for _ in range(3):                              # eager, capture, replay
        assert bool(torch.isfinite(image(sampler.generate_stages(*b))).all())
    assert sampler.replays == 2


def test_fp32_on_the_card_matches_the_cpu(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    state = make_state("float32", seed=1)
    tokens, lengths, noise, eps = batch(cuda, 2)
    want = image(Sampler(state, device="cpu").generate_stages(
        tokens.cpu(), lengths, noise.cpu(), eps.cpu()))
    sampler = Sampler(state, device="cuda")
    for _ in range(3):                              # eager, capture, replay
        got = image(sampler.generate_stages(tokens, lengths, noise, eps))
        torch.testing.assert_close(got.cpu(), want, atol=IMAGE_ATOL, rtol=0)
    assert sampler.replays == 2
