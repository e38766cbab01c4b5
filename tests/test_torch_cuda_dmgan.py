"""K1's memory form (ops/cuda_attention.py::memory_read_cuda,
csrc/word_attention.cu's ``memread_stream_kernel``) and DM-GAN's serving
path on the card, at the published widths (gf 64, emb 256, 18 words).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_dmgan.py

- The memory form against its plain version (ops/attention.py::
  memory_read) at the ``dmgan-serve-b64`` cell's two shapes (batch 64,
  64^2 and 128^2, C 64, 18 word slots) in bf16, and over L in {1, 8, 18}
  at odd shapes whose last tile is short, in fp32 and bf16. The output:
  fp32 1e-4 absolute (fused multiply-adds against the plain version's
  sums, and MUFU's exp in the softmax and the gate); bf16 one rounding
  step of r', 2^-7 relative plus 1e-2 absolute, as K1's tests allow. The
  attention maps, fp32 in both: 1e-5 absolute. A second launch gives the
  same bits.
- No fallback: a CUDA tensor launches the kernel (the counter rises) or
  raises; it never runs the plain version.
- The DM-GAN sampler: a shape's first call eager, its second a capture,
  the rest replays, agreeing within the bf16 tolerance; the memory form
  and K2's cluster form (its two refinement UpBlocks, Ci=128 -> Co=64)
  each launched twice by the host on the eager call and on the capture and
  never on a replay, whose own kernels CUPTI counts instead: the eager
  call's, the memory form twice. fp32 at batch 2 (TF32 off): eager and
  replayed images and maps against the port's CPU run at 1e-3 (cuDNN's
  algorithms against the CPU's over some 20 convs).
"""

from collections import Counter

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.core.config import GanConfig
from attngan_torch.infer.sampler import InferState, Sampler
from attngan_torch.ops.attention import memory_read
from attngan_torch.ops.cuda_attention import memory_read_cuda
from attngan_torch.ops.cuda_upblock import upblock_fused_eval_cuda
from attngan_torch.ops.int8 import intercepting

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=1e-2, rtol=2.0 ** -7)}
ATTN_ATOL = 1e-5
VOCAB, SEQ = 5450, 18
IMAGE_ATOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.Generator("cuda").manual_seed(0)


def read_args(gen, b, h, w, c, l, dtype):
    """Pixel rows and ReLU'd keys and values as a memory stage makes them,
    lengths 1..L with one row at L, and a gate of the seeded scale."""
    images = torch.randn((b, h, w, c), generator=gen, device="cuda").to(dtype)
    key = torch.relu(torch.randn((b, l, c), generator=gen,
                                 device="cuda")).to(dtype)
    value = torch.relu(torch.randn((b, l, c), generator=gen,
                                   device="cuda")).to(dtype)
    lengths = torch.randint(1, l + 1, (b,), generator=gen, device="cuda")
    lengths[0] = l
    mask = (torch.arange(l, device="cuda") < lengths[:, None]).to(torch.int32)
    gate_w = torch.randn((2 * c,), generator=gen, device="cuda") / (2 * c) ** 0.5
    gate_b = 0.05 * torch.randn((1,), generator=gen, device="cuda")
    return images, key, value, mask, gate_w, gate_b


def check_read(args):
    images = args[0]
    b, h, w, c = images.shape
    l = args[1].shape[1]
    before = memory_read_cuda.launches
    out, attn = memory_read_cuda(*args)
    torch.cuda.synchronize()
    assert memory_read_cuda.launches == before + 1
    want, want_attn = memory_read(*args)
    assert out.shape == (b, h, w, 2 * c) and out.dtype == images.dtype
    assert attn.shape == (b, l, h, w) and attn.dtype == torch.float32
    torch.testing.assert_close(out.float(), want.float(), **TOL[images.dtype])
    torch.testing.assert_close(attn, want_attn, atol=ATTN_ATOL, rtol=0.0)
    assert torch.equal(out[..., :c], out[..., c:])
    again = memory_read_cuda(*args)                        # same bits
    assert torch.equal(again[0], out) and torch.equal(again[1], attn)


@pytest.mark.parametrize("hw", [64, 128])
def test_memread_matches_plain_at_the_cells_shapes(cuda, hw):
    check_read(read_args(cuda, 64, hw, hw, 64, SEQ, torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 8, 18])
@pytest.mark.parametrize("b,h,w,c", [(3, 7, 5, 64), (2, 9, 13, 32),
                                     (1, 33, 17, 64), (5, 3, 3, 128)])
def test_memread_odd_shapes(cuda, b, h, w, c, l, dtype):
    check_read(read_args(cuda, b, h, w, c, l, dtype))


def test_memread_never_falls_back(cuda, monkeypatch):
    """A CUDA tensor takes the kernel or raises: the plain version is not
    reached."""
    from attngan_torch.ops import cuda_attention

    def plain(*args):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(cuda_attention, "memory_read", plain)
    check = read_args(cuda, 2, 4, 4, 64, 8, torch.bfloat16)
    before = memory_read_cuda.launches
    memory_read_cuda(*check)
    assert memory_read_cuda.launches == before + 1
    odd = read_args(cuda, 2, 4, 4, 24, 8, torch.bfloat16)   # 3 chunks a row
    with pytest.raises(ValueError, match="chunks"):
        memory_read_cuda(*odd)
    with pytest.raises(TypeError):
        memory_read_cuda(check[0].half(), check[1].half(), check[2].half(),
                         *check[3:])
    with pytest.raises(ValueError, match="contiguous"):
        memory_read_cuda(check[0].transpose(1, 2), *check[1:])
    assert memory_read_cuda.launches == before + 1


def make_state(dtype="bfloat16", seed=0) -> InferState:
    torch.manual_seed(seed)
    return InferState(GanConfig(generator="dmgan", gf_dim=64, emb_dim=256,
                                seq_len=SEQ, compute_dtype=dtype), VOCAB)


def batch(gen, rows: int) -> tuple:
    lengths = torch.randint(8, SEQ + 1, (rows,), generator=gen,
                            device="cuda").cpu()
    tokens = torch.randint(1, VOCAB, (rows, SEQ), generator=gen,
                           device="cuda")
    tokens = torch.where(torch.arange(SEQ, device="cuda")
                         < lengths.cuda()[:, None], tokens, 0)
    return (tokens, lengths,
            torch.randn((rows, 100), generator=gen, device="cuda"),
            torch.randn((rows, 100), generator=gen, device="cuda"))


def test_graph_path_agrees_and_launches_from_the_host_once(cuda):
    sampler = Sampler(make_state(), device="cuda")
    b = batch(cuda, 64)
    rises, outs = [], []
    for _ in range(3):                              # eager, capture, replay
        before = (memory_read_cuda.launches,
                  upblock_fused_eval_cuda.cluster_launches)
        images, attns = sampler.generate_stages(*b)
        outs.append(([i.clone() for i in images], [a.clone() for a in attns]))
        rises.append((memory_read_cuda.launches - before[0],
                      upblock_fused_eval_cuda.cluster_launches - before[1]))
    # the memory form and K2's cluster form, twice each a call
    assert rises == [(2, 2), (2, 2), (0, 0)]
    assert (sampler.eager_calls, sampler.captures, sampler.replays) == (1, 1, 2)
    images, attns = outs[0]
    assert [i.shape for i in images] == [(64, r, r, 3) for r in (64, 128, 256)]
    assert [a.shape for a in attns] == [(64, SEQ, 64, 64),
                                        (64, SEQ, 128, 128)]
    for got_images, got_attns in outs[1:]:
        for g, w in zip(got_images, images):
            torch.testing.assert_close(g, w, **TOL[torch.bfloat16])
        for g, w in zip(got_attns, attns):
            torch.testing.assert_close(g, w, atol=1e-2, rtol=0.0)
    # another batch through the graph: the replay reads its inputs
    other, _ = sampler.generate_stages(*batch(cuda, 64))
    assert not torch.equal(other[-1], images[-1])


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
    memread = {k: n for k, n in replayed.items() if "memread" in k}
    assert sum(memread.values()) == 2, memread
    assert replayed == eager


def test_fp32_on_the_card_matches_the_cpu(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    state = make_state("float32", seed=1)
    tokens, lengths, noise, eps = batch(cuda, 2)
    want_images, want_attns = Sampler(state, device="cpu").generate_stages(
        tokens.cpu(), lengths, noise.cpu(), eps.cpu())
    sampler = Sampler(state, device="cuda")
    for _ in range(3):                              # eager, capture, replay
        images, attns = sampler.generate_stages(tokens, lengths, noise, eps)
        for g, w in zip(images + attns, want_images + want_attns):
            torch.testing.assert_close(g.cpu(), w, atol=IMAGE_ATOL, rtol=0)
    assert sampler.replays == 2
