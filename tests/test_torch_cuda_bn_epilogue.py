"""K8 (ops/cuda_bn_epilogue.py, csrc/bn_epilogue.cu) and its sites in the
serving generator, on the card, at the serving widths (GF 32, EMB 256).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_bn_epilogue.py

- K8 against its plain version at every site shape of a serving call at
  batch 1 and 64: the GLU form at InitialStage's (B, 16384) and the
  UpBlocks' and ResBlocks' maps (C 512, 256, 128, 64), the residual form
  at the ResBlocks' (C 64), in bf16 and fp32; and at odd shapes. fp32:
  1e-5 absolute (the kernel fuses each multiply-add and takes the
  card's rsqrtf and expf); bf16: one rounding step of the output, 1e-2
  absolute plus 2^-7 relative, as tests/test_torch_cuda_kernels.py
  allows.
- The wrapper raises on a type, a layout or a width it does not take, and
  ops/layers.py keeps the chain there, with its switch off and with grad
  on.
- The serving generator: K8 launched 13 times by the host on a shape's
  eager call and on its capture, never on a replay, whose own kernels
  CUPTI counts instead (13); after an in-place change to a running_var a
  replay computes with the new statistics, as an eager call does.
"""

from collections import Counter

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.core.config import GanConfig
from attngan_torch.infer.sampler import InferState, Sampler
from attngan_torch.ops.cuda_bn_epilogue import bn_epilogue, bn_epilogue_cuda
from attngan_torch.ops.int8 import intercepting
from attngan_torch.ops.layers import BatchNorm, glu

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-5, rtol=0.0),
       torch.bfloat16: dict(atol=1e-2, rtol=2.0 ** -7)}
VOCAB = 100
# (H, W, C, residual) of each site of a serving call at GF 32; H = 0 is
# InitialStage's (B, C)
SITES = [(0, 0, 16384, False), (8, 8, 512, False), (16, 16, 256, False),
         (32, 32, 128, False), (64, 64, 64, False), (64, 64, 128, False),
         (64, 64, 64, True), (128, 128, 128, False), (128, 128, 64, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.Generator("cuda").manual_seed(0)


def k8_args(gen, b, h, w, c, residual, dtype):
    shape = (b, c) if h == 0 else (b, h, w, c)
    x = (2 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    skip = None
    if residual:
        skip = (2 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    vectors = (torch.rand(c, generator=gen, device="cuda") + 0.5,
               0.1 * torch.randn(c, generator=gen, device="cuda"),
               0.5 * torch.randn(c, generator=gen, device="cuda"),
               torch.rand(c, generator=gen, device="cuda") + 0.5)
    return x, vectors, skip


def check_k8(x, vectors, skip):
    before = bn_epilogue_cuda.launches
    got = bn_epilogue_cuda(x, *vectors, 1e-5, skip)
    torch.cuda.synchronize()
    assert bn_epilogue_cuda.launches == before + 1
    want = bn_epilogue(x, *vectors, 1e-5, skip)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[x.dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("h,w,c,residual", SITES, ids=str)
def test_k8_matches_plain_at_the_serving_shapes(cuda, h, w, c, residual, b,
                                                dtype):
    check_k8(*k8_args(cuda, b, h, w, c, residual, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("residual", [False, True], ids=["glu", "residual"])
@pytest.mark.parametrize("b,h,w,c", [(3, 7, 5, 32), (1, 1, 1, 16),
                                     (5, 3, 33, 48), (2, 9, 13, 4096)])
def test_k8_odd_shapes(cuda, b, h, w, c, residual, dtype):
    check_k8(*k8_args(cuda, b, h, w, c, residual, dtype))


def test_k8_refuses_what_it_does_not_take(cuda):
    x, vectors, _ = k8_args(cuda, 2, 4, 4, 24, False, torch.bfloat16)
    with pytest.raises(ValueError):             # 12 output channels
        bn_epilogue_cuda(x, *vectors, 1e-5)
    x, vectors, skip = k8_args(cuda, 2, 4, 4, 32, True, torch.bfloat16)
    with pytest.raises(ValueError):
        bn_epilogue_cuda(x.transpose(1, 2), *vectors, 1e-5)
    with pytest.raises(TypeError):
        bn_epilogue_cuda(x.half(), *vectors, 1e-5)
    with pytest.raises(ValueError):
        bn_epilogue_cuda(x, *vectors, 1e-5, skip.float())
    with pytest.raises(ValueError):
        bn_epilogue_cuda(x, *vectors[:3], vectors[3][:16], 1e-5)


def test_layers_keep_the_chain_where_k8_cannot_go(cuda):
    bn = BatchNorm(24).cuda().eval()
    x = torch.randn((2, 24, 4, 4), generator=cuda, device="cuda").to(
        torch.bfloat16, memory_format=torch.channels_last)
    bn32 = BatchNorm(32).cuda().eval()
    y = torch.randn((2, 32, 4, 4), generator=cuda, device="cuda").to(
        torch.bfloat16)                                       # NCHW memory
    y_last = y.contiguous(memory_format=torch.channels_last)
    before = bn_epilogue_cuda.launches
    with torch.no_grad():
        assert torch.equal(bn.forward_glu(x, True), glu(bn(x)))   # C/2 = 12
        assert torch.equal(bn32.forward_add(y, y, True), bn32(y) + y)
        assert torch.equal(bn32.forward_glu(y_last), glu(bn32(y)))  # off
    assert torch.equal(bn32.forward_glu(y_last, True),
                       glu(bn32(y)))                          # grad on
    assert bn_epilogue_cuda.launches == before
    with torch.no_grad():
        bn32.forward_glu(y_last, True)
    assert bn_epilogue_cuda.launches == before + 1


def make_sampler(seq_len: int, seed: int = 0) -> Sampler:
    torch.manual_seed(seed)
    state = InferState(GanConfig(gf_dim=32, emb_dim=256, seq_len=seq_len),
                       VOCAB)
    with torch.no_grad():
        for name, t in state.generator.named_buffers():
            if name.endswith("running_var"):
                t.uniform_(0.5, 1.5)
    return Sampler(state, device="cuda")


def batch(gen: torch.Generator, rows: int, seq_len: int) -> tuple:
    lengths = torch.randint(1, seq_len + 1, (rows,), generator=gen,
                            device="cuda").cpu()
    tokens = torch.randint(1, VOCAB, (rows, seq_len), generator=gen,
                           device="cuda")
    tokens = torch.where(torch.arange(seq_len, device="cuda")
                         < lengths.cuda()[:, None], tokens, 0)
    return (tokens, lengths,
            torch.randn((rows, 100), generator=gen, device="cuda"),
            torch.randn((rows, 100), generator=gen, device="cuda"))


def flat(out) -> list:
    images, attns = out
    return [t.clone() for t in list(images) + list(attns)]


def device_kernels(call) -> Counter:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return Counter({e.key: e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation})


@pytest.mark.parametrize("rows,seq_len", [(64, 5), (1, 18)])
def test_a_serving_call_launches_k8_13_times(cuda, rows, seq_len):
    sampler = make_sampler(seq_len)
    b = batch(cuda, rows, seq_len)
    rises = []
    for _ in range(3):                              # eager, capture, replay
        before = bn_epilogue_cuda.launches
        sampler.generate_stages(*b)
        rises.append(bn_epilogue_cuda.launches - before)
    assert rises == [13, 13, 0]
    assert sampler.replays == 2              # the capture call replays too
    replayed = device_kernels(lambda: sampler.generate_stages(*b))
    k8 = sum(n for k, n in replayed.items() if "bn_epilogue" in k)
    assert k8 == 13, replayed


def test_a_replay_reads_the_statistics_as_they_are_then(cuda):
    sampler = make_sampler(5)
    b = batch(cuda, 8, 5)
    for _ in range(3):                              # eager, capture, replay
        before = flat(sampler.generate_stages(*b))
    gen = sampler.state.generator
    # random weights leave the images near flat (std ~1e-3): a change
    # that scales these sites' outputs ~10x moves the 64^2 image by ~0.4
    # (the fp32 chain on the CPU), far past bf16's rounding
    with torch.no_grad():
        for bn in (gen.gen1.bn, gen.gen1.up[0].bn, gen.gen2.res[0].bn1,
                   gen.gen3.res[1].bn2):
            bn.running_var.mul_(0.01)
            bn.running_mean.add_(1.0)
    replayed = flat(sampler.generate_stages(*b))
    assert sampler.replays == 3
    with intercepting(lambda layer, x: None):       # eager, the float path
        eager = flat(sampler.generate_stages(*b))
    assert float((replayed[0].float() - before[0].float()).abs().max()) > 0.1
    for got, want in zip(replayed, eager):
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL[torch.bfloat16])
