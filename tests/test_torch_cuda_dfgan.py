"""K7 (ops/cuda_dfblock.py, csrc/dfblock.cu) and DF-GAN's serving path on
the card, at the published widths (nf 32, sentence 256, noise 100).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_dfgan.py

- K7 against its plain version at every (B, H, W, C) a call of the
  ``dfgan-serve-b64`` cell gives it (batch 64: each block's first DF layer
  in the upsampling form, its second in the plain form), in bf16, the
  serving type, and at odd and small shapes in fp32 and bf16. fp32: 1e-5
  absolute (the kernel fuses each multiply-add, the plain version rounds
  the product first). bf16: one rounding step of the output, 2^-7
  relative plus 1e-2 absolute, as tests/test_torch_cuda_kernels.py allows.
- The DF-GAN sampler: a shape's first call eager, its second a capture,
  the rest replays, agreeing within the bf16 tolerance; K7 launched 12
  times by the host on the eager call and on the capture and never on a
  replay, whose own kernels CUPTI counts instead: the eager call's, K7 12
  times. fp32 at batch 2 (TF32 off): eager and replayed images against
  the port's CPU run at 1e-3 (cuDNN's algorithms against the CPU's over
  16 convs).
"""

from collections import Counter

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.core.config import GanConfig
from attngan_torch.infer.sampler import InferState, Sampler
from attngan_torch.models.dfgan import channel_pairs
from attngan_torch.ops.cuda_dfblock import dfblock, dfblock_cuda
from attngan_torch.ops.int8 import intercepting

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-5, rtol=0.0),
       torch.bfloat16: dict(atol=1e-2, rtol=2.0 ** -7)}
VOCAB, SEQ = 5450, 18
IMAGE_ATOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.Generator("cuda").manual_seed(0)


def cell_layers(rows: int = 64):
    """(B, H, W, C, upsample) of each DF layer of a call: a block's first
    reads its input before the upsample, its second the c1 output."""
    h = 4
    for cin, cout in channel_pairs(32):
        yield rows, h, h, cin, True
        yield rows, 2 * h, 2 * h, cout, False
        h *= 2


def k7_args(gen, b, h, w, c, dtype):
    x = (2 * torch.randn((b, h, w, c), generator=gen, device="cuda")).to(dtype)
    consts = [torch.randn((b, c), generator=gen, device="cuda")
              for _ in range(4)]
    return x, consts


def check_k7(x, consts, upsample):
    before = dfblock_cuda.launches
    got = dfblock_cuda(x, *consts, upsample=upsample)
    torch.cuda.synchronize()
    assert dfblock_cuda.launches == before + 1
    want = dfblock(x, *consts, upsample=upsample)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[x.dtype])


@pytest.mark.parametrize("b,h,w,c,upsample", list(cell_layers()),
                         ids=lambda v: str(v))
def test_k7_matches_plain_at_the_cells_shapes(cuda, b, h, w, c, upsample):
    check_k7(*k7_args(cuda, b, h, w, c, torch.bfloat16), upsample)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("upsample", [False, True], ids=["plain", "upsample"])
@pytest.mark.parametrize("b,h,w,c", [(3, 7, 5, 32), (1, 1, 1, 256),
                                     (2, 9, 13, 64), (5, 3, 33, 8)])
def test_k7_odd_shapes(cuda, b, h, w, c, upsample, dtype):
    check_k7(*k7_args(cuda, b, h, w, c, dtype), upsample)


def test_k7_refuses_what_it_does_not_take(cuda):
    x, consts = k7_args(cuda, 2, 4, 4, 12, torch.bfloat16)
    with pytest.raises(ValueError):
        dfblock_cuda(x, *consts)
    x, consts = k7_args(cuda, 2, 4, 4, 16, torch.bfloat16)
    with pytest.raises(ValueError):
        dfblock_cuda(x.transpose(1, 2), *consts)
    with pytest.raises(TypeError):
        dfblock_cuda(x.half(), *consts)


def make_state(dtype="bfloat16", seed=0) -> InferState:
    torch.manual_seed(seed)
    return InferState(GanConfig(generator="dfgan", gf_dim=32, emb_dim=256,
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
            torch.randn((rows, 256), generator=gen, device="cuda"))


def image(out) -> torch.Tensor:
    images, attns = out
    assert len(images) == 1 and attns == []
    return images[0]


def test_graph_path_agrees_and_launches_from_the_host_once(cuda):
    sampler = Sampler(make_state(), device="cuda")
    b = batch(cuda, 64)
    rises, outs = [], []
    for _ in range(3):                              # eager, capture, replay
        before = dfblock_cuda.launches
        outs.append(image(sampler.generate_stages(*b)).clone())
        rises.append(dfblock_cuda.launches - before)
    assert rises == [12, 12, 0]
    assert (sampler.eager_calls, sampler.captures, sampler.replays) == (1, 1, 2)
    assert outs[0].shape == (64, 256, 256, 3)
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
    k7 = {k: n for k, n in replayed.items() if "dfblock" in k}
    assert sum(k7.values()) == 12, k7
    assert replayed == eager


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
