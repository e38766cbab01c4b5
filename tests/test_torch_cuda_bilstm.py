"""K9 (ops/cuda_bilstm.py, csrc/bilstm.cu) and the serving call's text
encoder inside its CUDA graph (infer/sampler.py), on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_bilstm.py

- K9 against its plain version (``forward_masked``'s recurrence) at the
  serving width (300 -> 2 x 128) at the cells' (rows, seq): (1, 18),
  (64, 5) and (64, 18), and at (3, 7) and (200, 18), with lengths 0 and L
  in every batch (at one row: L, then 0). fp32 with TF32 off: 1e-5
  absolute (the same function; the kernel sums each gate row's 128
  products in another order and takes the card's expf and tanhf; outputs
  lie in (-1, 1)); padded steps and empty rows exactly zero. One launch a
  call.
- The wrapper raises on a width, a type or a device it does not take;
  ``forward`` keeps cuDNN's packed path in train mode and with grad on
  (the counter does not move).
- The serving graph covers the text encoder: two replays of one graph
  with different lengths each equal their own eager call (the same
  tokens, noise and eps), in both generator families, and differ from
  each other; within one bf16 step (1e-2 absolute plus 2^-7 relative).
- A warm replayed call, with the tokens on the card and the lengths on
  the host as the benchmark holds them, makes no blocking call:
  ``torch.cuda.set_sync_debug_mode("error")`` raises on none, at the
  cells' shapes (AttnGAN (64, 5) and (1, 18), DF-GAN (64, 18)); K9 is
  launched once by the host on the eager call and on the capture and
  never on a replay.
"""

import pytest
import torch

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.core.config import GanConfig
from attngan_torch.infer.sampler import InferState, Sampler
from attngan_torch.models.rnn_encoder import BiLSTMEncoder
from attngan_torch.ops import cuda_bilstm
from attngan_torch.ops.int8 import intercepting

pytestmark = pytest.mark.cuda

VOCAB = 5450
ATOL = 1e-5
BF16 = dict(atol=1e-2, rtol=2.0 ** -7)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.Generator("cuda").manual_seed(0)


def encoder() -> BiLSTMEncoder:
    torch.manual_seed(0)
    rnn = BiLSTMEncoder(VOCAB, hidden_dim=256).cuda().eval()
    with torch.no_grad():           # a trained bias_hh is zero; K9 reads it
        rnn.lstm.bias_hh_l0.normal_(0.0, 0.1)
        rnn.lstm.bias_hh_l0_reverse.normal_(0.0, 0.1)
    return rnn


def captions(gen, rows: int, seq: int, least: int = 0):
    """(tokens on the card, lengths on the host): the first row L words,
    the last ``least``."""
    lengths = torch.randint(least, seq + 1, (rows,), generator=gen,
                            device="cuda").cpu()
    lengths[0] = seq
    lengths[-1] = least
    tokens = torch.randint(1, VOCAB, (rows, seq), generator=gen,
                           device="cuda")
    tokens = torch.where(torch.arange(seq, device="cuda")
                         < lengths.cuda()[:, None], tokens, 0)
    return tokens, lengths


@pytest.mark.parametrize("rows,seq", [(1, 18), (64, 5), (64, 18), (3, 7),
                                      (200, 18)])
def test_k9_matches_plain(cuda, rows, seq):
    rnn = encoder()
    tokens, lengths = captions(cuda, rows, seq)
    with torch.no_grad():
        before = cuda_bilstm.bilstm_cuda.launches
        got = rnn(tokens, lengths)
        torch.cuda.synchronize()
        assert cuda_bilstm.bilstm_cuda.launches == before + 1
        want = rnn.forward_masked(tokens, lengths)
        zero = rnn(tokens, torch.zeros(rows, dtype=torch.int64))
    assert not zero[0].any() and not zero[1].any()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0.0)
    words, sent = got
    lengths = lengths.cuda()
    assert not words[torch.arange(seq, device="cuda")
                     >= lengths[:, None]].any()
    assert not sent[lengths == 0].any()


def test_k9_refuses_what_it_does_not_take(cuda):
    rnn = encoder()
    tokens, lengths = captions(cuda, 4, 5)
    gates, w_hh, b_ih, b_hh = rnn._projected(tokens)
    lengths = lengths.cuda()
    with pytest.raises(ValueError):
        cuda_bilstm.bilstm_cuda(gates, lengths, (w_hh[0][:, :64],) * 2,
                                b_ih, b_hh)
    with pytest.raises(ValueError):
        cuda_bilstm.bilstm_cuda(tuple(g.double() for g in gates), lengths,
                                w_hh, b_ih, b_hh)
    with pytest.raises(ValueError):
        cuda_bilstm.bilstm_cuda(gates, lengths.cpu(), w_hh, b_ih, b_hh)


@pytest.mark.parametrize("mode", ["train", "grad"])
def test_training_keeps_cudnn(cuda, mode):
    rnn = encoder()
    tokens, lengths = captions(cuda, 8, 5, least=1)
    rnn.train(mode == "train")
    before = cuda_bilstm.bilstm_cuda.launches
    with torch.set_grad_enabled(mode == "grad"):
        rnn(tokens, lengths, generator=torch.Generator("cuda").manual_seed(0))
    assert cuda_bilstm.bilstm_cuda.launches == before


FAMILIES = {  # family -> (GanConfig fields, rows, seq, least words, eps)
    "attngan-lsun": (dict(gf_dim=32, emb_dim=256, seq_len=5), 64, 5, 5, 100),
    "attngan-cub": (dict(gf_dim=32, emb_dim=256, seq_len=18), 1, 18, 8, 100),
    "dfgan": (dict(generator="dfgan", gf_dim=32, emb_dim=256, seq_len=18),
              64, 18, 8, 256),
}


def make(cuda, family: str):
    fields, rows, seq, least, eps_dim = FAMILIES[family]
    torch.manual_seed(0)
    sampler = Sampler(InferState(GanConfig(**fields), VOCAB), device="cuda")
    tokens, lengths = captions(cuda, rows, seq, least)
    noise = torch.randn((rows, 100), generator=cuda, device="cuda")
    eps = torch.randn((rows, eps_dim), generator=cuda, device="cuda")
    return sampler, tokens, lengths, noise, eps


def flat(out) -> list:
    return [t.clone() for t in list(out[0]) + list(out[1])]


@pytest.mark.parametrize("family", ["attngan-cub", "dfgan"])
def test_replays_with_other_lengths_equal_their_eager_calls(cuda, family):
    sampler, tokens, lengths, noise, eps = make(cuda, family)
    other = lengths.clone()
    other[0] = max(int(lengths[0]) - 5, 1)        # a shorter first caption
    sampler.generate_stages(tokens, lengths, noise, eps)         # eager
    sampler.generate_stages(tokens, lengths, noise, eps)         # capture
    replayed = [flat(sampler.generate_stages(tokens, n, noise, eps))
                for n in (lengths, other)]
    counts = sampler.eager_calls, sampler.captures, sampler.replays
    assert counts == (1, 1, 3)
    with intercepting(lambda layer, x: None):       # eager, the float path
        eager = [flat(sampler.generate_stages(tokens, n, noise, eps))
                 for n in (lengths, other)]
    assert sampler.replays == 3
    for got, want in zip(replayed, eager):
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), **BF16)
    assert not torch.equal(replayed[0][0], replayed[1][0])


@pytest.mark.parametrize("family", ["attngan-lsun", "attngan-cub", "dfgan"])
def test_a_warm_replay_makes_no_blocking_call(cuda, family):
    sampler, tokens, lengths, noise, eps = make(cuda, family)
    rises = []
    for _ in range(3):                              # eager, capture, replay
        before = cuda_bilstm.bilstm_cuda.launches
        sampler.generate_stages(tokens, lengths, noise, eps)
        rises.append(cuda_bilstm.bilstm_cuda.launches - before)
    assert rises == [1, 1, 0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            sampler.generate_stages(tokens, lengths, noise, eps)
            sampler.generate_stages(tokens, lengths.numpy(), noise, eps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert sampler.replays == 2 + 6
