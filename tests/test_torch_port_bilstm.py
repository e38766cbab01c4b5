"""K9, the text encoder's masked BiLSTM (ops/cuda_bilstm.py), on the CPU:
its plain version against the packed ``nn.LSTM`` path, which form
``BiLSTMEncoder.forward`` takes, and the sampler's host inputs.

- The plain version (what ``bilstm_cuda`` runs for CPU tensors, and
  ``forward_masked``) against the packed eval ``forward`` at the serving
  width (300 -> 2 x 128), at rows {1, 3, 64} and seq {5, 18}, with
  lengths all 0, all 1, a mix (from 3 rows on with 0 and L in it) and
  all L. fp32: 1e-5 absolute (the same function, the projection and the
  recurrence's sums in other orders over up to 18 steps; outputs lie in
  (-1, 1)); padded steps and empty rows exactly zero.
- The route: K9 on a CUDA device in eval mode with grad off at 128 units
  a direction in fp32; the CPU, train mode, grad on, another width or
  another type keep the packed path, and a CPU forward never reaches the
  kernel's counter. With the route forced and the kernel stood in by its
  plain version, ``forward`` hands it the projections, the weights and
  the lengths, and returns what the packed path does.
- The sampler: the eager CPU path gives the same images with the lengths
  as a list, a numpy array or a CPU tensor (and tokens likewise);
  ``core.runtime.to_device`` puts host data where it is asked, or into a
  given buffer; a moved text encoder drops the sampler's graphs as a moved
  generator does, because the graphs now read both.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.core.config import GanConfig
from attngan_torch.core.runtime import to_device
from attngan_torch.infer.sampler import InferState, Sampler
from attngan_torch.models.rnn_encoder import BiLSTMEncoder
from attngan_torch.ops import cuda_bilstm

VOCAB = 200
ATOL = 1e-5


def encoder(seed: int = 0, hidden_dim: int = 256) -> BiLSTMEncoder:
    torch.manual_seed(seed)
    rnn = BiLSTMEncoder(VOCAB, hidden_dim=hidden_dim).eval()
    with torch.no_grad():           # a trained bias_hh is zero; K9 reads it
        rnn.lstm.bias_hh_l0.normal_(0.0, 0.1)
        rnn.lstm.bias_hh_l0_reverse.normal_(0.0, 0.1)
    return rnn


def captions(rows: int, seq: int, kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    mix = np.concatenate([[seq // 2 + 1, 0, seq, 1],
                          rng.integers(0, seq + 1, max(rows - 4, 0))])
    lengths = {"zero": np.zeros(rows), "one": np.ones(rows),
               "full": np.full(rows, seq), "mix": mix[:rows]}[kind]
    lengths = torch.as_tensor(lengths, dtype=torch.int64)
    tokens = torch.as_tensor(rng.integers(1, VOCAB, (rows, seq)))
    tokens = torch.where(torch.arange(seq) < lengths[:, None], tokens, 0)
    return tokens, lengths


@pytest.mark.parametrize("kind", ["zero", "one", "mix", "full"])
@pytest.mark.parametrize("seq", [5, 18])
@pytest.mark.parametrize("rows", [1, 3, 64])
def test_plain_version_equals_the_packed_forward(rows, seq, kind):
    rnn = encoder()
    tokens, lengths = captions(rows, seq, kind)
    with torch.no_grad():
        want = rnn(tokens, lengths)
        gates, w_hh, b_ih, b_hh = rnn._projected(tokens)
        got = cuda_bilstm.bilstm_cuda(gates, lengths, w_hh, b_ih, b_hh)
        masked = rnn.forward_masked(tokens, lengths)
    for g, m, w in zip(got, masked, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0.0)
        assert torch.equal(g, m)
    words, sent = got
    padded = torch.arange(seq) >= lengths[:, None]
    assert not words[padded].any()
    assert not sent[lengths == 0].any()


ROUTES = [  # (device, training, grad, hidden_dim, dtype) -> takes K9
    (("cuda", False, False, 256, torch.float32), True),
    (("cuda:0", False, False, 256, torch.float32), True),
    (("cpu", False, False, 256, torch.float32), False),
    (("cuda", True, False, 256, torch.float32), False),
    (("cuda", False, True, 256, torch.float32), False),
    (("cuda", False, False, 24, torch.float32), False),
    (("cuda", False, False, 512, torch.float32), False),
    (("cuda", False, False, 256, torch.float64), False),
]


@pytest.mark.parametrize("case,want", ROUTES)
def test_the_route_by_device_mode_grad_and_width(case, want):
    device, training, grad, hidden_dim, dtype = case
    rnn = BiLSTMEncoder(VOCAB, hidden_dim=hidden_dim).to(dtype)
    rnn.train(training)
    with torch.set_grad_enabled(grad):
        assert rnn.kernel_route(torch.device(device)) is want


@pytest.mark.parametrize("training", [False, True])
def test_the_cpu_never_reaches_the_kernel(training):
    rnn = encoder()
    rnn.train(training)
    tokens, lengths = captions(3, 5, "mix")
    before = cuda_bilstm.bilstm_cuda.launches
    with torch.no_grad():
        rnn(tokens, lengths, generator=torch.Generator().manual_seed(0))
    assert cuda_bilstm.bilstm_cuda.launches == before


def test_the_kernel_route_hands_k9_its_operands(monkeypatch):
    rnn = encoder()
    tokens, lengths = captions(3, 18, "mix")
    with torch.no_grad():
        want = rnn(tokens, lengths)
    calls = []

    def stand_in(gates, lengths, w_hh, b_ih, b_hh):
        calls.append((gates, lengths, w_hh, b_ih, b_hh))
        return cuda_bilstm.bilstm(gates, lengths, w_hh, b_ih, b_hh)

    monkeypatch.setattr(cuda_bilstm, "bilstm_cuda", stand_in)
    monkeypatch.setattr(BiLSTMEncoder, "kernel_route", lambda self, d: True)
    with torch.no_grad():
        got = rnn(tokens, lengths.tolist())         # host lengths as a list
    assert len(calls) == 1
    gates, given, w_hh, b_ih, b_hh = calls[0]
    assert [g.shape for g in gates] == [(3, 18, 512)] * 2
    assert torch.equal(given, lengths)
    lstm = rnn.lstm
    assert w_hh[0] is lstm.weight_hh_l0
    assert w_hh[1] is lstm.weight_hh_l0_reverse
    assert b_ih[1] is lstm.bias_ih_l0_reverse and b_hh[0] is lstm.bias_hh_l0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0.0)


def make_sampler() -> Sampler:
    cfg = GanConfig(gf_dim=4, emb_dim=16, seq_len=5, num_stages=2,
                    compute_dtype="float32")
    torch.manual_seed(0)
    return Sampler(InferState(cfg, VOCAB), device="cpu")


@pytest.mark.parametrize("form", ["list", "numpy", "tensor"])
def test_the_sampler_takes_host_lengths_in_any_form(form):
    sampler = make_sampler()
    tokens, lengths = captions(4, 5, "mix")
    noise = torch.randn(4, sampler.cfg.z_dim)
    eps = torch.randn(4, sampler.cfg.cond_dim)
    want = sampler.generate_stages(tokens, lengths, noise, eps)
    convert = {"list": lambda t: t.tolist(), "numpy": lambda t: t.numpy(),
               "tensor": lambda t: t.clone()}[form]
    got = sampler.generate_stages(convert(tokens), convert(lengths), noise,
                                  eps)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
    assert sampler.eager_calls == 2


def test_to_device_on_the_host_and_into_a_buffer():
    got = to_device([[1, 2], [3, 4]], "cpu")
    assert got.device.type == "cpu" and got.dtype == torch.int64
    assert got.tolist() == [[1, 2], [3, 4]]
    out = torch.zeros(2, 2, dtype=torch.int64)
    assert to_device(np.array([[5, 6], [7, 8]]), "cpu", out=out) is out
    assert out.tolist() == [[5, 6], [7, 8]]
    t = torch.arange(3)
    assert to_device(t, torch.device("cpu")) is t


@pytest.mark.parametrize("moved", ["rnn", "generator"])
def test_a_moved_text_encoder_or_generator_drops_the_graphs(moved):
    sampler = make_sampler()
    sampler._drop_moved_graphs()
    sampler._graphs[("a shape",)] = "warm"
    sampler._drop_moved_graphs()                    # nothing moved
    assert ("a shape",) in sampler._graphs
    first = next(getattr(sampler.state, moved).parameters())
    first.data = first.data.clone()                 # a new address
    sampler._drop_moved_graphs()
    assert not sampler._graphs
