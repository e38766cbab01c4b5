"""The serving generator replayed as a CUDA graph (infer/sampler.py), on
the card, at the serving widths (GF 32, EMB 256, bf16, K1 and K2 on).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py

- A shape's first call runs eagerly, its second captures and replays, the
  later ones replay: over n calls 1 eager call, 1 capture, n - 1 replays,
  none falling back. Replayed images and attention maps equal the eager
  call's within one bf16 step (1e-2 absolute plus 2^-7 relative, as
  tests/test_torch_cuda_kernels.py allows), at a batch of 64 five-word
  captions and of one 18-word caption.
- A call's outputs are its own: the next call, with other inputs or at
  another shape whose graph shares the memory pool, leaves them as they
  were.
- Weights loaded in place (``load_state_dict``) reach the next replay;
  weights moved elsewhere drop the graphs, and the next call runs eagerly.
- The kernel wrappers' launch counters count the host's launches: K1 2,
  K2 2 (the resident form; none the cluster form) and K9 1 (the text
  encoder, inside the graph since it reads the lengths on the card) on the
  eager call and on the capture, nothing on a replay. The replay's own
  launches are measured instead: under torch.profiler (CUPTI) a replayed
  call runs the eager call's kernels, by name and count (memsets and
  copies aside), K1 and K2 twice.
"""

from collections import Counter

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.core.config import GanConfig
from attngan_torch.infer.sampler import InferState, Sampler
from attngan_torch.ops.int8 import intercepting
from attngan_torch.ops.cuda_attention import word_attention_cuda
from attngan_torch.ops.cuda_bilstm import bilstm_cuda
from attngan_torch.ops.cuda_upblock import upblock_fused_eval_cuda

pytestmark = pytest.mark.cuda

VOCAB = 100
SHAPES = [(64, 5), (1, 18)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.Generator("cuda").manual_seed(0)


def make_sampler(seq_len: int, seed: int = 0) -> Sampler:
    return Sampler(make_state(seq_len, seed), device="cuda")


def make_state(seq_len: int, seed: int) -> InferState:
    torch.manual_seed(seed)
    return InferState(GanConfig(gf_dim=32, emb_dim=256, seq_len=seq_len),
                      VOCAB)


def batch(gen: torch.Generator, rows: int, seq_len: int) -> tuple:
    """(tokens on the card, lengths on the host, noise, eps), as the
    benchmark's pool holds them."""
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
    return list(images) + list(attns)


def assert_close(got, want) -> None:
    assert len(flat(got)) == len(flat(want))
    for g, w in zip(flat(got), flat(want)):
        torch.testing.assert_close(g.float(), w.float(), atol=1e-2,
                                   rtol=2 ** -7)


def copies(out) -> list:
    return [t.clone() for t in flat(out)]


@pytest.mark.parametrize("rows,seq_len", SHAPES)
def test_replay_equals_the_eager_call(cuda, rows, seq_len):
    sampler = make_sampler(seq_len)
    b = batch(cuda, rows, seq_len)
    eager = sampler.generate_stages(*b)
    captured = sampler.generate_stages(*b)
    replayed = sampler.generate_stages(*b)
    assert (sampler.eager_calls, sampler.captures, sampler.replays) == (1, 1, 2)
    assert len(eager[0]) == 3 and len(eager[1]) == 2
    assert_close(captured, eager)
    assert_close(replayed, eager)


@pytest.mark.parametrize("rows,seq_len", SHAPES)
def test_n_calls_one_eager_one_capture_the_rest_replays(cuda, rows, seq_len):
    sampler = make_sampler(seq_len)
    n = 6
    for _ in range(n):
        sampler.generate_stages(*batch(cuda, rows, seq_len))
    assert sampler.eager_calls == 1
    assert sampler.captures == 1
    assert sampler.replays == n - 1


@pytest.mark.parametrize("rows,seq_len", SHAPES)
def test_a_calls_outputs_outlive_the_next_call(cuda, rows, seq_len):
    sampler = make_sampler(seq_len)
    a, b = batch(cuda, rows, seq_len), batch(cuda, rows, seq_len)
    sampler.generate_stages(*a)                     # eager
    first = sampler.generate_stages(*a)             # capture, replay
    kept = copies(first)
    second = sampler.generate_stages(*b)            # replay, other inputs
    torch.cuda.synchronize()
    for got, want in zip(flat(first), kept):
        assert torch.equal(got, want)
    assert not torch.equal(flat(second)[2], kept[2])


def test_two_shapes_share_the_pool_and_keep_their_outputs(cuda):
    sampler = make_sampler(5)
    a, b = batch(cuda, 8, 5), batch(cuda, 3, 5)
    want = {"a": sampler.generate_stages(*a), "b": sampler.generate_stages(*b)}
    for name, x in (("a", a), ("b", b)):            # the captures
        assert_close(sampler.generate_stages(*x), want[name])
    held = sampler.generate_stages(*a)
    kept = copies(held)
    for name, x in (("b", b), ("a", a), ("b", b)):
        assert_close(sampler.generate_stages(*x), want[name])
    torch.cuda.synchronize()
    for got, ref in zip(flat(held), kept):
        assert torch.equal(got, ref)
    assert (sampler.eager_calls, sampler.captures, sampler.replays) == (2, 2, 6)


def test_weights_loaded_in_place_reach_the_next_replay(cuda):
    sampler = make_sampler(5)
    b = batch(cuda, 16, 5)
    sampler.generate_stages(*b)
    before = copies(sampler.generate_stages(*b))
    other = make_state(5, seed=1)
    sampler.state.load_state_dict(other.state_dict())
    got = sampler.generate_stages(*b)
    assert (sampler.eager_calls, sampler.captures, sampler.replays) == (1, 1, 2)
    want = Sampler(other, device="cuda").generate_stages(*b)     # eager
    assert_close(got, want)
    assert not torch.equal(flat(got)[2], before[2])


def test_weights_moved_elsewhere_drop_the_graphs(cuda):
    sampler = make_sampler(5)
    b = batch(cuda, 16, 5)
    want = sampler.generate_stages(*b)
    sampler.generate_stages(*b)
    # the old storage held, so that the move cannot land where it was
    held = [t.data for t in sampler.state.generator.parameters()]
    sampler.state.cpu().cuda()
    again = sampler.generate_stages(*b)             # eager: the graph is gone
    assert (sampler.eager_calls, sampler.captures, sampler.replays) == (2, 1, 1)
    assert_close(again, want)
    assert_close(sampler.generate_stages(*b), want)  # captured anew
    assert sampler.captures == 2
    del held


def counters() -> list:
    return [upblock_fused_eval_cuda.resident_launches,
            upblock_fused_eval_cuda.cluster_launches,
            upblock_fused_eval_cuda.launches, word_attention_cuda.launches,
            bilstm_cuda.launches]


@pytest.mark.parametrize("rows,seq_len", SHAPES)
def test_launch_counters_count_the_hosts_launches(cuda, rows, seq_len):
    sampler = make_sampler(seq_len)
    b = batch(cuda, rows, seq_len)
    rises = []
    for _ in range(3):                              # eager, capture, replay
        start = counters()
        sampler.generate_stages(*b)
        rises.append([c - s for c, s in zip(counters(), start)])
    # K2 resident, K2 cluster, K2, K1, K9: a replay launches nothing from
    # the host
    assert rises == [[2, 0, 2, 2, 1], [2, 0, 2, 2, 1], [0, 0, 0, 0, 0]]
    assert sampler.replays == 2


def device_kernels(call) -> Counter:
    """{kernel name: launches} of one ``call`` on the card, by CUPTI, less
    the memsets and copies (a graph reports some of its memsets as
    kernels)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return Counter({e.key: e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation
                    and "memset" not in e.key.lower()
                    and "memcpy" not in e.key.lower()})


@pytest.mark.parametrize("rows,seq_len", SHAPES)
def test_a_replay_runs_the_eager_calls_kernels(cuda, rows, seq_len):
    sampler = make_sampler(seq_len)
    b = batch(cuda, rows, seq_len)
    sampler.generate_stages(*b)                     # eager: builds, warms
    # an interceptor that quantizes nothing: the float path, eagerly
    with intercepting(lambda layer, x: None):
        sampler.generate_stages(*b)
        eager = device_kernels(lambda: sampler.generate_stages(*b))
    sampler.generate_stages(*b)                     # capture
    replayed = device_kernels(lambda: sampler.generate_stages(*b))
    assert (sampler.eager_calls, sampler.captures, sampler.replays) == (3, 1, 2)
    mine = {k: n for k, n in replayed.items()
            if "word_attention" in k or "upblock" in k}
    assert sorted(mine.values()) == [2, 2], mine
    assert replayed == eager
