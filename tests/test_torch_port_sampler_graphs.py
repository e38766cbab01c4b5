"""The serving generator's CUDA-graph path (``Sampler.replayable``), on
the CPU; tests/test_torch_cuda_graphs.py replays on the card.

- A call may replay a graph only on one CUDA device, with the generator in
  eval mode, grad off and no int8 interceptor in force: the CPU, a mesh,
  train mode, grad on and an interceptor each give the eager path.
- On the CPU every call runs eagerly, for ``Sampler`` and ``Int8Sampler``
  alike, and the counters say so.
- Where no eps is passed, the sampler draws it right after the noise, from
  the same ``torch.Generator``: the images and attention maps are those of
  ``CondAugment``'s own draw, bit for bit.
"""

import contextlib

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.core.config import GanConfig
from attngan_torch.data.dataset import word_mask
from attngan_torch.infer.quantize import Int8Sampler
from attngan_torch.infer.sampler import InferState, Sampler, denormalize
from attngan_torch.ops.int8 import intercepting
from attngan_torch.parallel.mesh import Mesh

VOCAB = 30


def make_sampler(num_stages: int = 2, cls=Sampler):
    cfg = GanConfig(gf_dim=4, emb_dim=16, seq_len=4, num_stages=num_stages,
                    compute_dtype="float32")
    torch.manual_seed(0)
    return cls(InferState(cfg, VOCAB), device="cpu")


def captions(cfg: GanConfig, rows: int = 3):
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, VOCAB, (rows, cfg.seq_len)).astype(np.int64)
    lengths = np.array([cfg.seq_len, 2, 1][:rows], np.int64)
    return tokens, lengths


def test_replayable_on_one_cuda_device_in_eval_without_grad():
    sampler = make_sampler()
    sampler.device = torch.device("cuda")   # the rule reads the device only
    with torch.no_grad():
        assert sampler.replayable()


@pytest.mark.parametrize("case", ["cpu", "mesh", "train", "grad", "int8"])
def test_each_condition_gives_the_eager_path(case):
    sampler = make_sampler()
    if case != "cpu":
        sampler.device = torch.device("cuda")
    if case == "mesh":
        sampler.mesh = Mesh((2,), 0)
    if case == "train":
        sampler.state.generator.train()
    grad = torch.enable_grad() if case == "grad" else torch.no_grad()
    quantizer = (intercepting(lambda layer, x: None) if case == "int8"
                 else contextlib.nullcontext())
    with grad, quantizer:
        assert not sampler.replayable()


@pytest.mark.parametrize("cls", [Sampler, Int8Sampler])
def test_the_cpu_runs_every_call_eagerly(cls):
    sampler = make_sampler(cls=cls)
    tokens, lengths = captions(sampler.cfg)
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        sampler.generate_stages(tokens, lengths, generator=gen)
    # Int8Sampler's first call calibrates: one more eager forward
    assert sampler.eager_calls == 3 + (cls is Int8Sampler)
    assert sampler.captures == sampler.replays == 0


@pytest.mark.parametrize("num_stages", [1, 3])
def test_eps_drawn_by_the_sampler_gives_condaugments_images(num_stages):
    sampler = make_sampler(num_stages)
    cfg = sampler.cfg
    tokens, lengths = captions(cfg)
    images, attns = sampler.generate_stages(
        tokens, lengths, generator=torch.Generator().manual_seed(5))
    # the order before the sampler drew eps: the noise, the text encoder
    # (eval: no draw), then CondAugment's draw from the same generator
    gen = torch.Generator().manual_seed(5)
    t, n = torch.as_tensor(tokens), torch.as_tensor(lengths)
    with torch.no_grad():
        noise = torch.randn((len(t), cfg.z_dim), generator=gen)
        words, sent = sampler.state.rnn(t, n)
        fakes, want_attns, _, _ = sampler.state.generator(
            noise, sent, words, word_mask(n, cfg.seq_len), generator=gen)
    want = [denormalize(f) for f in fakes]
    assert len(images) == len(want) == num_stages
    for got, ref in zip(images + attns, want + want_attns):
        assert torch.equal(got, ref)
    # and the draw matters: zero eps gives other images
    other, _ = sampler.generate_stages(tokens, lengths, noise,
                                       torch.zeros(len(t), cfg.cond_dim))
    assert not torch.equal(other[-1], images[-1])
