"""The port's spans (``attngan_torch.utils.timing.span``) on the CPU.

- A serving call under torch.profiler opens one ``attngan.serve`` holding
  ``attngan.text_encoder`` and ``attngan.generator``; the generator holds
  one ``attngan.stage<k>`` a stage, and the stages hold the UpBlocks'
  ``attngan.upblock`` ranges: four in stage 1, one in each later stage,
  on the plain chain and on the kernel route alike. ``Int8Sampler``
  inherits the tree.
- With no profiler running ``span`` returns one shared no-op context and
  never enters ``record_function``; the images are bit-identical to a
  traced call's.
- While something is being compiled ``span`` returns the no-op context
  too, profiler or not.
"""

import collections

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.core.config import GanConfig
from attngan_torch.infer.quantize import Int8Sampler
from attngan_torch.infer.sampler import InferState, Sampler
from attngan_torch.utils import timing
from attngan_torch.utils.timing import span

VOCAB = 30
CPU = [torch.profiler.ProfilerActivity.CPU]


def make_sampler(num_stages: int, fused_upsample=True, cls=Sampler):
    cfg = GanConfig(gf_dim=4, emb_dim=16, seq_len=4, num_stages=num_stages,
                    compute_dtype="float32", fused_upsample=fused_upsample)
    torch.manual_seed(0)
    return cls(InferState(cfg, VOCAB), device="cpu")


def inputs(cfg: GanConfig, rows: int = 2):
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, VOCAB, (rows, cfg.seq_len)).astype(np.int64)
    lengths = np.array([cfg.seq_len, 2][:rows], np.int64)
    noise = torch.randn(rows, cfg.z_dim,
                        generator=torch.Generator().manual_seed(1))
    eps = torch.randn(rows, cfg.cond_dim,
                      generator=torch.Generator().manual_seed(2))
    return tokens, lengths, noise, eps


def traced_call(sampler):
    with torch.profiler.profile(activities=CPU) as prof:
        out = sampler.generate_stages(*inputs(sampler.cfg))
    return out, prof.events()


def span_tree(events) -> collections.Counter:
    """(span, its nearest enclosing span) -> how many."""
    tree = collections.Counter()
    for ev in events:
        if not ev.name.startswith("attngan."):
            continue
        parent = ev.cpu_parent
        while parent is not None and not parent.name.startswith("attngan."):
            parent = parent.cpu_parent
        tree[ev.name, None if parent is None else parent.name] += 1
    return tree


def expected_tree(num_stages: int) -> collections.Counter:
    tree = collections.Counter({
        ("attngan.serve", None): 1,
        ("attngan.text_encoder", "attngan.serve"): 1,
        ("attngan.generator", "attngan.serve"): 1,
        ("attngan.upblock", "attngan.stage1"): 4,
    })
    for k in range(1, num_stages + 1):
        tree[f"attngan.stage{k}", "attngan.generator"] = 1
    for k in range(2, num_stages + 1):
        tree["attngan.upblock", f"attngan.stage{k}"] = 1
    return tree


@pytest.mark.parametrize("fused_upsample", [True, False],
                         ids=["kernel_route", "plain_chain"])
@pytest.mark.parametrize("num_stages", [1, 2, 3])
def test_a_serving_call_opens_the_layer_tree(num_stages, fused_upsample):
    _, events = traced_call(make_sampler(num_stages, fused_upsample))
    tree = span_tree(events)
    assert tree == expected_tree(num_stages)
    assert sum(tree.values()) == 6 + 2 * num_stages     # 12 at 3 stages


def test_int8_sampler_inherits_the_tree():
    sampler = make_sampler(2, cls=Int8Sampler)
    sampler.generate_stages(*inputs(sampler.cfg))      # calibrates
    _, events = traced_call(sampler)
    assert span_tree(events) == expected_tree(2)


def test_no_profiler_no_range_and_the_same_bits(monkeypatch):
    sampler = make_sampler(2)
    (traced, traced_attn), _ = traced_call(sampler)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("attngan.serve") is timing._NO_SPAN
    images, attns = sampler.generate_stages(*inputs(sampler.cfg))
    for a, b in zip(images + attns, traced + traced_attn):
        assert torch.equal(a, b)


def test_no_range_while_compiling(monkeypatch):
    with torch.profiler.profile(activities=CPU):
        assert isinstance(span("attngan.serve"),
                          torch.profiler.record_function)
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        assert span("attngan.serve") is timing._NO_SPAN
    assert span("attngan.serve") is timing._NO_SPAN
