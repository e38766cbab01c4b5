"""K8, the eval BatchNorm epilogue (ops/cuda_bn_epilogue.py), on the CPU:
its plain version against the chain it replaces, and where ops/layers.py
routes the generator's BatchNorm -> GLU and BatchNorm -> residual sites.

- The plain version against ``glu(bn.eval()(x))`` and ``bn.eval()(x) +
  skip``. fp32: 1e-6 relative (the same operations; PyTorch's sigmoid may
  take another code path on the chain's strided half). bf16: the plain
  version rounds once, so it lies within half a bf16 step of the fp64
  result (plus 2^-20 of the largest value it sums, fp32's own rounding
  where the sum cancels); the chain rounds five times, each half a step
  (k and b cast to bf16, the product, the sum, the GLU's product or the
  residual add, besides the sigmoid), so the two lie within 3 bf16 steps
  at the largest magnitude the chain rounds (|x k|, |x k + b|, |skip|).
- Routing: CPU tensors keep the chain (and never reach the kernel's
  counter). With the kernel stood in by its plain version, which the CPU
  can run, the 3-stage generator's eval forward under no_grad takes it at
  13 sites (InitialStage, the four 4^2 -> 64^2 UpBlocks, each ResBlock's
  two) and computes what the chain does; train mode, grad on, the plain
  path (fused_upsample off), the exported program (infer/export.py, the
  plain path) and an int8 site's fp32 output (InitialStage's mixed types)
  keep the chain.
- The bf16 generator with the kernel's arithmetic at its sites holds
  tests/test_torch_port_bf16.py's bar against JAX's bf16 generator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_port_bf16 import (  # noqa: F401  (``inputs`` is a fixture)
    EVAL_MAX,
    EVAL_MEAN,
    _jax_images,
    _port_images,
    inputs,
)

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.core.config import GanConfig
from attngan_torch.infer.export import export_sampler
from attngan_torch.infer.sampler import InferState
from attngan_torch.models.generator import Generator
from attngan_torch.ops import layers
from attngan_torch.ops.cuda_bn_epilogue import bn_epilogue, bn_epilogue_cuda
from attngan_torch.ops.int8 import intercepting
from attngan_torch.ops.layers import BatchNorm, glu

TOL = dict(atol=1e-7, rtol=1e-6)     # fp32


def _bn(c: int, seed: int = 0) -> BatchNorm:
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c).eval()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0.0, 0.1, generator=g)
        bn.running_mean.normal_(0.0, 0.5, generator=g)
        bn.running_var.uniform_(0.5, 1.5, generator=g)
    return bn


def _nchw(shape, dtype, seed):
    """(B, C, H, W) in channels_last memory, or (B, C) for H = W = 0."""
    b, h, w, c = shape
    g = torch.Generator().manual_seed(seed)
    x = 2 * torch.randn((b, c) if h == 0 else (b, h, w, c), generator=g)
    if h:
        x = x.permute(0, 3, 1, 2)
    return x.to(dtype)


def _nhwc(t):
    return t if t.dim() == 2 else t.permute(0, 2, 3, 1)


SHAPES = [(2, 4, 4, 64), (1, 3, 5, 16), (3, 0, 0, 256), (2, 8, 8, 32)]


def _step(t):
    """The bf16 spacing at |t|."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -100)))
                      - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("form", ["glu", "residual"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_version_equals_the_chain(shape, form, dtype):
    x = _nchw(shape, dtype, 1)
    skip = _nchw(shape, dtype, 2) if form == "residual" else None
    bn = _bn(shape[-1])
    vectors = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    with torch.no_grad():
        want = glu(bn(x)) if skip is None else bn(x) + skip
        got = bn_epilogue(_nhwc(x), *vectors, bn.eps,
                          None if skip is None else _nhwc(skip))
    want = _nhwc(want).double()
    assert got.dtype == dtype and got.shape == want.shape
    got = got.double()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
        return
    c = shape[-1] // (2 if skip is None else 1)
    xs = [_nhwc(t).double() for t in (x, skip) if t is not None]
    exact = bn_epilogue(xs[0], *(t.double() for t in vectors), bn.eps,
                        xs[1] if len(xs) > 1 else None)
    k, b = (t.double()[:c] for t in bn.fold())
    x_k = xs[0][..., :c] * k
    scale = torch.maximum(x_k.abs(), (x_k + b).abs())
    if skip is not None:
        scale = torch.maximum(scale, xs[1].abs())
    assert bool(((got - exact).abs()
                 <= 0.5 * _step(exact) + 2.0 ** -20 * scale).all())
    assert bool(((got - want).abs() <= 3 * _step(scale)).all())


@pytest.mark.parametrize("form", ["glu", "residual"])
def test_cpu_tensors_keep_the_chain(form):
    x = _nchw((2, 4, 4, 32), torch.bfloat16, 3)
    skip = _nchw((2, 4, 4, 32), torch.bfloat16, 4)
    bn = _bn(32)
    before = bn_epilogue_cuda.launches
    with torch.no_grad():
        if form == "glu":
            got, want = bn.forward_glu(x, fused=True), glu(bn(x))
        else:
            got, want = bn.forward_add(x, skip, fused=True), bn(x) + skip
    assert bn_epilogue_cuda.launches == before
    assert torch.equal(got, want)


def test_the_wrapper_runs_the_plain_version_for_cpu_tensors():
    x = _nchw((2, 4, 4, 16), torch.float32, 5)
    bn = _bn(16)
    vectors = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    with torch.no_grad():
        got = bn_epilogue_cuda(_nhwc(x), *vectors, bn.eps)
        want = bn_epilogue(_nhwc(x), *vectors, bn.eps)
    assert torch.equal(got, want)


@pytest.fixture
def stand_in(monkeypatch):
    """``stand_in()`` puts the kernel's plain version in its place in
    ops/layers.py, with every operand taken, so that the sites route on
    the CPU as on the card; it returns the list of the stand-in's calls
    (x's shape, whether residual)."""
    calls = []

    def kernel(x, *args):
        calls.append((tuple(x.shape), len(args) == 6))
        return bn_epilogue(x, *args)

    def put():
        monkeypatch.setattr(layers, "takes", lambda *args: True)
        monkeypatch.setattr(layers, "bn_epilogue_cuda", kernel)
        return calls
    return put


def _generator(dtype="float32", fused=True, seed=0):
    torch.manual_seed(seed)
    gen = Generator(gf_dim=4, emb_dim=16, dtype=getattr(torch, dtype),
                    fused_attention=fused, fused_upsample=fused)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in gen.named_buffers():
            if name.endswith("running_mean"):
                t.normal_(0.0, 0.3, generator=g)
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=g)
    return gen.eval()


def _inputs(rows=2, words=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones((rows, words), dtype=torch.int32)
    mask[1, 3:] = 0
    return (torch.randn((rows, 100), generator=g),
            torch.randn((rows, 16), generator=g),
            torch.randn((rows, words, 16), generator=g), mask,
            torch.randn((rows, 100), generator=g))


def _images(gen, args):
    fakes, attns, _, _ = gen(*args[:4], eps=args[4])
    return fakes + attns


def test_the_generator_takes_the_kernel_at_13_sites(stand_in):
    gen, args = _generator(), _inputs()
    with torch.no_grad():
        want = _images(gen, args)                  # CPU tensors: the chain
        calls = stand_in()
        got = _images(gen, args)
    glu_sites = [s for s, residual in calls if not residual]
    assert len(calls) == 13 and len(glu_sites) == 9
    assert glu_sites[0] == (2, 4 * 4 * 16 * 4 * 2)   # InitialStage, (B, C)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("where", ["train", "grad", "plain", "export",
                                   "int8_mixed"])
def test_the_chain_stays_where_the_kernel_cannot_go(stand_in, where):
    gen, args, calls = _generator("bfloat16"), _inputs(), stand_in()
    if where == "train":
        with torch.no_grad():
            _images(gen.train(), args)
        assert calls == []
    elif where == "grad":
        _images(gen, args)
        assert calls == []
    elif where == "plain":
        with torch.no_grad():
            _images(_generator("bfloat16", fused=False), args)
        assert calls == []
    elif where == "export":
        torch.manual_seed(0)
        state = InferState(GanConfig(gf_dim=4, emb_dim=16, seq_len=4,
                                     num_stages=2), 30)
        program = export_sampler(state, platforms=("cpu",), batch_size=2)
        assert calls == []
        ops = {str(n.target) for n in program["cpu"].graph.nodes}
        assert any("sigmoid" in op for op in ops)
    else:
        # an int8 site's output keeps its fp32 input's type: InitialStage's
        # BN then computes in fp32 and casts, as JAX's does
        def fc_in_fp32(layer, x):
            if layer is gen.gen1.fc:
                return F.linear(x.float(), layer.weight)
            return None

        with torch.no_grad(), intercepting(fc_in_fp32):
            _images(gen, args)
        assert len(calls) == 12
        assert all(len(shape) == 4 for shape, _ in calls)


def test_bf16_generator_with_the_kernels_arithmetic_matches_jax(
        stand_in, inputs):  # noqa: F811
    calls = stand_in()
    got = _port_images(inputs, train=False)
    assert len(calls) == 9          # 2 stages: 1 + 4 + 2 ResBlocks x 2
    want = _jax_images(inputs, jnp.bfloat16, train=False)
    for res, g, w in zip((64, 128), got, want):
        err = np.abs(g - w)
        assert err.max() <= EVAL_MAX and err.mean() <= EVAL_MEAN, \
            (res, err.max(), err.mean())
