"""The port's generator blocks against attngan_tpu/ops/layers.py, in fp32
on the CPU, in eval and in train BatchNorm (with the running statistics
after a train forward).

Tolerance: 1e-5 absolute on outputs and statistics of order 1; the two
sides differ only in summation order (observed ~1e-7).
"""

import numpy as np
import pytest
import torch

from attngan_tpu.ops.layers import ResBlock as JaxResBlock
from attngan_tpu.ops.layers import UpBlock as JaxUpBlock
from attngan_tpu.ops.layers import glu as jax_glu
from attngan_tpu.ops.layers import upsample_nearest_2x as jax_upsample

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.ops.layers import ResBlock, UpBlock, glu, upsample_nearest_2x

ATOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _bn_vars(rng, n):
    params = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
              "bias": (rng.standard_normal(n) * 0.1).astype(np.float32)}
    stats = {"mean": (rng.standard_normal(n) * 0.1).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
    return params, stats


def _load_bn(bn, params, stats):
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"])})


def _kernel(rng, ci, co):
    return (rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci)).astype(
        np.float32)


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _run_jax(module, params, stats, x, train):
    out = module.apply({"params": params, "batch_stats": stats}, x,
                       train=train, mutable=["batch_stats"] if train else False)
    return out if train else (out, None)


def test_glu_and_upsample_match_jax(rng):
    x = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    np.testing.assert_allclose(_nhwc(glu(_nchw(x))), np.asarray(jax_glu(x)),
                               atol=ATOL)
    np.testing.assert_allclose(_nhwc(upsample_nearest_2x(_nchw(x))),
                               np.asarray(jax_upsample(x)), atol=0)


# 8^2 takes the JAX naive chain, 64^2 its dilated conv; in eval at 64^2 the
# port takes the fused route (K2; Ci=64 -> Co=32 are the serving dims),
# which on the CPU is the kernel's plain version
@pytest.mark.parametrize("hw,ci,co,mode", [
    (8, 16, 8, True), (64, 8, 4, True), (64, 8, 4, False),
    (64, 64, 32, True)])
@pytest.mark.parametrize("train", [False, True], ids=["eval_bn", "train_bn"])
def test_upblock_matches_jax(rng, hw, ci, co, mode, train):
    x = rng.standard_normal((2, hw, hw, ci)).astype(np.float32)
    kernel = _kernel(rng, ci, 2 * co)
    bn_params, bn_stats = _bn_vars(rng, 2 * co)
    params = {"kernel": kernel, "TorchBatchNorm_0": bn_params}
    stats = {"TorchBatchNorm_0": bn_stats}
    want, new = _run_jax(JaxUpBlock(co), params, stats, x, train)

    block = UpBlock(ci, co, fused_inference=mode)
    block.conv.weight.data = _oihw(kernel)
    _load_bn(block.bn, bn_params, bn_stats)
    block.train(train)
    with torch.no_grad():
        got = block(_nchw(x).contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)
    if train:
        new = new["batch_stats"]["TorchBatchNorm_0"]
        np.testing.assert_allclose(block.bn.running_mean.numpy(),
                                   np.asarray(new["mean"]), atol=ATOL)
        np.testing.assert_allclose(block.bn.running_var.numpy(),
                                   np.asarray(new["var"]), atol=ATOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval_bn", "train_bn"])
def test_resblock_matches_jax(rng, train):
    c = 8
    x = rng.standard_normal((2, 12, 10, c)).astype(np.float32)
    k0, k1 = _kernel(rng, c, 2 * c), _kernel(rng, c, c)
    (p0, s0), (p1, s1) = _bn_vars(rng, 2 * c), _bn_vars(rng, c)
    params = {"Conv_0": {"kernel": k0}, "TorchBatchNorm_0": p0,
              "Conv_1": {"kernel": k1}, "TorchBatchNorm_1": p1}
    stats = {"TorchBatchNorm_0": s0, "TorchBatchNorm_1": s1}
    want, new = _run_jax(JaxResBlock(c), params, stats, x, train)

    block = ResBlock(c)
    block.conv1.weight.data = _oihw(k0)
    block.conv2.weight.data = _oihw(k1)
    _load_bn(block.bn1, p0, s0)
    _load_bn(block.bn2, p1, s1)
    block.train(train)
    with torch.no_grad():
        got = block(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)
    if train:
        for bn, name in ((block.bn1, "TorchBatchNorm_0"),
                         (block.bn2, "TorchBatchNorm_1")):
            ref = new["batch_stats"][name]
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(ref["mean"]), atol=ATOL)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(ref["var"]), atol=ATOL)


def test_bf16_blocks_keep_the_compute_dtype(rng):
    """flax dtype semantics: the block computes and returns bf16, and the
    folded eval BN constants are cast to bf16 (ops/layers.py docstring)."""
    block = UpBlock(8, 4, dtype=torch.bfloat16).eval()
    x = torch.from_numpy(rng.standard_normal((1, 8, 4, 4)).astype(np.float32))
    assert block(x).dtype == torch.bfloat16
    assert block.conv.weight.dtype == torch.float32
    res = ResBlock(8, dtype=torch.bfloat16).eval()
    assert res(x.bfloat16()).dtype == torch.bfloat16
