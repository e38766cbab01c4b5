"""The port's public surface against the JAX package's, on the CPU.

- Every subpackage exports JAX's names (``__all__``), less the JAX-only
  ones, plus the port's replacements for them; ``from ... import *``
  works for each. Both lists are written out below.
- ``DataConfig``, ``solve_conv_params`` (every in / out size in 1..64),
  ``conv1x1`` and ``conv_for_output`` (against flax's ``nn.Conv`` on the
  same weights, fp32, 1e-5), ``utils.training.calculate_out_hw``,
  ``models.cnn_encoder.BN_MOMENTUM`` and ``__version__`` match JAX's.
- ``timer`` prints and returns its function's result; ``device_timeit``
  returns seconds a call, folds each output as it is told, and raises on a
  non-finite accumulator.
"""

import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import attngan_tpu
from attngan_tpu.core import config as jax_config
from attngan_tpu.models import cnn_encoder as jax_cnn_encoder
from attngan_tpu.ops import layers as jax_layers

import torch_threads  # noqa: F401  (torch threads under xdist)
import attngan_torch
from attngan_torch.core.config import DataConfig
from attngan_torch.models import cnn_encoder
from attngan_torch.ops import layers
from attngan_torch.utils import training
from attngan_torch.utils.timing import device_timeit, timer

SUBPACKAGES = ("core", "data", "eval", "infer", "losses", "models", "ops",
               "parallel", "train", "utils")
# JAX names with no counterpart in the port: orbax's converted-weights
# loader, jax.sharding's mesh helpers, and a block on XLA's async dispatch
JAX_ONLY = {
    "train": {"load_converted"},
    "parallel": {"DATA_AXIS", "SLICE_AXIS", "batch_axes", "batch_sharding",
                 "make_mesh_for_batch", "replicate", "replicated",
                 "shard_batch"},
    "utils": {"block"},
}
# the port's replacements: the ranks' mesh, a rank's rows, the process group
PORT_ONLY = {
    "parallel": {"mesh_size_for_batch", "shard_rows", "init_distributed",
                 "launched"},
}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_match_jax(sub):
    port = importlib.import_module(f"attngan_torch.{sub}")
    jax_sub = importlib.import_module(f"attngan_tpu.{sub}")
    want = (set(jax_sub.__all__) - JAX_ONLY.get(sub, set())
            | PORT_ONLY.get(sub, set()))
    assert set(port.__all__) == want
    assert len(port.__all__) == len(want)
    namespace = {}
    exec(f"from attngan_torch.{sub} import *", namespace)
    assert want <= set(namespace)
    assert all(namespace[name] is getattr(port, name) for name in want)


def test_version_matches_jax():
    assert attngan_torch.__version__ == attngan_tpu.__version__


def test_data_config_matches_jax():
    def fields(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert fields(DataConfig) == fields(jax_config.DataConfig)
    with pytest.raises(dataclasses.FrozenInstanceError):
        DataConfig().rootdir = "x"


def _solve(fn, in_hw, out_hw, limits):
    try:
        return fn(in_hw, out_hw, **limits)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("in_range,limits", [
    (range(1, 17), {}), (range(17, 33), {}), (range(33, 49), {}),
    (range(49, 65), {}),
    (range(1, 65), dict(max_kern=7, max_stride=2, max_pad=1)),
], ids=["1-16", "17-32", "33-48", "49-64", "limits"])
def test_solve_conv_params_matches_jax(in_range, limits):
    raised = 0
    for in_hw in in_range:
        for out_hw in range(1, 65):
            got = _solve(layers.solve_conv_params, in_hw, out_hw, limits)
            assert got == _solve(jax_layers.solve_conv_params, in_hw, out_hw,
                                 limits), (in_hw, out_hw)
            raised += got[0] == "ValueError"
    assert 0 < raised < len(in_range) * 64


@pytest.mark.parametrize("make", [
    ("conv1x1", dict(), lambda: layers.conv1x1(6, 5),
     lambda: jax_layers.conv1x1(5)),
    ("conv1x1_bias", dict(), lambda: layers.conv1x1(6, 5, bias=True),
     lambda: jax_layers.conv1x1(5, use_bias=True)),
    ("down", dict(in_hw=17, out_hw=8),
     lambda: layers.conv_for_output(6, 5, 17, 8),
     lambda: jax_layers.conv_for_output(5, 17, 8)),
    ("up_bias", dict(in_hw=8, out_hw=9),
     lambda: layers.conv_for_output(6, 5, 8, 9, bias=True),
     lambda: jax_layers.conv_for_output(5, 8, 9, use_bias=True)),
    ("limits", dict(in_hw=17, out_hw=9),
     lambda: layers.conv_for_output(6, 5, 17, 9, max_stride=2),
     lambda: jax_layers.conv_for_output(5, 17, 9, max_stride=2)),
], ids=lambda m: m[0])
def test_conv_layers_match_flax(make):
    _, hw, port_fn, jax_fn = make
    in_hw = hw.get("in_hw", 11)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, in_hw, in_hw, 6)).astype(np.float32)
    conv = jax_fn()
    params = jax.jit(conv.init)(jax.random.key(0), jnp.asarray(x))["params"]
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    port = port_fn()
    state = {"weight": torch.from_numpy(np.ascontiguousarray(
        np.asarray(params["kernel"]).transpose(3, 2, 0, 1)))}
    if "bias" in params:
        state["bias"] = torch.from_numpy(np.array(params["bias"]))
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert want.shape[1] == hw.get("out_hw", in_hw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)


def test_calculate_out_hw_is_the_layers_function():
    assert training.calculate_out_hw is layers.calculate_out_hw
    assert training.calculate_out_hw(299, 3, 2) == \
        jax_layers.calculate_out_hw(299, 3, 2) == 149


def test_bn_momentum_is_pytorchs_form_of_jaxs():
    assert cnn_encoder.BN_MOMENTUM == layers.BN_MOMENTUM == 0.1
    assert cnn_encoder.BN_MOMENTUM == pytest.approx(
        1 - jax_cnn_encoder.BN_MOMENTUM)


def test_timer_prints_and_returns_the_result(capsys):
    @timer
    def double(x, k=2):
        return {"y": [x * k]}

    out = double(torch.ones(3), k=3)
    assert torch.equal(out["y"][0], torch.full((3,), 3.0))
    assert double.__name__ == "double"
    assert capsys.readouterr().out.startswith("[timer] double: ")


def test_device_timeit_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2, x

    x = torch.arange(4.0) + 1
    seconds = device_timeit(fn, x, iters=5, warmup=2)
    assert math.isfinite(seconds) and seconds > 0 and len(calls) == 7
    folded = []
    device_timeit(fn, x, iters=3, warmup=0,
                  fold=lambda out: folded.append(out) or out[1].sum())
    assert len(folded) == 3 and torch.equal(folded[0][0], x * 2)
    with pytest.raises(RuntimeError, match="non-finite"):
        device_timeit(lambda: torch.tensor([math.nan]), iters=2)
    with pytest.raises(RuntimeError, match="non-finite"):
        device_timeit(fn, x, iters=2, fold=lambda out: out[0].sum() * math.inf)
