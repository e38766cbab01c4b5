"""The port's VGG19-BN features against attngan_tpu's and torchvision's
layout, on the CPU.

- The default taps (14, 24, 34, 43) at 32^2 from the same weights
  (``convert.load_vgg_flat``) equal JAX's within 1e-4, BN statistics and
  scales drawn away from the init's.
- The reference's inplace-ReLU quirk: against torchvision's own walk
  (tests/torch_oracles.py's Sequential, ``ReLU(inplace=True)``, the raw
  tensor kept after each tap's module), a BN tap reads post-ReLU and a
  conv tap pre-BN. That Sequential's state_dict, saved as a torchvision
  ``.pth`` with the classifier and BN counters, loads strictly through
  ``convert.load_torchvision_vgg19_bn``.
- Taps t and t + 1 at a BN collide and raise, as JAX's; the module stays
  frozen and in eval mode; the input takes a gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from attngan_tpu.models.vgg import VGG19BNFeatures as JaxVGG
from attngan_tpu.models.vgg import (
    _torch_module_index_plan as jax_plan,
)
from tests.torch_oracles import randomize_, t_vgg19_bn_features

from attngan_torch import convert
from attngan_torch.models.vgg import (
    DEFAULT_FEATURE_LAYERS,
    VGG19_CFG,
    VGG19BNFeatures,
    _torch_module_index_plan,
)

TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_variables(x, seed: int = 0):
    """(flat, tree): JAX VGG variables with every leaf drawn anew."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: JaxVGG().init(jax.random.key(0), x))
    flat = {}
    for key, value in traverse_util.flatten_dict(shapes, sep="/").items():
        shape, leaf = value.shape, key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            v = rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0, 0.1, shape)
        flat[key] = v.astype(np.float32)
    return flat, traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def test_plan_and_config_are_jaxs():
    assert _torch_module_index_plan() == jax_plan()
    assert DEFAULT_FEATURE_LAYERS == (14, 24, 34, 43)
    assert len(_torch_module_index_plan()) == 53 and VGG19_CFG.count("M") == 5


def test_taps_match_jax_at_32():
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    flat, tree = _jax_variables(x)
    want = jax.jit(lambda v, x: JaxVGG().apply(v, x))(tree, x)
    model = VGG19BNFeatures()
    convert.load_vgg_flat(flat, model)
    got = model(torch.as_tensor(x))
    assert [tuple(g.shape) for g in got] == [(2, 8, 8, 256), (2, 8, 8, 256),
                                             (2, 4, 4, 512), (2, 2, 2, 512)]
    for g, w, t in zip(got, want, DEFAULT_FEATURE_LAYERS):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=str(t))
    with pytest.raises(KeyError, match="unexpected VGG leaf"):
        convert.convert_vgg_flat({**flat, "params/classifier_0/kernel":
                                  np.zeros((2, 2), np.float32)})


def test_torchvision_state_dict_loads_strictly_with_the_inplace_quirk(
        tmp_path):
    seq = randomize_(t_vgg19_bn_features(), seed=31)
    sd = {f"features.{k}": v for k, v in seq.state_dict().items()}
    assert any(k.endswith("num_batches_tracked") for k in sd)
    sd.update({"classifier.0.weight": torch.zeros(4096, 25088),
               "classifier.0.bias": torch.zeros(4096)})
    path = tmp_path / "vgg19_bn.pth"
    torch.save(sd, path)
    loaded = convert.load_torchvision_vgg19_bn(str(path))
    assert not any(k.startswith("classifier") or "num_batches" in k
                   for k in loaded)
    model = VGG19BNFeatures()
    model.load_state_dict(loaded, strict=True)
    with pytest.raises(RuntimeError, match="num_batches_tracked"):
        VGG19BNFeatures().load_state_dict(
            {k: v for k, v in sd.items() if k.startswith("features")})

    x = torch.empty(2, 3, 32, 32).uniform_(
        -1, 1, generator=torch.Generator().manual_seed(132))
    with torch.no_grad():                   # the reference's walk
        out, h = {}, x
        for i, module in enumerate(seq):
            h = module(h)
            if i in DEFAULT_FEATURE_LAYERS:
                out[i] = h                  # later mutated by inplace ReLU
        want = [out[t] for t in DEFAULT_FEATURE_LAYERS]
    got = model(x.permute(0, 2, 3, 1))
    for g, w, t in zip(got, want, DEFAULT_FEATURE_LAYERS):
        np.testing.assert_allclose(g.permute(0, 3, 1, 2).numpy(), w.numpy(),
                                   **TOL, err_msg=str(t))
    assert float(want[1].min()) >= 0.0 and float(want[0].min()) < 0.0


def test_collisions_frozen_eval_and_input_gradient():
    with pytest.raises(ValueError, match="collide"):
        VGG19BNFeatures(taps=(24, 25))
    with pytest.raises(ValueError, match="collide"):
        JaxVGG(taps=(24, 25)).init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    model = VGG19BNFeatures(taps=(3, 8))
    model.train()
    assert not model.training
    assert not any(p.requires_grad for p in model.parameters())
    x = torch.zeros(1, 16, 16, 3, requires_grad=True)
    sum(f.sum() for f in model(x)).backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    assert all(p.grad is None for p in model.parameters())
