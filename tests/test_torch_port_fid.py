"""The port's FID (attngan_torch/eval/fid.py) against attngan_tpu/eval/fid.py.

- ``frechet_distance`` and ``activation_statistics``: the same numpy /
  scipy arithmetic, held at 1e-9 relative.
- The default featurizer's calibration: JAX's FIDEvaluator (a random
  Inception trunk, its BatchNorm statistics calibrated on 16 uniform
  images of 128^2) beside the port's with JAX's weights and JAX's
  calibration batch, both trunks in fp32 (JAX's bf16 swapped for fp32 in
  its module for the test): every running mean within 1e-3 and variance
  within 1e-3 relative of JAX's (observed 3.8e-5 / 1.1e-4 at the worst of
  the 94 BNs, Mixed_7c), the pooled features within 3e-4 of their scale
  (observed 3.6e-5); a statistic left uncalibrated is off by ~100%. In
  bf16, both sides' default, each conv rounds to 8 bits of mantissa in
  another order than the other side's, and train-mode BN carries each
  block's rounding into the next block's statistics: the first BN agrees to
  1.3e-4, Mixed_6b to 1%, Mixed_7c to 26% (measured on the CPU), so bf16
  is not the comparison.
- FID orders near-real images below noise (cheap features, as JAX's
  test); the default featurizer's features do not collapse;
  ``int8_vs_bf16_fid`` reports a finite int8 shift far below the distance
  to unrelated images.
"""

import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from attngan_tpu.eval import fid as jax_fid

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.convert import block_state_dict
from attngan_torch.core.config import GanConfig
from attngan_torch.eval.fid import (
    FIDEvaluator,
    activation_statistics,
    frechet_distance,
    int8_vs_bf16_fid,
)
from attngan_torch.infer.sampler import InferState
from attngan_torch.ops.layers import BatchNorm

STAT_TOL = 1e-3
FEATURE_RTOL = 3e-4


@pytest.mark.parametrize("n", [40, 8], ids=["full_rank", "rank_deficient"])
def test_frechet_distance_and_statistics_match_jax(n):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, 16))
    b = rng.standard_normal((n, 16)) * 1.5 + 0.3
    want = [jax_fid.activation_statistics(x) for x in (a, b)]
    got = [activation_statistics(x) for x in (a, b)]
    for (gm, gs), (wm, ws) in zip(got, want):
        np.testing.assert_allclose(gm, wm, rtol=1e-9)
        np.testing.assert_allclose(gs, ws, rtol=1e-9)
    assert frechet_distance(*got[0], *got[1]) == pytest.approx(
        jax_fid.frechet_distance(*want[0], *want[1]), rel=1e-9)
    assert abs(frechet_distance(*got[0], *got[0])) < 1e-6


@pytest.fixture(scope="module")
def featurizers():
    """JAX's default FIDEvaluator and the port's with JAX's weights and
    calibration batch (JAX's own draw for seed 0), both in fp32."""
    fp32 = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                    if not n.startswith("__")})
    fp32.bfloat16 = jnp.float32
    real_jnp, jax_fid.jnp = jax_fid.jnp, fp32
    try:
        want = jax_fid.FIDEvaluator(batch_size=4)
    finally:
        jax_fid.jnp = real_jnp
    variables = inspect.getclosurevars(
        want.feature_fn.__wrapped__).nonlocals["variables"]
    params = traverse_util.flatten_dict(variables["params"], sep="/")
    stats = traverse_util.flatten_dict(variables["batch_stats"], sep="/")
    init = {k: np.zeros_like(v) if k.endswith("mean") else np.ones_like(v)
            for k, v in stats.items()}
    calibration = np.array(jax.random.uniform(
        jax.random.key(1), (16, 128, 128, 3), minval=-1.0, maxval=1.0))
    got = FIDEvaluator(trunk_state=block_state_dict(params, init),
                       calibration=torch.from_numpy(calibration),
                       batch_size=4, device="cpu", dtype=torch.float32)
    return want, got, block_state_dict({}, stats)


def test_featurizer_calibration_matches_jax(featurizers):
    want, got, calibrated = featurizers
    port = got.trunk.state_dict()
    bns = [n for n, m in got.trunk.named_modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 94
    for name in bns:
        for stat in ("running_mean", "running_var"):
            w = calibrated[f"{name}.{stat}"].numpy()
            g = port[f"{name}.{stat}"].numpy()
            tol = dict(atol=STAT_TOL) if stat == "running_mean" else \
                dict(rtol=STAT_TOL)
            np.testing.assert_allclose(g, w, **tol, err_msg=f"{name}.{stat}")
    images = np.random.default_rng(1).uniform(
        -1, 1, (4, 64, 64, 3)).astype(np.float32)
    f_want, f_got = want.features(images), got.features(images)
    assert f_got.dtype == np.float32 and f_got.shape == (4, 2048)
    scale = float(np.abs(f_want).max())
    np.testing.assert_allclose(f_got, f_want, atol=FEATURE_RTOL * scale)


def test_the_default_featurizer_does_not_collapse():
    """The port's own seeded, calibrated featurizer, in bf16: per-image
    features that differ (uncalibrated they collapse to a constant)."""
    ev = FIDEvaluator(batch_size=8, device="cpu")
    assert ev.trunk.dtype == torch.bfloat16
    feats = ev.features(np.random.default_rng(2).uniform(
        -1, 1, (8, 64, 64, 3)).astype(np.float32))
    assert feats.dtype == np.float32
    assert float(feats.std()) > 0.1, "featurizer collapsed to a constant"
    assert float(np.std(feats.mean(axis=1))) > 1e-3, "no per-image signal"


def test_fid_orders_near_real_below_noise():
    rng = np.random.default_rng(4)
    ev = FIDEvaluator(feature_fn=lambda x: x.mean(dim=(1, 2)), batch_size=8,
                      device="cpu")
    real = rng.standard_normal((32, 8, 8, 3)).astype(np.float32)
    near = real + rng.standard_normal(real.shape).astype(np.float32) * 0.05
    far = rng.standard_normal(real.shape).astype(np.float32) * 3 + 2
    assert abs(ev.fid(real, real)) < 1e-6
    assert ev.fid(real, near) < ev.fid(real, far)


def test_int8_vs_bf16_fid_harness():
    torch.manual_seed(0)
    cfg = GanConfig(gf_dim=8, emb_dim=32, seq_len=4, num_stages=2,
                    compute_dtype="float32")
    state = InferState(cfg, 30)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 30, (8, cfg.seq_len)).astype(np.int32)
    lengths = np.full((8,), cfg.seq_len, np.int32)
    feature_fn = lambda x: torch.cat([x.mean(dim=(1, 2)),
                                      x.std(dim=(1, 2))], dim=-1)
    ev = FIDEvaluator(feature_fn=feature_fn, batch_size=8, device="cpu")
    real = rng.standard_normal((8, 128, 128, 3)).astype(np.float32)
    out = int8_vs_bf16_fid(state, tokens, lengths, seed=3, real_images=real,
                           evaluator=ev, device="cpu")
    assert set(out) == {"fid_int8_vs_float", "fid_float", "fid_int8"}
    assert all(np.isfinite(v) for v in out.values()), out
    assert 0 <= out["fid_int8_vs_float"] < 0.1 * out["fid_float"], out
