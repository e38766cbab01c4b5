"""FID: port of attngan_tpu/eval/fid.py.

Features are the 2048-d pooled activations of the DAMSM encoder's
InceptionV3Trunk (the classic FID feature space with torchvision's
weights), computed on the device in batches; the Frechet distance (a
matrix square root) runs on the host through scipy.

Without weights the trunk is seeded at random and its BatchNorm statistics
are calibrated first: in eval mode the default (0, 1) statistics do not
match the random convs' activation scale, the signal decays about 0.5x a
block and the pooled features collapse to a near constant (FID of anything
against anything ~0). One train-mode pass over 16 uniform images of 128^2
sets the running statistics to that batch's own, the unbiased variance as
BatchNorm folds it (JAX inverts the EMA for the same values). Calibrated
random features are a self-consistent relative metric; absolute FID needs
real weights. The trunk runs in bf16, the features come out in fp32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from attngan_torch.core.runtime import resolve_device
from attngan_torch.models.cnn_encoder import InceptionV3Trunk, freeze_trunk
from attngan_torch.ops.layers import BN_MOMENTUM, BatchNorm

CALIBRATION_SHAPE = (16, 128, 128, 3)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    import scipy.linalg

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    covmean = np.real(covmean)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def activation_statistics(features: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mean (D,), covariance (D, D))."""
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def calibrate_batch_norm_(trunk: torch.nn.Module,
                          images: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics of ``trunk`` to those of
    one train-mode forward over ``images`` (NHWC in [-1, 1]): the EMA of
    that forward inverted, as JAX computes it."""
    bns = [m for m in trunk.modules() if isinstance(m, BatchNorm)]
    before = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    trunk.train()
    try:
        with torch.no_grad():
            trunk(images.permute(0, 3, 1, 2))
    finally:
        trunk.eval()
    keep = 1.0 - BN_MOMENTUM
    for m, (mean, var) in zip(bns, before):
        m.running_mean.copy_((m.running_mean - keep * mean) / BN_MOMENTUM)
        m.running_var.copy_((m.running_var - keep * var) / BN_MOMENTUM)


class FIDEvaluator:
    """FID between two image sets in [-1, 1] NHWC.

    ``feature_fn``: images -> (N, D) features; by default the pooled output
    of an InceptionV3Trunk in ``dtype`` (bf16, JAX's): ``trunk_state`` (a state_dict, e.g.
    convert.load_pretrained_trunk's) as it is, or seeded from ``seed`` and
    calibrated on 16 uniform images of 128^2 from a ``torch.Generator``
    seeded ``seed + 1``; ``calibration`` (NHWC images) calibrates either
    on those images instead."""

    def __init__(self, feature_fn: Optional[Callable] = None,
                 trunk_state: Optional[Dict[str, torch.Tensor]] = None,
                 batch_size: int = 32, seed: int = 0,
                 calibration: Optional[torch.Tensor] = None,
                 device: str | torch.device | None = None,
                 dtype: torch.dtype = torch.bfloat16):
        self.batch_size = batch_size
        self.device = resolve_device(device)
        if feature_fn is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                trunk = InceptionV3Trunk(dtype)
            trunk = trunk.to(self.device).eval()
            if trunk_state is not None:
                trunk.load_state_dict(trunk_state, strict=True)
            if trunk_state is None or calibration is not None:
                if calibration is None:
                    gen = torch.Generator(self.device).manual_seed(seed + 1)
                    calibration = torch.rand(
                        CALIBRATION_SHAPE, generator=gen,
                        device=self.device) * 2.0 - 1.0
                calibrate_batch_norm_(trunk,
                                      torch.as_tensor(calibration).to(
                                          self.device))
            self.trunk = trunk
            frozen = freeze_trunk(trunk, self.device)

            def feature_fn(images: torch.Tensor) -> torch.Tensor:
                with torch.no_grad():
                    return frozen(images.permute(0, 3, 1, 2))[1].float()
        self.feature_fn = feature_fn

    def features(self, images) -> np.ndarray:
        """(N, D) fp32 host features of NHWC images, in batches."""
        out = []
        for start in range(0, len(images), self.batch_size):
            batch = torch.as_tensor(images[start:start + self.batch_size])
            out.append(self.feature_fn(batch.to(self.device).float())
                       .cpu().numpy())
        return np.concatenate(out, axis=0)

    def fid(self, real_images, fake_images) -> float:
        mu_r, sig_r = activation_statistics(self.features(real_images))
        mu_f, sig_f = activation_statistics(self.features(fake_images))
        return frechet_distance(mu_r, sig_r, mu_f, sig_f)


def int8_vs_bf16_fid(state, tokens, lengths, noise=None, eps=None,
                     seed: int = 0, real_images=None,
                     evaluator: Optional[FIDEvaluator] = None,
                     int8_percentile: float = 99.0,
                     device: str | torch.device | None = None) -> dict:
    """The int8 serving tier's quality delta in FID units: the same batch
    (tokens, lengths, and one draw of noise and eps from ``seed`` unless
    given) through Sampler and Int8Sampler. ``fid_int8_vs_float`` is the
    FID between the two generated sets (any checkpoint); with
    ``real_images`` also ``fid_float`` / ``fid_int8`` against them (a
    trained checkpoint and real data decide whether the tier ships).
    Images leave the samplers in [0, 1] and enter the trunk in [-1, 1]."""
    from attngan_torch.infer.quantize import Int8Sampler
    from attngan_torch.infer.sampler import Sampler

    dev = resolve_device(device)
    evaluator = evaluator or FIDEvaluator(device=dev)
    sampler = Sampler(state, device=dev)
    n = len(tokens)
    gen = torch.Generator(dev).manual_seed(seed)
    if noise is None:
        noise = torch.randn((n, state.cfg.z_dim), generator=gen, device=dev)
    if eps is None:
        eps = torch.randn((n, state.cfg.cond_dim), generator=gen, device=dev)
    float_imgs = sampler.generate_from_tokens(tokens, lengths, noise, eps)
    int8_imgs = Int8Sampler(state, device=dev,
                            percentile=int8_percentile).generate_from_tokens(
        tokens, lengths, noise, eps)
    trunk_range = [x * 2.0 - 1.0 for x in (float_imgs, int8_imgs)]
    out = {"fid_int8_vs_float": evaluator.fid(*trunk_range)}
    if real_images is not None:
        mu_r, sig_r = activation_statistics(evaluator.features(real_images))
        for name, imgs in zip(("float", "int8"), trunk_range):
            mu, sig = activation_statistics(evaluator.features(imgs))
            out[f"fid_{name}"] = frechet_distance(mu_r, sig_r, mu, sig)
    return out
