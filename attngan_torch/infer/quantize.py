"""Post-training int8 quantization: port of attngan_tpu/infer/quantize.py.

Classic symmetric quantization, JAX's method step for step:

* **Sites**: the input of every Conv / Dense that JAX's flax interceptor
  reaches, keyed by JAX's module path. Plain convs only (``quantizable``);
  JAX never intercepts a conv computed on a raw kernel param, so these
  stay float: the UpBlock's conv (in the port K2, or the plain chain), the
  Inception trunk's sibling 1x1 heads in eval mode (29 of its 94 convs,
  ``FUSED_SIBLINGS``) and the trunk's average pool (a depthwise conv in
  the port). ``generator_sites`` and ``trunk_sites`` hold the rule.
* **Weights**: per output channel, ``sw = max(max|w|, 1e-12) / 127``,
  quantized once when a ``Quantizer`` is built (ops/int8.py::Int8Site).
* **Activations**: one static scale a site, calibrated by ONE float forward
  under a ``Recorder``: max|x| at percentile 100, else ``abs_percentile``
  (default p99 for serving, measured by JAX on a trained checkpoint); a
  layer reached at several sites takes the max over them. Under data
  parallelism the maxima are reduced with MAX and the histogram counts with
  SUM over the ranks, so that n ranks calibrate as one process does (JAX
  gets this from SPMD). Then ``sx = max(scale, 1e-8) / 127`` and
  ``clip(round(x / sx), -127, 127)``.
* **Products**: s8 x s8 -> s32, exact, dequantized as ``y * (sx * sw)`` in
  fp32, plus the fp32 bias, cast to the input's dtype. BN, GLU,
  attention, softmax and tanh stay in the float compute dtype.

A site that is not quantizable, skipped or uncalibrated runs its float
path. The sites find the interceptor through ops/int8.py::intercept.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
import torch.nn as nn

from attngan_torch.infer.sampler import InferState, Sampler
from attngan_torch.models.cnn_encoder import BasicConv2d, TinyTrunk
from attngan_torch.ops.int8 import Int8Site, intercepting, quantizable
from attngan_torch.parallel.mesh import Mesh, all_reduce_max, all_reduce_sum

BINS = 2048
CHUNK = 1 << 22


def generator_sites(gen: nn.Module) -> Dict[nn.Module, str]:
    """{layer: name} of a generator's int8 sites, as its family's
    ``int8_sites`` gives them (models/generator.py: JAX's module paths)."""
    return gen.int8_sites()


def trunk_sites(trunk: nn.Module) -> Dict[nn.Module, str]:
    """{conv: JAX module path} of an (unfolded) image trunk, relative to
    the trunk as JAX's ``trunk.apply`` names it: an Inception block's
    ``Mixed_6b/branch7x7_2/conv``, but not its fused siblings; the tiny
    trunk's ``Conv_i``."""
    if isinstance(trunk, TinyTrunk):
        return {getattr(trunk, f"Conv_{i}"): f"Conv_{i}" for i in range(3)}
    sites = {}
    for name, module in trunk.named_modules():
        if not isinstance(module, BasicConv2d):
            continue
        parent, _, branch = name.rpartition(".")
        block = trunk.get_submodule(parent) if parent else trunk
        if branch not in getattr(block, "FUSED_SIBLINGS", ()):
            sites[module.conv] = name.replace(".", "/") + "/conv"
    return sites


def abs_percentile(x: torch.Tensor, pct: float,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """JAX's ``_abs_percentile``: the pct-th percentile of |x| from a
    2048-bin histogram (bin ``clip(int(|x| * 2048 / max), 0, 2047)``),
    counted 2^22 elements at a time, read as ``max * (idx + 1) / 2048``
    with idx the first bin whose cdf reaches pct. ``torch.bincount`` counts
    exactly (JAX sums exact int32 chunk counts in fp32). Over a mesh: the
    max of every rank's, the counts summed. A 0-d fp32 tensor."""
    flat = x.detach().float().reshape(-1)
    mx = all_reduce_max(flat.abs().max(), mesh)
    scale = 2048.0 / torch.clamp(mx, min=1e-30)
    hist = torch.zeros(BINS, dtype=torch.int64, device=flat.device)
    for chunk in flat.split(CHUNK):
        bins = torch.clamp((chunk.abs() * scale).to(torch.int32), 0, BINS - 1)
        hist += torch.bincount(bins, minlength=BINS)
    hist = all_reduce_sum(hist, mesh)
    n = flat.numel() * (1 if mesh is None else mesh.size)
    cdf = torch.cumsum(hist, 0).float() / n
    idx = torch.searchsorted(cdf, torch.tensor([pct / 100.0], device=cdf.device))
    return mx * (idx[0] + 1).float() / BINS


class Recorder:
    """Interceptor of a calibration forward: records each site's
    activation scale (a 0-d tensor, the max over the layer's calls) and
    lets the float path run."""

    def __init__(self, sites: Dict[nn.Module, str], percentile: float = 100.0,
                 mesh: Optional[Mesh] = None):
        self.sites = sites
        self.percentile = percentile
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.records: Dict[str, torch.Tensor] = {}

    def __call__(self, layer: nn.Module, x: torch.Tensor) -> None:
        path = self.sites.get(layer)
        if path is None or not quantizable(layer) or not x.is_floating_point():
            return None
        if self.percentile >= 100.0:
            mx = all_reduce_max(x.detach().abs().max().float(), self.mesh)
        else:
            mx = abs_percentile(x, self.percentile, self.mesh)
        prev = self.records.get(path)
        self.records[path] = mx if prev is None else torch.maximum(prev, mx)
        return None

    def scales(self) -> Dict[str, float]:
        return {path: float(v) for path, v in sorted(self.records.items())}


class Quantizer(nn.Module):
    """Interceptor of a quantized forward: every quantizable site not in
    ``skip`` has its weight quantized here, once; a site runs in int8 where
    ``act_scales`` (settable later) holds its path. A module, so that the
    quantized weights move with ``.to()`` and an exported program keeps
    them."""

    def __init__(self, sites: Dict[nn.Module, str],
                 act_scales: Optional[Dict[str, float]] = None,
                 skip: Iterable[str] = ()):
        super().__init__()
        skip = set(skip)
        self.act_scales = dict(act_scales or {})
        self._by_layer = {layer: (path, Int8Site(layer))
                          for layer, path in sites.items()
                          if quantizable(layer) and path not in skip}
        self.int8_sites = nn.ModuleList(s for _, s in self._by_layer.values())

    def forward(self, layer: nn.Module, x: torch.Tensor
                ) -> Optional[torch.Tensor]:
        entry = self._by_layer.get(layer)
        if entry is None or not x.is_floating_point():
            return None
        path, site = entry
        scale = self.act_scales.get(path)
        if scale is None:
            return None
        return site(x, max(scale, 1e-8) / 127.0)


def calibrate(fn, *args, sites: Dict[nn.Module, str],
              calib_percentile: float = 100.0, mesh: Optional[Mesh] = None,
              **kwargs):
    """``fn(*args, **kwargs)`` under a Recorder of ``sites``: (output,
    {JAX module path: activation scale})."""
    recorder = Recorder(sites, calib_percentile, mesh)
    with intercepting(recorder):
        out = fn(*args, **kwargs)
    return out, recorder.scales()


def quantized_call(act_scales: Dict[str, float], fn, *args,
                   sites: Dict[nn.Module, str], skip: Iterable[str] = (),
                   **kwargs):
    """``fn(*args, **kwargs)`` with every calibrated site of ``sites`` in
    int8 (weights quantized for this call)."""
    with intercepting(Quantizer(sites, act_scales, skip)):
        return fn(*args, **kwargs)


class Int8Sampler(Sampler):
    """The int8 twin of Sampler (JAX's ``Int8Sampler``): the generator's
    sites quantized, the BiLSTM and K1 / K2 (DF-GAN: K7) as in float
    serving. The weights are quantized when the sampler is built; the
    activation scales are calibrated on the first batch it serves (or
    ``calibrate_on``), with that batch's own noise, which the quantized
    call then takes too. On a mesh every rank calibrates to one process's
    scales."""

    def __init__(self, state: InferState,
                 device: str | torch.device | None = None,
                 mesh: Optional[Mesh] = None, skip: Iterable[str] = (),
                 percentile: float = 99.0):
        # 99 is JAX's measured default (BENCH.md, a trained checkpoint):
        # trained generators have rare activation spikes that stretch a
        # max-calibrated grid away from the bulk; 100 = max calibration
        super().__init__(state, device, mesh)
        self.percentile = percentile
        self.sites = generator_sites(self.state.generator)
        self.quantizer = Quantizer(self.sites, skip=skip)
        self.act_scales: Optional[Dict[str, float]] = None

    def calibrate_on(self, tokens, lengths, noise=None, eps=None,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, float]:
        """One float forward under a Recorder; sets and returns the
        scales."""
        recorder = Recorder(self.sites, self.percentile, self.mesh)
        with intercepting(recorder):
            super().generate_stages(tokens, lengths, noise, eps, generator,
                                    gather=False)
        self.act_scales = self.quantizer.act_scales = recorder.scales()
        return self.act_scales

    def generate_stages(self, tokens, lengths, noise=None, eps=None,
                        generator: Optional[torch.Generator] = None,
                        gather: bool = True):
        if self.act_scales is None:
            n = len(tokens)
            if noise is None:
                noise = torch.randn((n, self.cfg.z_dim), generator=generator,
                                    device=self.device)
            if eps is None:
                eps = torch.randn((n, self.cfg.cond_dim),
                                  generator=generator, device=self.device)
            self.calibrate_on(tokens, lengths, noise, eps)
        with intercepting(self.quantizer):
            return super().generate_stages(tokens, lengths, noise, eps,
                                           generator, gather)
