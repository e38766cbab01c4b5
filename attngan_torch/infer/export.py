"""Serving artifacts through ``torch.export``: port of
attngan_tpu/infer/export.py.

The serving function (the BiLSTM, the generator cascade in eval mode,
denormalize) is exported with the weights in the program, one
``torch.export`` program per platform ("cuda", "cpu": device constants are
baked into a trace), and written to one file: a zip of ``abi.json`` and
``<platform>.pt2`` (``torch.export.save``'s bytes). Serving it needs
``torch.export.load`` and the file: ``ExportedSampler``, whose module
imports nothing but torch and the standard library.

* **ABI**: ``(tokens (b, L) int32, lengths (b,) int32, seed)`` -> images
  ``(b, R, R, 3)`` in [0, 1], fp32. ``b`` is a ``torch.export.Dim`` unless
  a fixed batch was asked for, and then other sizes are refused.
* **The seed**: the program takes the noise and the reparametrization eps
  as inputs, since a ``torch.Generator`` cannot live in an exported
  program. ``ExportedSampler`` draws them from ``torch.Generator(device)
  .manual_seed(seed)``, noise then eps, the draws ``cli.infer`` makes for
  ``--seed`` on that device: the same seed gives the same images on every
  call.
* **The plain path**: the program is the generator without K1 and K2 (and
  the BiLSTM in ``forward_masked`` form), as JAX's is its XLA path without
  Pallas; the live serving path keeps the kernels.
* **int8** (``export_int8_sampler``): calibrated once at export time on a
  caller's caption batch; the scales are constants of the program and are
  recorded in ``abi.json``, the quantized weights are its buffers.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import zipfile
from typing import Dict, Optional, Sequence

import torch

ABI = "abi.json"


class _Serving(torch.nn.Module):
    """(tokens, lengths, noise, eps) -> final-stage images in [0, 1]."""

    def __init__(self, state, act_scales: Optional[Dict[str, float]] = None):
        from attngan_torch.infer.quantize import Quantizer, generator_sites

        super().__init__()
        self.rnn = state.rnn
        self.generator = state.generator
        self.quantizer = None
        if act_scales is not None:
            self.quantizer = Quantizer(generator_sites(self.generator),
                                       act_scales)

    def forward(self, tokens, lengths, noise, eps):
        from attngan_torch.data.dataset import word_mask
        from attngan_torch.infer.sampler import denormalize
        from attngan_torch.ops.int8 import intercepting

        words, sent = self.rnn.forward_masked(tokens, lengths)
        mask = word_mask(lengths, tokens.shape[1])
        with (contextlib.nullcontext() if self.quantizer is None
              else intercepting(self.quantizer)):
            fakes, _, _, _ = self.generator(noise, sent, words, mask, eps=eps)
        return denormalize(fakes[-1])


def plain_state(state, device):
    """A copy of an InferState on ``device`` whose generator runs the plain
    path (no K1, no K2), in eval mode."""
    from attngan_torch.core.config import replace
    from attngan_torch.infer.sampler import InferState

    cfg = replace(state.cfg, fused_attention=False, fused_upsample=False)
    plain = InferState(cfg, state.vocab_size)
    plain.load_state_dict(state.state_dict())
    return plain.to(device).eval()


def _export(state, platform: str, batch_size: Optional[int],
            act_scales: Optional[Dict[str, float]] = None
            ) -> torch.export.ExportedProgram:
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("exporting the 'cuda' program needs a GPU; "
                           "export for 'cpu' only (CLI: --export-platforms "
                           "cpu)")
    cfg = state.cfg
    serving = _Serving(plain_state(state, platform), act_scales)
    n = batch_size or 2
    example = (torch.zeros((n, cfg.seq_len), dtype=torch.int32),
               torch.full((n,), cfg.seq_len, dtype=torch.int32),
               torch.zeros((n, cfg.z_dim)), torch.zeros((n, cfg.cond_dim)))
    example = tuple(t.to(platform) for t in example)
    dynamic = None
    if batch_size is None:
        b = torch.export.Dim("b", min=1)
        dynamic = ({0: b},) * 4
    with torch.no_grad():
        return torch.export.export(serving, example, dynamic_shapes=dynamic,
                                   strict=False)


def _abi(state, platforms, batch_size, act_scales=None) -> dict:
    cfg = state.cfg
    return {"seq_len": cfg.seq_len, "z_dim": cfg.z_dim,
            "cond_dim": cfg.cond_dim, "resolution": cfg.resolutions[-1],
            "batch_size": batch_size, "platforms": list(platforms),
            "compute_dtype": cfg.compute_dtype,
            "int8": act_scales is not None, "act_scales": act_scales}


def export_sampler(state, platforms: Sequence[str] = ("cuda", "cpu"),
                   batch_size: Optional[int] = None
                   ) -> Dict[str, torch.export.ExportedProgram]:
    """{platform: the exported serving program} of an InferState (any
    device); ``batch_size`` None = a symbolic batch."""
    return {p: _export(state, p, batch_size) for p in platforms}


def _save(path: str, programs: Dict[str, torch.export.ExportedProgram],
          abi: dict) -> int:
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr(ABI, json.dumps(abi))
        for platform, program in programs.items():
            buf = io.BytesIO()
            torch.export.save(program, buf)
            z.writestr(f"{platform}.pt2", buf.getvalue())
    return os.path.getsize(path)


def save_exported_sampler(path: str, state,
                          platforms: Sequence[str] = ("cuda", "cpu"),
                          batch_size: Optional[int] = None) -> int:
    """export_sampler -> one artifact file; returns its size in bytes."""
    return _save(path, export_sampler(state, platforms, batch_size),
                 _abi(state, platforms, batch_size))


def calibrate_int8(state, calib_tokens, calib_lengths,
                   percentile: float = 99.0, calib_seed: int = 0,
                   device: str | torch.device | None = None
                   ) -> Dict[str, float]:
    """The int8 tier's activation scales on the plain path, from one
    calibration batch with the noise of ``calib_seed`` on ``device``."""
    from attngan_torch.core.runtime import resolve_device
    from attngan_torch.infer.quantize import Int8Sampler

    dev = resolve_device(device)
    sampler = Int8Sampler(plain_state(state, dev), device=dev,
                          percentile=percentile)
    return sampler.calibrate_on(
        calib_tokens, calib_lengths,
        generator=torch.Generator(dev).manual_seed(calib_seed))


def export_int8_sampler(state, calib_tokens, calib_lengths,
                        platforms: Sequence[str] = ("cuda", "cpu"),
                        batch_size: Optional[int] = None,
                        percentile: float = 99.0, calib_seed: int = 0,
                        device: str | torch.device | None = None
                        ) -> Dict[str, torch.export.ExportedProgram]:
    """Calibrate the int8 tier (``calibrate_int8``), then export the
    quantized serving function with the scales as constants."""
    scales = calibrate_int8(state, calib_tokens, calib_lengths, percentile,
                            calib_seed, device)
    return {p: _export(state, p, batch_size, scales) for p in platforms}


def save_exported_int8_sampler(path: str, state, calib_tokens, calib_lengths,
                               platforms: Sequence[str] = ("cuda", "cpu"),
                               batch_size: Optional[int] = None,
                               percentile: float = 99.0, calib_seed: int = 0,
                               device: str | torch.device | None = None
                               ) -> int:
    """export_int8_sampler -> one artifact file; returns its byte size."""
    scales = calibrate_int8(state, calib_tokens, calib_lengths, percentile,
                            calib_seed, device)
    programs = {p: _export(state, p, batch_size, scales) for p in platforms}
    return _save(path, programs, _abi(state, platforms, batch_size, scales))


class ExportedSampler:
    """Serve from an artifact file: tokens (B, L) int32, lengths (B,)
    int32, seed -> (B, R, R, 3) fp32 images in [0, 1]. Needs torch and the
    file only. ``device`` None is the GPU (an error without one)."""

    def __init__(self, path: str, device: str | torch.device | None = None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to serve the CPU program")
        with zipfile.ZipFile(path) as z:
            self.abi = json.loads(z.read(ABI))
            self.platforms = tuple(self.abi["platforms"])
            if self.device.type not in self.platforms:
                raise ValueError(f"{path} holds programs for "
                                 f"{self.platforms}, not {self.device.type}")
            program = torch.export.load(
                io.BytesIO(z.read(f"{self.device.type}.pt2")))
        self.program = program.module()

    def __call__(self, tokens, lengths, seed: int = 0) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, dtype=torch.int32, device=self.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=self.device)
        n = tokens.shape[0]
        fixed = self.abi["batch_size"]
        if fixed is not None and n != fixed:
            raise ValueError(f"this artifact serves batches of {fixed}; got "
                             f"{n}")
        gen = torch.Generator(self.device).manual_seed(int(seed))
        noise = torch.randn((n, self.abi["z_dim"]), generator=gen,
                            device=self.device)
        eps = torch.randn((n, self.abi["cond_dim"]), generator=gen,
                          device=self.device)
        with torch.no_grad():
            return self.program(tokens, lengths, noise, eps)
