"""The frozen Inception trunk's gradient into its images on the GPU: the GAN
step's DAMSM coupling differentiates through it.

Prints one JSON line with:
- ``avg_pool``: PyTorch's ``F.avg_pool2d(x, 3, 1, 1)`` backward against the
  port's pool (``models/cnn_encoder.py::_avg_pool3x3``, the same window sum
  as a depthwise conv), on CUDA, for a channels_last and an
  NCHW input, in fp32 and fp64 (relative norm of the gradients'
  difference), at Mixed_5b's input (4, 192, 35, 35);
- ``trunk``: the gradient of a fixed random projection of the trunk's
  outputs (regions and pooled code) with respect to 256^2 images, batch 4,
  seeded random weights, in fp32 against fp64 on the GPU and on the CPU,
  through ``models/cnn_encoder.py::_avg_pool3x3`` (the port's pool) and
  through ``F.avg_pool2d``;
- ``pool_ms``: device time of one call (median of 20, CUDA events) at the
  trunk's three pool shapes at batch 64 in bf16 channels_last, for
  ``F.avg_pool2d`` and for ``_avg_pool3x3``.

Run on the GPU from the repository's root:

    python -m attngan_torch.tools.trunk_gradient
"""

from __future__ import annotations

import json
import statistics
import subprocess
from unittest import mock

import torch
import torch.nn.functional as F

from attngan_torch.models import cnn_encoder
from attngan_torch.models.cnn_encoder import freeze_trunk, make_image_encoder

POOL_SHAPES = ((64, 288, 35, 35), (64, 768, 17, 17), (64, 2048, 8, 8))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def avg_pool_gradients() -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    out = {}
    for layout in ("channels_last", "nchw"):
        for dtype in (torch.float32, torch.float64):
            x = torch.randn(4, 192, 35, 35, generator=gen, device="cuda",
                            dtype=dtype)
            if layout == "channels_last":
                x = x.to(memory_format=torch.channels_last)
            w = torch.randn(x.shape, generator=gen, device="cuda",
                            dtype=dtype)
            grads = []
            for fn in (lambda t: F.avg_pool2d(t, 3, 1, 1),
                       cnn_encoder._avg_pool3x3):
                xi = x.clone().requires_grad_()
                (fn(xi) * w).sum().backward()
                grads.append(xi.grad)
            out[f"{layout}_{str(dtype).split('.')[-1]}"] = _rel(*grads)
    return out


def trunk_gradients() -> dict:
    torch.manual_seed(0)
    cnn = make_image_encoder("inception_v3", 256).eval().requires_grad_(False)
    images = torch.tanh(torch.randn(4, 256, 256, 3,
                                    generator=torch.Generator().manual_seed(1)))

    def grad(device, dtype, pool):
        enc = make_image_encoder("inception_v3", 256, dtype)  # trunk dtype
        enc.load_state_dict(cnn.state_dict())
        enc = enc.to(device, dtype).eval().requires_grad_(False)
        trunk = freeze_trunk(enc.trunk, device)
        x = images.to(device, dtype).clone().requires_grad_()
        with mock.patch.object(cnn_encoder, "_avg_pool3x3", pool):
            regions, code = enc.heads(*trunk(x.permute(0, 3, 1, 2)))
        seed = torch.Generator().manual_seed(2)
        wr = torch.randn(regions.shape, generator=seed, dtype=torch.float64)
        wc = torch.randn(code.shape, generator=seed, dtype=torch.float64)
        ((regions * wr.to(device, regions.dtype)).sum()
         + (code * wc.to(device, code.dtype)).sum()).backward()
        return x.grad

    port = cnn_encoder._avg_pool3x3
    library = lambda t: F.avg_pool2d(t, 3, stride=1, padding=1)  # noqa: E731
    ref = grad("cpu", torch.float64, port)
    out = {"gpu_fp64_port_pool": _rel(grad("cuda", torch.float64, port), ref)}
    for device in ("cuda", "cpu"):
        for name, pool in (("port_pool", port), ("avg_pool2d", library)):
            out[f"{'gpu' if device == 'cuda' else 'cpu'}_fp32_{name}"] = _rel(
                grad(device, torch.float32, pool), ref)
    return out


def pool_times() -> dict:
    out = {}
    for shape in POOL_SHAPES:
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16).to(
            memory_format=torch.channels_last)
        row = {}
        for name, fn in (("avg_pool2d", lambda t: F.avg_pool2d(t, 3, 1, 1)),
                         ("port_pool", cnn_encoder._avg_pool3x3)):
            for _ in range(3):
                fn(x)
            times = []
            for _ in range(20):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(x)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            row[name] = statistics.median(times)
        out["x".join(map(str, shape))] = row
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("trunk_gradient: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tool": "trunk_gradient", "card": card,
                      "torch": torch.__version__,
                      "avg_pool": avg_pool_gradients(),
                      "trunk": trunk_gradients(),
                      "pool_ms": pool_times()}), flush=True)


if __name__ == "__main__":
    main()
