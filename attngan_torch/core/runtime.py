"""Device selection for the port's entry points.

The port runs on the GPU. The CPU is used only when the caller asks for it
(the tests, ``--device cpu``); a missing GPU is an error, never a silent
fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the GPU; raises RuntimeError when it is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; attngan_torch runs on the GPU. "
            "Pass device='cpu' (CLI: --device cpu) to run on the CPU.")
    return dev


def to_device(x, device: str | torch.device,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` (a tensor, an array or a list) as a tensor on ``device``, or
    copied into ``out`` there, with no blocking copy: host data bound for a
    CUDA device goes through pinned memory, which PyTorch's caching host
    allocator keeps until the copy has run, so the host need not wait."""
    t = torch.as_tensor(x)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and t.device.type == "cpu":
        t = t.pin_memory()
    if out is not None:
        return out.copy_(t, non_blocking=cuda)
    return t.to(device, non_blocking=cuda)


def compute_dtype(name: str | None) -> torch.dtype:
    """``GanConfig.compute_dtype`` string -> torch dtype ("" = float32)."""
    if not name:
        return torch.float32
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in dtypes:
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtypes[name]
