"""Checkpoints of whole training states, for exact resume and for serving.

Port of attngan_tpu/train/checkpoint.py, on torch.save instead of orbax.
Reference: trainers/trainer.py:109-127 — per-module ``torch.save`` pickles
keyed by CLASS NAME, which silently collide for the four Adam optimizers
(all save to saved_weights/Adam.pkl, SURVEY.md §3.2) and never record the
step counter. Here a checkpoint holds the whole state, so resume is exact:
every module's parameters and buffers (BN statistics), every optimizer's
state, the step and the state's ``torch.Generator`` (dropout, noise, eps
and label streams).

Layout: ``directory/step_{step:08d}/<part>.pt``, one file per field of the
state (``rnn.pt``, ``gen.pt``, ``discs.pt``, ``gen_optimizer.pt``, ...), all
on the CPU, beside the ``config.json`` and ``progress.json`` sidecars in
``directory``. A save is written under a hidden name and renamed into
place, so a crash mid-save leaves the previous checkpoints as they were.
Serving reads only ``rnn.pt`` and ``gen.pt`` (``restore_inference_state``).
On a mesh of data-parallel ranks, whose states are equal, rank 0 writes
and every rank waits at a barrier until the files are in place.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, List, Optional

import torch
import torch.nn as nn

# state fields that are caches rebuilt from the weights, never saved
CACHES = ("frozen_trunk",)


def _saved(value: Any) -> Any:
    """One state field as it is saved: CPU tensors, plain containers."""
    if isinstance(value, (nn.Module, torch.optim.Optimizer)):
        return _to_cpu(value.state_dict())
    if isinstance(value, dict):
        return {k: _saved(v) for k, v in value.items()}
    if isinstance(value, torch.Generator):
        return value.get_state()
    if isinstance(value, int):
        return value
    raise TypeError(f"cannot checkpoint a {type(value).__name__}")


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def state_parts(state: Any) -> dict:
    """{field name: its saved form} of a DamsmState or GanState: what
    ``save_checkpoint`` writes and ``restore_checkpoint`` reads back."""
    return {f.name: _saved(getattr(state, f.name))
            for f in dataclasses.fields(state) if f.name not in CACHES}


def diff_parts(a: Any, b: Any, where: str = "") -> List[str]:
    """Where two saved forms (``state_parts`` or ``load_part`` results)
    differ: tensors compared bit for bit, with their dtypes and shapes."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
        return [] if same else [where]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{where} keys"]
        return [d for k in a for d in diff_parts(a[k], b[k], f"{where}.{k}")]
    if (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
            and len(a) == len(b)):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in diff_parts(x, y, f"{where}[{i}]")]
    return [] if a == b else [where]


def save_checkpoint(directory: str, state: Any, step: int,
                    config: Any = None, epoch: Optional[int] = None,
                    mesh=None) -> str:
    """Write ``state`` to ``directory/step_{step:08d}`` (replacing a save of
    the same step) and the sidecars; returns the step's path. With a
    ``mesh`` (parallel/mesh.py) rank 0 writes, then every rank of it waits
    for the others."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step:08d}")
    if mesh is not None and not mesh.is_main:
        mesh.barrier()
        return path
    _write(directory, path, state, step, config, epoch)
    if mesh is not None:
        mesh.barrier()
    return path


def _write(directory: str, path: str, state: Any, step: int, config: Any,
           epoch: Optional[int]) -> None:
    partial = os.path.join(directory, f".step_{step:08d}.partial")
    shutil.rmtree(partial, ignore_errors=True)
    os.makedirs(partial)
    for name, part in state_parts(state).items():
        torch.save(part, os.path.join(partial, f"{name}.pt"))
    shutil.rmtree(path, ignore_errors=True)  # overwrite same-step re-runs
    os.replace(partial, path)
    if config is not None:
        # Sidecar with the model-shape config: restoring with mismatched
        # dims otherwise fails deep inside load_state_dict, and the serving
        # CLI takes its shape flags' defaults from it.
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=2)
    if epoch is not None:
        # Epoch sidecar: the state carries the step counter but not the
        # epoch (steps/epoch varies with degenerate-batch skips), and
        # resumed runs must continue epoch numbering, not restart at 1.
        with open(os.path.join(directory, "progress.json"), "w") as f:
            json.dump({"epoch": epoch, "step": step}, f)


def load_progress_sidecar(directory: str) -> int:
    """Epoch count recorded at the newest save (0 when absent)."""
    path = os.path.join(os.path.abspath(directory), "progress.json")
    if os.path.exists(path):
        with open(path) as f:
            return int(json.load(f).get("epoch", 0))
    return 0


def load_config_sidecar(directory: str) -> Optional[dict]:
    path = os.path.join(os.path.abspath(directory), "config.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def latest_checkpoint(directory: str) -> Optional[str]:
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    return os.path.join(directory, steps[-1]) if steps else None


def load_part(path: str, name: str) -> Any:
    """One saved field of the checkpoint at ``path`` (a ``step_*`` dir), its
    tensors memory-mapped from the file on the CPU."""
    return torch.load(os.path.join(path, f"{name}.pt"), map_location="cpu",
                      mmap=True, weights_only=True)


def _restore(value: Any, saved: Any, where: str) -> Any:
    if isinstance(value, (nn.Module, torch.optim.Optimizer)):
        value.load_state_dict(saved)       # modules: strict
    elif isinstance(value, dict):
        if set(value) != set(saved):
            raise ValueError(f"checkpoint {where}: keys {sorted(saved)}, "
                             f"the state has {sorted(value)}")
        for k in value:
            _restore(value[k], saved[k], f"{where}.{k}")
    elif isinstance(value, torch.Generator):
        value.set_state(saved)
    elif isinstance(value, int):
        return saved
    else:
        raise TypeError(f"cannot restore a {type(value).__name__}")
    return value


def restore_checkpoint(path: str, state: Any) -> Any:
    """Restore the checkpoint at ``path`` (a ``step_*`` dir) into ``state``,
    built by the trainer's ``init_state``: every module, every optimizer
    (the parameters in the order the trainer built it with), the
    generator's state and the step; the caches (the folded trunk) are
    dropped, to be rebuilt from the restored weights at first use. A
    checkpoint without ``generator.pt`` (one converted from a JAX state)
    leaves the state's generator as ``init_state`` seeded it.
    Returns ``state``."""
    for f in dataclasses.fields(state):
        if f.name in CACHES:
            setattr(state, f.name, None)
            continue
        if (isinstance(getattr(state, f.name), torch.Generator)
                and not os.path.exists(os.path.join(path, f"{f.name}.pt"))):
            continue
        setattr(state, f.name, _restore(getattr(state, f.name),
                                        load_part(path, f.name), f.name))
    return state


def restore_inference_state(path: str, cfg):
    """The text encoder and generator of the GAN checkpoint at ``path`` (a
    ``step_*`` dir) as the port's InferState on the CPU, built with
    ``cfg``'s shapes and the checkpoint's vocabulary size. Reads only
    ``rnn.pt`` and ``gen.pt``: the discriminators, the frozen image
    encoder and the four Adams, most of the bytes, stay on disk."""
    from attngan_torch.infer.sampler import InferState

    rnn, gen = load_part(path, "rnn"), load_part(path, "gen")
    state = InferState(cfg, rnn["embedding.weight"].shape[0])
    state.rnn.load_state_dict(rnn)
    state.generator.load_state_dict(gen)
    return state
