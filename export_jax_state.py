#!/usr/bin/env python
"""Export an orbax checkpoint of the JAX package as the flat ``.npz`` that
the PyTorch port reads.

Runs where JAX is installed (the port's machine needs none). It restores
one ``step_*`` checkpoint of an ``InferState``, ``DamsmState`` or
``GanState``, written by ``attngan_tpu.train.checkpoint.save_checkpoint``,
into the exact tree of its kind: the kind comes from the checkpoint's own
top-level fields, the abstract target from the trainer built with the
``config.json`` sidecar beside the steps (and the vocabulary size that
the checkpoint's embedding records). The restored state is flattened with
``jax.tree_util.tree_flatten_with_path`` into the ``"/"``-joined keys that
``attngan_torch/convert.py`` documents (``gen_params/gen1/UpBlock_0/
kernel``, ``opt_state/0/mu/rnn/w_ih_fwd``, ``step``), the PRNG key left
out, and written with ``numpy.savez`` together with a ``__meta__`` entry
(JSON: the kind, the sidecar config, the vocabulary size, the step and
the epoch of ``progress.json``).

The port turns the file into one of its checkpoint directories::

    python export_jax_state.py checkpoints/gan --out gan_state.npz
    python -m attngan_torch.convert gan_state.npz --out port_ckpt/gan

after which ``python -m attngan_torch.cli.infer --checkpoint port_ckpt/gan``
serves it, ``cli.train --damsm-checkpoint`` reads an exported DamsmState,
and ``--resume`` continues an exported DamsmState or GanState. JAX's PRNG
key has no counterpart in the port: the converted checkpoint holds no
``torch.Generator`` (dropout, noise, eps and labels), which restarts from
the training CLI's ``--seed`` at the first ``--resume``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
from typing import Any, Dict, Tuple

import numpy as np

KINDS = {"gan": "disc_params", "damsm": "cnn_head_params",
         "infer": "gen_params"}


def _key(entry) -> str:
    """One path entry of tree_flatten_with_path: a dict key, a sequence
    index or an attribute (dataclass field, named-tuple field) name."""
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(f"unexpected path entry {entry!r}")


def flatten_state(state) -> Dict[str, np.ndarray]:
    """{"/"-joined path: host array} of a state pytree, its PRNG key left
    out."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        name = "/".join(_key(p) for p in path)
        if name != "key":
            out[name] = np.asarray(leaf)
    return out


def _step_dir(path: str) -> Tuple[str, str]:
    """(step_* dir, the dir of its sidecars) of a checkpoint dir (its
    newest step) or of one step_* dir."""
    path = os.path.abspath(path)
    if os.path.basename(path).startswith("step_"):
        return path, os.path.dirname(path)
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    if not steps:
        raise SystemExit(f"{path}: no step_* checkpoint")
    return os.path.join(path, steps[-1]), path


def _config(cls, recorded: dict):
    """``cls`` built from the sidecar's fields (lists back to tuples)."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in recorded.items() if k in names}
    return cls(**kw)


def abstract_state(kind: str, recorded: dict, vocab_size: int):
    """The abstract (shape and dtype) tree of a state of ``kind``."""
    import jax

    if kind == "damsm":
        from attngan_tpu.core.config import DamsmConfig
        from attngan_tpu.train.damsm_trainer import DamsmTrainer

        trainer = DamsmTrainer(_config(DamsmConfig, recorded), vocab_size,
                               seq_len=8, image_res=64)
        return jax.eval_shape(lambda: trainer.init_state(seed=0))
    from attngan_tpu.core.config import GanConfig
    from attngan_tpu.infer.sampler import as_infer_state
    from attngan_tpu.train.gan_trainer import GanTrainer

    trainer = GanTrainer(_config(GanConfig, recorded), vocab_size)
    state = jax.eval_shape(lambda: trainer.init_state(seed=0))
    return as_infer_state(state) if kind == "infer" else state


def export(path: str, out: str) -> Dict[str, Any]:
    """Write the checkpoint at ``path`` to ``out``; returns its meta."""
    import orbax.checkpoint as ocp

    from attngan_tpu.train.checkpoint import (
        load_config_sidecar,
        restore_checkpoint,
    )

    step_dir, directory = _step_dir(path)
    recorded = load_config_sidecar(directory)
    if recorded is None:
        raise SystemExit(f"{directory}: no config.json sidecar; the "
                         "exporter builds the state's tree from it")
    with ocp.StandardCheckpointer() as ckptr:
        tree = ckptr.metadata(step_dir).item_metadata
    kind = next((k for k, field in KINDS.items() if field in tree), None)
    if kind is None:
        raise SystemExit(f"{step_dir}: not an InferState, DamsmState or "
                         f"GanState (fields {sorted(tree)})")
    vocab_size = tree["rnn_params"]["embedding"].shape[0]
    state = restore_checkpoint(step_dir,
                               abstract_state(kind, recorded, vocab_size))
    flat = flatten_state(state)
    progress = {}
    if os.path.exists(os.path.join(directory, "progress.json")):
        with open(os.path.join(directory, "progress.json")) as f:
            progress = json.load(f)
    meta = {"kind": kind, "config": recorded, "vocab_size": int(vocab_size),
            "step": int(re.sub(r"\D", "", os.path.basename(step_dir))),
            "epoch": int(progress.get("epoch", 0))}
    np.savez(out, __meta__=np.array(json.dumps(meta)), **flat)
    return meta


def main(argv=None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint",
                   help="a checkpoint dir (its newest step_*) or one "
                        "step_* dir, with config.json beside the steps")
    p.add_argument("--out", required=True, help="the .npz to write")
    args = p.parse_args(argv)
    meta = export(args.checkpoint, args.out)
    print(f"wrote {args.out}: a {meta['kind']} state at step "
          f"{meta['step']} (vocabulary {meta['vocab_size']})")
    return meta


if __name__ == "__main__":
    main()
