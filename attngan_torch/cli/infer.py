#!/usr/bin/env python
"""Text -> image inference on the GPU: ``python -m attngan_torch.cli.infer``.

Port of attngan_tpu/cli/infer.py's serving surface. Restores the text
encoder and generator of a GAN checkpoint written by
``python -m attngan_torch.cli.train`` (its directory, for the newest step,
or one ``step_*`` dir; the model-shape flags default to the values its
``config.json`` recorded, and an explicit flag that contradicts them is an
error), or a ``save_infer_state`` .pt. Without --checkpoint it restores
the newest step of <checkpoint dir>/gan, where ``cli.train`` writes by
default, and only where none is found there serves random weights from
--seed, with a warning (``--checkpoint ""``: random weights). Then it
measures throughput (--benchmark) or writes PNGs for the --image-names
entries, captioned from the captions JSON: the final
stage, or every stage (--all-stages) and the word-attention strips
(--save-attention), optionally after swapping cluster tokens between the
first two captions (--swap). The JAX CLI's --int8 and --export* are
later slices of the port: argparse refuses them.

Under ``torchrun`` the ranks serve one batch together (JAX's
data-parallel inference; --mesh-shape as the JAX CLI takes it): every
rank draws the whole batch's noise, samples its own rows, and rank 0
writes the PNGs or prints the benchmark line, which counts the ranks in
``devices``.

Examples:
  python -m attngan_torch.cli.infer --benchmark --batch-size 64
  python -m attngan_torch.cli.infer --captions-path data/caps.json \
      --checkpoint checkpoints/gan --image-names imgA imgB --swap 1 \
      --all-stages --save-attention --out out/
  torchrun --standalone --nproc-per-node 2 -m attngan_torch.cli.infer \
      --benchmark --batch-size 64 --mesh-shape 2
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

# bench.py's vocabulary size, for a benchmark with neither a checkpoint nor
# a captions file
BENCH_VOCAB = 1000
# the benchmark's serving calls: one warm-up, then WINDOWS windows of ITERS
BENCH_WINDOWS, BENCH_ITERS = 5, 4
SHAPE_FLAGS = ("num_stages", "gf_dim", "emb_dim", "seq_len")


def parse_args(argv=None):
    from attngan_torch.core.config import Config

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--captions-path", default=Config.CAPTIONS_JSON)
    p.add_argument("--checkpoint", default=None,
                   help="a cli.train checkpoint dir (its newest step), one "
                        "step_* dir, or a .pt written by attngan_torch."
                        "infer.sampler.save_infer_state; default: "
                        f"{os.path.join(Config.CHECKPOINT_DIR, 'gan')}, "
                        "or random weights (with a warning) where it holds "
                        "no step_*; '' = random weights")
    p.add_argument("--image-names", nargs="*", default=[])
    p.add_argument("--swap", type=int, default=0,
                   help="swap N cluster tokens between the first two captions")
    p.add_argument("--swap-reverse", action="store_true")
    p.add_argument("--all-stages", action="store_true",
                   help="also save the 64/128px intermediate stages")
    p.add_argument("--save-attention", action="store_true",
                   help="save per-word attention strips next to each image")
    p.add_argument("--out", default="generated_images")
    # model shapes: default to the checkpoint's, else GanConfig's
    p.add_argument("--num-stages", type=int, default=None, choices=[1, 2, 3])
    p.add_argument("--gf-dim", type=int, default=None)
    p.add_argument("--emb-dim", type=int, default=None)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--fused-upsample", default="pallas",
                   choices=["pallas", "packed", "packed64", "off"],
                   help="eval UpBlock route at >=64^2: 'pallas' = the K2 "
                        "kernel (any dims), 'packed' = the Ci=64->Co=32 "
                        "K3 kernel where the dims fit, 'packed64' = K3 only "
                        "at 64^2, 'off' = plain upsample + conv")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: the GPU (an error without one); 'cpu' "
                        "runs the plain PyTorch versions of the kernels")
    p.add_argument("--mesh-shape", type=int, nargs="*", default=[],
                   help="device mesh shape: empty=auto 1-D; one int=1-D over "
                        "n devices; two ints=2-D (slices, chips) multi-slice"
                        " (ranks of a torchrun launch)")
    return p.parse_args(argv)


def _config(args):
    from attngan_torch.core.config import GanConfig

    mode = {"pallas": True, "off": False}.get(args.fused_upsample,
                                              args.fused_upsample)
    shapes = {k: getattr(args, k) for k in SHAPE_FLAGS
              if getattr(args, k) is not None}
    return GanConfig(compute_dtype=args.compute_dtype, fused_upsample=mode,
                     **shapes), shapes


def _refuse_contradictions(shapes: dict, recorded: dict, where: str) -> None:
    """An explicit shape flag must agree with what the checkpoint recorded."""
    for name, value in shapes.items():
        if name in recorded and recorded[name] != value:
            raise SystemExit(
                f"--{name.replace('_', '-')} {value} contradicts the "
                f"checkpoint's recorded {name}={recorded[name]} ({where}); "
                f"drop the flag to use the recorded value, or point "
                f"--checkpoint at a run trained with {name}={value}")


def _training_checkpoint(path: str):
    """(step dir, dir of its sidecars) of a cli.train checkpoint path: the
    checkpoint dir's newest step, or one step_* dir."""
    from attngan_torch.train.checkpoint import latest_checkpoint

    ckpt = latest_checkpoint(path)
    if ckpt is not None:
        return ckpt, path
    path = os.path.normpath(path)
    if os.path.isdir(path) and os.path.basename(path).startswith("step_"):
        return path, os.path.dirname(path)
    raise SystemExit(f"--checkpoint {path}: neither a .pt file nor a "
                     f"directory of step_* checkpoints")


def _checkpoint_source(flag: str | None) -> str:
    """The checkpoint to serve: --checkpoint as given, or without it
    Config.CHECKPOINT_DIR/gan where that holds a step_* checkpoint (JAX's
    default and fallback, attngan_tpu/cli/infer.py); "" = random weights,
    with a warning."""
    from attngan_torch.core.config import Config
    from attngan_torch.train.checkpoint import latest_checkpoint

    if flag is None:
        default = os.path.join(Config.CHECKPOINT_DIR, "gan")
        if latest_checkpoint(default) is not None:
            return default
        print(f"WARNING: no checkpoint found in {default}; using random "
              f"weights")
        return ""
    if not flag:
        print("WARNING: no checkpoint given; using random weights")
    return flag


def _load_state(args, cfg, shapes, handler):
    import torch

    from attngan_torch.core.config import SHAPE_FIELDS, replace
    from attngan_torch.infer.sampler import InferState, load_infer_state
    from attngan_torch.train.checkpoint import (
        load_config_sidecar,
        restore_inference_state,
    )

    source = _checkpoint_source(args.checkpoint)
    if not source:
        torch.manual_seed(args.seed)
        vocab = handler.vocab_size if handler is not None else BENCH_VOCAB
        return InferState(cfg, vocab)
    if source.endswith(".pt"):
        state = load_infer_state(source, cfg, device="cpu")
        _refuse_contradictions(
            shapes, {k: getattr(state.cfg, k) for k in SHAPE_FIELDS}, source)
    else:
        ckpt, directory = _training_checkpoint(source)
        sidecar = load_config_sidecar(directory) or {}
        recorded = {k: sidecar[k] for k in SHAPE_FIELDS if k in sidecar}
        if recorded:
            print(f"using the model config recorded at training time: "
                  f"{recorded}")
        _refuse_contradictions(shapes, recorded,
                               os.path.join(directory, "config.json"))
        state = restore_inference_state(ckpt, replace(cfg, **recorded))
        source = ckpt
    if args.image_names and handler.vocab_size != state.vocab_size:
        raise SystemExit(
            f"{args.captions_path} gives a vocabulary of "
            f"{handler.vocab_size} words; the checkpoint was trained with "
            f"{state.vocab_size}: pass the captions JSON of its training run")
    print(f"restored {source}")
    return state


def _benchmark(sampler, args, windows: int = BENCH_WINDOWS,
               iters: int = BENCH_ITERS) -> dict:
    import numpy as np
    import torch

    cfg = sampler.cfg
    rng = np.random.default_rng(args.seed)
    tokens = torch.as_tensor(rng.integers(
        0, sampler.state.vocab_size, (args.batch_size, cfg.seq_len)))
    lengths = torch.full((args.batch_size,), cfg.seq_len)
    gen = torch.Generator(sampler.device).manual_seed(args.seed)

    def sync():
        """The device's queue drained, then every rank's (the images stay
        sharded over the ranks, as JAX's benchmark leaves them)."""
        if sampler.device.type == "cuda":
            torch.cuda.synchronize(sampler.device)
        if sampler.mesh is not None:
            sampler.mesh.barrier()

    def call():
        return sampler.generate_from_tokens(tokens, lengths, generator=gen,
                                            gather=False)

    imgs = call()
    sync()                                 # build + warm-up, untimed
    rates = []
    for _ in range(windows):
        start = time.perf_counter()
        for _ in range(iters):
            imgs = call()
        sync()
        rates.append(args.batch_size * iters / (time.perf_counter() - start))
    if not bool(torch.isfinite(imgs).all()):
        raise RuntimeError("non-finite images in the benchmark")
    median = statistics.median(rates)
    device = (torch.cuda.get_device_name(sampler.device)
              if sampler.device.type == "cuda" else "cpu")
    return {"metric": "gen_images_per_sec", "value": median, "unit": "img/s",
            "windows": rates,
            "spread_pct": 100.0 * (max(rates) - min(rates)) / median,
            "batch_size": args.batch_size, "device": device,
            "devices": 1 if sampler.mesh is None else sampler.mesh.size,
            "compute_dtype": cfg.compute_dtype,
            "fused_upsample": cfg.fused_upsample}


def _host_images(images) -> list:
    """Tensors -> host fp32 arrays; non-finite values are an error."""
    import numpy as np

    arrays = [np.asarray(x.float().cpu()) for x in images]
    if not all(np.isfinite(a).all() for a in arrays):
        raise RuntimeError("non-finite values in the generated images")
    return arrays


def _write_images(sampler, handler, args) -> list:
    """The --image-names PNGs; returns their paths."""
    import torch

    from attngan_torch.utils.imaging import save_attention_maps, save_image

    captions = handler.get_captions(args.image_names)
    if args.swap and len(captions) >= 2:
        captions[:2] = handler.swap_captions(captions[:2], num=args.swap,
                                             reverse=args.swap_reverse)
    tokens, lengths = handler.preprocess(captions,
                                         max_seqlen=sampler.cfg.seq_len)
    gen = torch.Generator(sampler.device).manual_seed(args.seed)
    stages, attns = sampler.generate_stages(tokens, lengths, generator=gen)
    if sampler.mesh is not None and not sampler.mesh.is_main:
        return []                          # rank 0 writes them
    stages, attns = _host_images(stages), _host_images(attns)
    os.makedirs(args.out, exist_ok=True)
    written = []
    for i, name in enumerate(args.image_names):
        base = os.path.basename(name)
        if not (args.all_stages or args.save_attention):
            written.append((os.path.join(args.out, f"{base}.png"),
                            save_image, stages[-1][i]))
            continue
        for imgs in (stages if args.all_stages else stages[-1:]):
            res = imgs.shape[1]
            written.append((os.path.join(args.out, f"{base}_{res}px.png"),
                            save_image, imgs[i]))
        for attn in (attns if args.save_attention else []):
            res = attn.shape[-1]
            written.append((os.path.join(args.out, f"{base}_attn{res}.png"),
                            save_attention_maps, attn[i]))
    for path, save, array in written:
        save(array, path)
        print(f"wrote {path}")
    return [path for path, _, _ in written]


def main(argv=None):
    """Returns the benchmark's result, or the paths of the PNGs written
    (on a rank other than 0: None, or no paths)."""
    args = parse_args(argv)
    if not args.benchmark and not args.image_names:
        raise SystemExit("pass --image-names (or --benchmark)")
    from attngan_torch.parallel.mesh import launched

    with launched(args.device) as device:
        return _main(args, device)


def _main(args, device):
    from attngan_torch.data.captions import CaptionHandler
    from attngan_torch.infer.sampler import Sampler
    from attngan_torch.parallel.mesh import make_mesh

    handler = None
    if args.image_names or os.path.exists(args.captions_path):
        handler = CaptionHandler(args.captions_path)
    cfg, shapes = _config(args)
    n_items = args.batch_size if args.benchmark else len(args.image_names)
    mesh = make_mesh(n_items, tuple(args.mesh_shape), device or "cuda")
    if mesh is None:
        return None
    state = _load_state(args, cfg, shapes, handler)
    sampler = Sampler(state, device=device, mesh=mesh)

    if args.benchmark:
        result = _benchmark(sampler, args)
        if mesh.is_main:
            print(json.dumps(result))
        return result
    return _write_images(sampler, handler, args)


if __name__ == "__main__":
    main()
