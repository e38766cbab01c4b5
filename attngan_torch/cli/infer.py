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
first two captions (--swap).

--generator dmgan serves DM-GAN's generator (models/dmgan.py: AttnGAN's
three stages, a dynamic memory in place of word attention, its memory
addressing maps saved by --save-attention; no --export), --generator
dfgan DF-GAN's (models/dfgan.py: one 256^2 stage, no attention maps, so
no --save-attention or --export), through the same sampler; a checkpoint
records its family, and one written before the field existed holds
AttnGAN's.

Every command line of JAX's ``cli.infer`` parses: --df-dim and
--image-encoder, which the generator does not read, are checked against
the checkpoint's recorded values like the shape flags; --fused-attention
names K1, the route the port always takes on the GPU.

--int8 serves the generator's Conv / Dense sites in int8
(infer/quantize.py: weights per output channel, activation scales
calibrated on the first batch at --int8-percentile; K1 and K2 stay on the
path, float), the final stage only. --export PATH writes a serving
artifact (infer/export.py: one torch.export program per platform of
--export-platforms, the weights in it, the batch symbolic unless
--export-batch fixes it) and exits; serve it with
``attngan_torch.infer.export.ExportedSampler``. The artifact is the plain
path, so --export refuses an explicit --fused-upsample other than off.
With --int8 it is the int8 tier, calibrated here on --batch-size captions
of the captions JSON.

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
  python -m attngan_torch.cli.infer --int8 --benchmark --batch-size 64
  python -m attngan_torch.cli.infer --checkpoint checkpoints/gan \
      --captions-path data/caps.json --export serve.zip --int8
  torchrun --standalone --nproc-per-node 2 -m attngan_torch.cli.infer \
      --benchmark --batch-size 64 --mesh-shape 2
"""

from __future__ import annotations

import argparse
import json
import os
import time

# bench.py's vocabulary size, for a benchmark with neither a checkpoint nor
# a captions file
BENCH_VOCAB = 1000
# the benchmark's serving calls: one warm-up, then WINDOWS windows of ITERS
BENCH_WINDOWS, BENCH_ITERS = 5, 4
# the model flags: each defaults to the checkpoint's recorded value, and an
# explicit one that contradicts it is refused. The port serves only the
# generator, so --df-dim and --image-encoder do nothing else.
MODEL_FLAGS = ("num_stages", "gf_dim", "df_dim", "emb_dim", "seq_len",
               "image_encoder", "generator")


def parse_args(argv=None):
    from attngan_torch.core.config import Config
    from attngan_torch.infer.sampler import GENERATORS

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
    p.add_argument("--generator", default=None, choices=list(GENERATORS),
                   help="the generator family: 'attngan' (3 stages, word "
                        "attention; the default), 'dmgan' (DM-GAN's 3 "
                        "stages, a dynamic memory of the words) or 'dfgan' "
                        "(DF-GAN's one 256^2 stage, text fused into every "
                        "block); checked against the checkpoint's recorded "
                        "value")
    p.add_argument("--num-stages", type=int, default=None, choices=[1, 2, 3])
    p.add_argument("--gf-dim", type=int, default=None)
    p.add_argument("--df-dim", type=int, default=None,
                   help="checked against the checkpoint's recorded value "
                        "(the discriminators are not served)")
    p.add_argument("--emb-dim", type=int, default=None)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--image-encoder", default=None,
                   choices=["inception_v3", "tiny"],
                   help="checked against the checkpoint's recorded value "
                        "(the image encoder is not served)")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--fused-attention", action="store_true",
                   help="the K1 word-attention kernel, the route the port "
                        "always takes on the GPU (JAX's opt-in flag); "
                        "refused with --export")
    p.add_argument("--fused-upsample", default=None,
                   choices=["pallas", "packed", "packed64", "off"],
                   help="JAX's eval UpBlock routes; on Hopper 'pallas' "
                        "(the default), 'packed' and 'packed64' are all "
                        "the generator's eval kernels (K2 at >=64^2, K8 at "
                        "each BN epilogue), 'off' = PyTorch's plain chain")
    p.add_argument("--int8-percentile", type=float, default=99.0,
                   help="int8 activation-scale calibration percentile "
                        "(100 = the max; 99, JAX's measured default, clips "
                        "the rare activation spikes that coarsen the grid)")
    p.add_argument("--int8", action="store_true",
                   help="serve the generator through post-training int8 "
                        "quantization; calibrates on the first batch")
    p.add_argument("--export", metavar="PATH", default="",
                   help="write a serving artifact (torch.export programs, "
                        "the weights in them) to PATH and exit; serve it "
                        "with attngan_torch.infer.export.ExportedSampler. "
                        "With --int8: the int8 tier, calibrated on "
                        "--batch-size captions of the captions JSON")
    p.add_argument("--export-platforms", default="cuda,cpu",
                   help="comma-separated platforms for --export, one "
                        "program each (default both)")
    p.add_argument("--export-batch", type=int, default=0,
                   help="fixed batch size for --export; 0 = a symbolic "
                        "batch (one artifact, any request size)")
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

    shapes = {k: getattr(args, k) for k in MODEL_FLAGS
              if getattr(args, k) is not None}
    return GanConfig(compute_dtype=args.compute_dtype,
                     fused_upsample=args.fused_upsample != "off",
                     **shapes), shapes


def _refuse_contradictions(shapes: dict, recorded: dict, where: str) -> None:
    """An explicit model flag must agree with what the checkpoint recorded."""
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
        # a cli.train config.json records the whole GanConfig (a
        # save_infer_state .pt records SHAPE_FIELDS alone)
        recorded = {k: sidecar[k] for k in SHAPE_FIELDS + ("image_encoder",)
                    if k in sidecar}
        if sidecar:     # cli.train trains AttnGAN only
            recorded.setdefault("generator", "attngan")
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
    rates, seconds = [], 0.0
    for _ in range(windows):
        start = time.perf_counter()
        for _ in range(iters):
            imgs = call()
        sync()
        elapsed = time.perf_counter() - start
        seconds += elapsed
        rates.append(args.batch_size * iters / elapsed)
    if not bool(torch.isfinite(imgs).all()):
        raise RuntimeError("non-finite images in the benchmark")
    # every window's images over every window's seconds: a stall in one
    # window counts, as it would not in a median of the windows' rates
    value = args.batch_size * iters * windows / seconds
    device = (torch.cuda.get_device_name(sampler.device)
              if sampler.device.type == "cuda" else "cpu")
    return {"metric": "gen_images_per_sec", "value": value, "unit": "img/s",
            "windows": rates,
            "spread_pct": 100.0 * (max(rates) - min(rates)) / value,
            "batch_size": args.batch_size, "device": device,
            "devices": 1 if sampler.mesh is None else sampler.mesh.size,
            "compute_dtype": cfg.compute_dtype,
            "fused_upsample": cfg.fused_upsample,
            "int8": bool(args.int8)}


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


def _export(args, cfg, shapes, handler, device) -> str:
    """--export: the artifact at args.export; returns its path."""
    from attngan_torch.infer.export import (
        save_exported_int8_sampler,
        save_exported_sampler,
    )

    state = _load_state(args, cfg, shapes, handler)
    if state.generator.unexportable:
        raise SystemExit(f"--export: {state.generator.unexportable}")
    platforms = [s.strip() for s in args.export_platforms.split(",")
                 if s.strip()]
    batch = args.export_batch or None
    if args.int8:
        captions = list(handler.img2caption.values()) if handler else []
        if not captions:
            raise SystemExit("--export --int8 calibrates on the captions "
                             f"JSON ({args.captions_path}), which is empty "
                             "or missing")
        reps = -(-args.batch_size // len(captions))
        tokens, lengths = handler.preprocess(
            (captions * reps)[: args.batch_size],
            max_seqlen=state.cfg.seq_len)
        n = save_exported_int8_sampler(
            args.export, state, tokens, lengths, platforms=platforms,
            batch_size=batch, percentile=args.int8_percentile,
            calib_seed=args.seed, device=device)
    else:
        n = save_exported_sampler(args.export, state, platforms=platforms,
                                  batch_size=batch)
    print(f"wrote {args.export} ({n:,} bytes, platforms "
          f"{','.join(platforms)}, int8 {args.int8}, batch "
          f"{batch or 'symbolic'})")
    return args.export


def main(argv=None):
    """Returns the benchmark's result, the paths of the PNGs written (on a
    rank other than 0: None, or no paths), or the artifact's path."""
    args = parse_args(argv)
    if not args.benchmark and not args.image_names and not args.export:
        raise SystemExit("pass --image-names (or --benchmark / --export)")
    if args.export and (args.fused_attention
                        or args.fused_upsample not in (None, "off")):
        # the artifact is the plain path (JAX refuses its Pallas flags
        # with --export too)
        raise SystemExit("--export writes the plain path; drop "
                         "--fused-attention/--fused-upsample")
    if args.int8 and (args.all_stages or args.save_attention):
        raise SystemExit("--int8 serves the final-stage path only; drop "
                         "--all-stages/--save-attention")
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
    if args.export:
        from attngan_torch.parallel.mesh import global_rank

        # one artifact: under torchrun rank 0 writes it
        return _export(args, cfg, shapes, handler, device) \
            if global_rank() == 0 else None
    n_items = args.batch_size if args.benchmark else len(args.image_names)
    mesh = make_mesh(n_items, tuple(args.mesh_shape), device or "cuda")
    if mesh is None:
        return None
    state = _load_state(args, cfg, shapes, handler)
    if args.save_attention and not state.generator.has_attention:
        raise SystemExit("--save-attention: this generator has no word "
                         "attention maps")
    if args.int8:
        from attngan_torch.infer.quantize import Int8Sampler

        sampler = Int8Sampler(state, device=device, mesh=mesh,
                              percentile=args.int8_percentile)
    else:
        sampler = Sampler(state, device=device, mesh=mesh)

    if args.benchmark:
        result = _benchmark(sampler, args)
        if mesh.is_main:
            print(json.dumps(result))
        return result
    return _write_images(sampler, handler, args)


if __name__ == "__main__":
    main()
