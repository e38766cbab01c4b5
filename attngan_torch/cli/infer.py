#!/usr/bin/env python
"""Text -> image inference on the GPU: ``python -m attngan_torch.cli.infer``.

Port of attngan_tpu/cli/infer.py's serving surface. Loads a port checkpoint
(``save_infer_state``'s .pt) or, without one, random weights from --seed,
then either measures throughput (--benchmark) or writes one PNG per
--image-names entry, captioned from the captions JSON.

Examples:
  python -m attngan_torch.cli.infer --benchmark --batch-size 64
  python -m attngan_torch.cli.infer --captions-path data/caps.json \
      --checkpoint infer_state.pt --image-names imgA imgB --out out/
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
SHAPE_FLAGS = ("num_stages", "gf_dim", "emb_dim", "seq_len")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--captions-path", default="data/captionsAndClassIDs.json")
    p.add_argument("--checkpoint", default="",
                   help="a .pt written by attngan_torch.infer.sampler."
                        "save_infer_state; none = random weights")
    p.add_argument("--image-names", nargs="*", default=[])
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
    return p.parse_args(argv)


def _config(args):
    from attngan_torch.core.config import GanConfig

    mode = {"pallas": True, "off": False}.get(args.fused_upsample,
                                              args.fused_upsample)
    shapes = {k: getattr(args, k) for k in SHAPE_FLAGS
              if getattr(args, k) is not None}
    return GanConfig(compute_dtype=args.compute_dtype, fused_upsample=mode,
                     **shapes), shapes


def _load_state(args, cfg, shapes, handler):
    import torch

    from attngan_torch.infer.sampler import InferState, load_infer_state

    if args.checkpoint:
        state = load_infer_state(args.checkpoint, cfg, device="cpu")
        for name, value in shapes.items():
            if getattr(state.cfg, name) != value:
                raise SystemExit(
                    f"--{name.replace('_', '-')} {value} contradicts the "
                    f"checkpoint's {name}={getattr(state.cfg, name)}")
        print(f"restored {args.checkpoint}")
        return state
    print("WARNING: no checkpoint given; using random weights")
    torch.manual_seed(args.seed)
    vocab = handler.vocab_size if handler is not None else BENCH_VOCAB
    return InferState(cfg, vocab)


def _benchmark(sampler, args, windows: int = 5, iters: int = 4) -> dict:
    import numpy as np
    import torch

    cfg = sampler.cfg
    rng = np.random.default_rng(args.seed)
    tokens = torch.as_tensor(rng.integers(
        0, sampler.state.vocab_size, (args.batch_size, cfg.seq_len)))
    lengths = torch.full((args.batch_size,), cfg.seq_len)
    gen = torch.Generator(sampler.device).manual_seed(args.seed)

    def sync():
        if sampler.device.type == "cuda":
            torch.cuda.synchronize(sampler.device)

    imgs = sampler.generate_from_tokens(tokens, lengths, generator=gen)
    sync()                                 # build + warm-up, untimed
    rates = []
    for _ in range(windows):
        start = time.perf_counter()
        for _ in range(iters):
            imgs = sampler.generate_from_tokens(tokens, lengths, generator=gen)
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
            "compute_dtype": cfg.compute_dtype,
            "fused_upsample": cfg.fused_upsample}


def main(argv=None):
    args = parse_args(argv)
    if not args.benchmark and not args.image_names:
        raise SystemExit("pass --image-names (or --benchmark)")
    from attngan_torch.data.captions import CaptionHandler
    from attngan_torch.infer.sampler import Sampler
    from attngan_torch.utils.imaging import save_image

    handler = None
    if args.image_names or os.path.exists(args.captions_path):
        handler = CaptionHandler(args.captions_path)
    cfg, shapes = _config(args)
    state = _load_state(args, cfg, shapes, handler)
    sampler = Sampler(state, caption_handler=handler, device=args.device)

    if args.benchmark:
        print(json.dumps(_benchmark(sampler, args)))
        return
    images = sampler.generate_from_captions(
        handler.get_captions(args.image_names), seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    for name, img in zip(args.image_names, images):
        path = os.path.join(args.out, f"{os.path.basename(name)}.png")
        save_image(img, path)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
