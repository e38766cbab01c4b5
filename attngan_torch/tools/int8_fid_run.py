"""int8 against float serving FID on a trained GAN checkpoint: port of
tools/int8_fid_run.py.

Restores the checkpoint as ``cli.infer`` does, samples one batch of
captions through the float Sampler and the Int8Sampler, and prints the
FID shift int8 brings (eval/fid.py::int8_vs_bf16_fid), with the absolute
FIDs against ``--real-dir`` images where given.

    python -m attngan_torch.tools.int8_fid_run --checkpoint checkpoints/gan \\
        --captions-path data/caps.json [--real-dir IMAGES] [--n 64]
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="GAN checkpoint dir (its newest step_*) or a step")
    p.add_argument("--captions-path", required=True)
    p.add_argument("--real-dir", default="",
                   help="directory of real images for absolute FIDs "
                        "(omitted: only the int8-vs-float shift)")
    p.add_argument("--n", type=int, default=64, help="images per arm")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--feature-batch", type=int, default=32)
    p.add_argument("--int8-percentile", type=float, default=99.0,
                   help="int8 activation-scale calibration percentile "
                        "(100 = pure max)")
    p.add_argument("--device", default=None, help="default: the GPU")
    return p.parse_args(argv)


def gan_config(checkpoint: str, compute_dtype: str | None = None):
    """The GanConfig of the GAN run at ``checkpoint``: the shapes and image
    encoder its config.json records, ``compute_dtype`` (default: the
    recorded one, else bf16)."""
    from attngan_torch.core.config import GanConfig, SHAPE_FIELDS
    from attngan_torch.train.checkpoint import load_config_sidecar

    sidecar = load_config_sidecar(checkpoint) or {}
    return GanConfig(
        **{k: sidecar[k] for k in SHAPE_FIELDS if k in sidecar},
        image_encoder=sidecar.get("image_encoder", "inception_v3"),
        compute_dtype=compute_dtype or sidecar.get("compute_dtype",
                                                   "bfloat16"))


def real_images(root: str, n: int, device):
    """Up to ``n`` images of ``root`` as 256^2 NHWC in [-1, 1], unflipped."""
    import numpy as np
    import torch

    from attngan_torch.data.dataset import Dataset, preprocess_pyramid

    ds = Dataset(root, max_images=n)
    pix = torch.as_tensor(np.stack([r.pixels for r in ds.records[:n]]),
                          device=device)
    flip = torch.zeros(pix.shape[0], dtype=torch.bool, device=device)
    return preprocess_pyramid(pix, flip)[256]


def main(argv=None) -> dict:
    import numpy as np
    import torch

    from attngan_torch.core.runtime import resolve_device
    from attngan_torch.data.captions import CaptionHandler
    from attngan_torch.eval.fid import FIDEvaluator, int8_vs_bf16_fid
    from attngan_torch.train.checkpoint import (
        latest_checkpoint,
        restore_inference_state,
    )

    args = parse_args(argv)
    device = resolve_device(args.device)
    handler = CaptionHandler(args.captions_path)
    ckpt = latest_checkpoint(args.checkpoint) or args.checkpoint
    state = restore_inference_state(ckpt, gan_config(args.checkpoint,
                                                     "bfloat16"))
    if state.vocab_size != handler.vocab_size:
        raise SystemExit(f"{args.captions_path} gives a vocabulary of "
                         f"{handler.vocab_size} words; {ckpt} was trained "
                         f"with {state.vocab_size}")
    print(f"restored {ckpt}", flush=True)
    rng = np.random.default_rng(args.seed)
    seq_len = state.cfg.seq_len
    tokens = torch.as_tensor(
        rng.integers(0, handler.vocab_size, (args.n, seq_len)),
        dtype=torch.int32)
    lengths = torch.full((args.n,), seq_len, dtype=torch.int32)
    real = real_images(args.real_dir, args.n, device) if args.real_dir \
        else None
    ev = FIDEvaluator(batch_size=args.feature_batch, device=device)
    out = int8_vs_bf16_fid(state, tokens, lengths, seed=args.seed,
                           real_images=real, evaluator=ev,
                           int8_percentile=args.int8_percentile,
                           device=device)
    line = {k: round(float(v), 4) for k, v in out.items()}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
