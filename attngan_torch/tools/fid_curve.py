"""FID against training step over a GAN run's checkpoints: port of
tools/fid_curve.py.

Walks every step_* dir under --checkpoint, samples the SAME caption batch
with the SAME noise seeds through each restored generator, and scores it
against the SAME real images with the calibrated featurizer (eval/fid.py).
A healthy run gives a falling curve; a flat or random one means the
harness (or the run) is broken.

    python -m attngan_torch.tools.fid_curve --checkpoint RUN/ckpt/gan \\
        --captions-path RUN/caps.json --data-root IMAGES --out fid_curve

Prints one JSON line a checkpoint and a summary line; writes
fid_curve.json (and fid_curve.png where matplotlib is installed) to --out.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="GAN checkpoint dir holding step_* saves")
    p.add_argument("--captions-path", required=True)
    p.add_argument("--data-root", required=True,
                   help="real image directory (the training corpus)")
    p.add_argument("--n", type=int, default=256,
                   help="generated images per sampling seed")
    p.add_argument("--max-real", type=int, default=768)
    p.add_argument("--feature-batch", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seeds", type=int, default=3,
                   help="independent sampling seeds per checkpoint; the "
                        "curve reports mean +/- spread over them")
    p.add_argument("--out", default="fid_curve")
    p.add_argument("--device", default=None, help="default: the GPU")
    return p.parse_args(argv)


def _plot(curve, seeds: int, path: str) -> None:
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.errorbar([c["step"] for c in curve], [c["fid"] for c in curve],
                yerr=[c["fid_std"] for c in curve], marker="o", capsize=3)
    ax.set_xlabel("training step")
    ax.set_ylabel("FID (calibrated-random-feature units)")
    ax.set_title(f"FID vs training step (mean +/- std, {seeds} seeds)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None) -> dict:
    import numpy as np
    import torch

    from attngan_torch.core.runtime import resolve_device
    from attngan_torch.data.captions import CaptionHandler
    from attngan_torch.eval.fid import (
        FIDEvaluator,
        activation_statistics,
        frechet_distance,
    )
    from attngan_torch.infer.sampler import Sampler
    from attngan_torch.tools.int8_fid_run import gan_config, real_images
    from attngan_torch.train.checkpoint import restore_inference_state

    args = parse_args(argv)
    device = resolve_device(args.device)
    steps = sorted(glob.glob(os.path.join(args.checkpoint, "step_*")))
    if not steps:
        raise SystemExit(f"no step_* checkpoints under {args.checkpoint}")
    handler = CaptionHandler(args.captions_path)
    cfg = gan_config(args.checkpoint)

    # fixed conditioning: the corpus's OWN captions, one batch reused for
    # every checkpoint, so that the curve isolates the weights
    names = sorted(handler.img2caption)[: args.n]
    captions = [handler.img2caption[n] for n in names]
    while len(captions) < args.n:           # tile a small corpus
        captions.append(captions[len(captions) % max(len(names), 1)])
    tokens, lengths = handler.preprocess(captions, max_seqlen=cfg.seq_len)

    real = real_images(args.data_root, args.max_real, device)
    ev = FIDEvaluator(batch_size=args.feature_batch, device=device)
    mu_r, sig_r = activation_statistics(ev.features(real))
    print(f"real set: {real.shape[0]} images from {args.data_root}",
          flush=True)

    curve = []
    for path in steps:
        sampler = Sampler(restore_inference_state(path, cfg), device=device)
        fids = []
        for s in range(args.seeds):   # noise draws; same captions, weights
            gen = torch.Generator(device).manual_seed(args.seed + s)
            fakes = sampler.generate_from_tokens(tokens, lengths,
                                                 generator=gen)
            mu_f, sig_f = activation_statistics(
                ev.features(fakes.float() * 2.0 - 1.0))   # trunk's domain
            fids.append(frechet_distance(mu_r, sig_r, mu_f, sig_f))
        curve.append({
            "step": int(os.path.basename(path).split("_")[1]),
            "fid": round(float(np.mean(fids)), 4),
            "fid_std": round(float(np.std(fids)), 4),
            "fid_seeds": [round(float(f), 4) for f in fids],
        })
        print(json.dumps(curve[-1]), flush=True)

    os.makedirs(args.out, exist_ok=True)
    summary = {"checkpoint": args.checkpoint, "n_fake": int(len(tokens)),
               "n_seeds": args.seeds, "n_real": int(real.shape[0]),
               "resolution": cfg.resolutions[-1],
               "units": "calibrated-random-feature (standard units need "
                        "torchvision's weights)",
               "curve": curve,
               "decreasing": curve[0]["fid"] > curve[-1]["fid"]}
    with open(os.path.join(args.out, "fid_curve.json"), "w") as f:
        json.dump(summary, f, indent=2)
    _plot(curve, args.seeds, os.path.join(args.out, "fid_curve.png"))
    print(json.dumps({"first": curve[0], "last": curve[-1],
                      "decreasing": summary["decreasing"]}), flush=True)
    return summary


if __name__ == "__main__":
    main()
