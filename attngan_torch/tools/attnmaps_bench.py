"""Attention-map extraction against the reference's one published number:
port of tools/attnmaps_bench.py.

The reference's only performance figure is the comment "44 seconds for
1000 images" (~23 img/s) on its ``populate_attnmaps`` (reference
pretrain_damsm.py:85-107,148): for every batch, the frozen trunk and the
text LSTM, each image's attention over its OWN caption, the maps copied to
host objects. This times the port's equivalent at the same unit of work,
``DamsmTrainer.iter_attention_maps`` (host batching, the copy to the
device, the pyramid, the trunk, the BiLSTM and the masked DAMSM attention,
the maps read back to host numpy a batch: the readback fences the clock).
``--png`` also times ``populate_attention_maps``, which writes PNGs (the
reference wrote no files).

    python -m attngan_torch.tools.attnmaps_bench --n 1024
    python -m attngan_torch.tools.attnmaps_bench --n 1024 --png

Prints one JSON line a measurement, vs_reference = rate / (1000 / 44).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

REFERENCE_IMG_PER_SEC = 1000.0 / 44.0   # reference pretrain_damsm.py:148


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=1024,
                   help="images to extract (the reference quotes 1000)")
    p.add_argument("--batch-size", type=int, default=64,
                   help="reference DAMSM batch (pretrain_damsm.py:41)")
    p.add_argument("--emb-dim", type=int, default=256)
    p.add_argument("--image-encoder", default="inception_v3",
                   help="inception_v3 = the reference trunk; tiny for smoke")
    p.add_argument("--levels", type=int, default=7,
                   help="caption ladder depth (the reference's vocabulary "
                        "of 1000 gives a ~7-token ladder)")
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--png", action="store_true",
                   help="also time the PNG-writing path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the GPU")
    return p.parse_args(argv)


def main(argv=None) -> list:
    from attngan_torch.core.config import DamsmConfig
    from attngan_torch.data.synthetic import make_synthetic_dataset
    from attngan_torch.train.damsm_trainer import DamsmTrainer

    args = parse_args(argv)
    # one more batch for the warm-up, so that the timed part is steady
    n_total = args.n + args.batch_size
    dataset = make_synthetic_dataset(n_total, num_classes=8, seed=args.seed,
                                     levels=args.levels)
    dataset.build_vocab()
    cfg = DamsmConfig(emb_dim=args.emb_dim, batch_size=args.batch_size,
                      image_encoder=args.image_encoder,
                      compute_dtype=args.compute_dtype)
    trainer = DamsmTrainer(cfg, vocab_size=dataset.vocab.n_words,
                           seq_len=dataset.max_seqlen, device=args.device)
    state = trainer.init_state(seed=args.seed)
    next(trainer.iter_attention_maps(state, dataset,
                                     batch_size=args.batch_size, limit=1))

    lines = []
    start = time.perf_counter()
    count = sum(1 for _ in trainer.iter_attention_maps(
        state, dataset, batch_size=args.batch_size, limit=args.n))
    dt = time.perf_counter() - start
    rate = count / dt
    lines.append({
        "metric": "attnmap_images_per_sec", "value": round(rate, 1),
        "unit": "img/s", "images": count, "batch_size": args.batch_size,
        "image_encoder": args.image_encoder, "seconds": round(dt, 2),
        "reference_img_per_sec": round(REFERENCE_IMG_PER_SEC, 1),
        "vs_reference": round(rate / REFERENCE_IMG_PER_SEC, 1)})
    print(json.dumps(lines[-1]), flush=True)

    if args.png:
        with tempfile.TemporaryDirectory() as folder:
            start = time.perf_counter()
            written = trainer.populate_attention_maps(
                state, dataset, folder=folder, batch_size=args.batch_size,
                limit=args.n)
            dt = time.perf_counter() - start
        rate = written / dt
        lines.append({
            "metric": "attnmap_png_images_per_sec", "value": round(rate, 1),
            "unit": "img/s", "images": written, "seconds": round(dt, 2),
            "vs_reference": round(rate / REFERENCE_IMG_PER_SEC, 1)})
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
