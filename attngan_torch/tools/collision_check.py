"""Show that the DAMSM same-class exclusion mask is ACTIVE on a corpus:
port of tools/collision_check.py.

The loss-side same-class masking (reference words_loss.py:44-47,
sentence_loss.py:17-25; losses/damsm.py) does nothing on a corpus whose
class ids are all distinct. On a corpus clustered with a capped ladder
(``cli.pretrain --cluster --max-vocab-size 32``) many records share a class
id; this takes batches of that corpus through a trained DAMSM checkpoint
and reports, a batch:

* how many off-diagonal (text, image) pairs the class mask excludes;
* the word + sentence loss WITH the mask (the product's semantics) and
  ABLATED (class_ids=None: every mismatched pair a negative).

A nonzero collision count with differing losses shows the exclusion path
runs on real data. Prints one JSON line a batch and a summary line; exits
non-zero when no batch had a collision.

    python -m attngan_torch.tools.collision_check --checkpoint CKPT/damsm \\
        --captions-path caps.json --data-root IMAGES
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="DAMSM checkpoint dir (holding step_*)")
    p.add_argument("--captions-path", required=True)
    p.add_argument("--data-root", required=True)
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the GPU")
    return p.parse_args(argv)


def main(argv=None) -> list:
    import numpy as np
    import torch

    from attngan_torch.core.config import DamsmConfig
    from attngan_torch.data.dataset import word_mask
    from attngan_torch.data.streaming import open_dataset
    from attngan_torch.losses.damsm import damsm_loss
    from attngan_torch.train.checkpoint import (
        latest_checkpoint,
        load_config_sidecar,
        load_part,
    )
    from attngan_torch.train.damsm_trainer import DamsmTrainer

    args = parse_args(argv)
    dataset = open_dataset(args.data_root)
    dataset.load_captions_and_class_ids(args.captions_path)
    dataset.build_vocab()
    seq_len = max(dataset.max_seqlen, 1)

    sidecar = load_config_sidecar(args.checkpoint) or {}
    cfg = DamsmConfig(**{k: sidecar[k] for k in
                         ("emb_dim", "image_encoder", "batch_size",
                          "compute_dtype") if k in sidecar})
    trainer = DamsmTrainer(cfg, vocab_size=dataset.vocab.n_words,
                           seq_len=seq_len, device=args.device)
    state = trainer.init_state(seed=0)
    ckpt = latest_checkpoint(args.checkpoint) or args.checkpoint
    state.rnn.load_state_dict(load_part(ckpt, "rnn"))
    state.cnn.load_state_dict(load_part(ckpt, "cnn"))
    device = trainer.device

    def losses_with_and_without_mask(batch):
        regions, cnn_code = trainer.encode_image(state, batch["img256"])
        words, sents = trainer.encode_text(state, batch["tokens"],
                                           batch["lengths"])
        labels = torch.arange(batch["tokens"].shape[0], device=device)
        mask = word_mask(batch["lengths"].to(device), seq_len)
        with torch.no_grad():
            return [damsm_loss(regions, cnn_code, words, sents, labels, mask,
                               class_ids, cfg.gamma1, cfg.gamma2, cfg.gamma3,
                               cfg.wlambda, cfg.slambda,
                               attention_maps=False)[:2]
                    for class_ids in (batch["class_ids"], None)]

    total_collisions = 0
    rows = []
    it = dataset.iter_batches(args.batch_size, seq_len, seed=args.seed)
    for i, host in enumerate(it):
        if i >= args.batches:
            break
        batch = dataset.device_batch(host, device)
        cids = np.asarray(host["class_ids"])
        collisions = int((cids[:, None] == cids[None, :]).sum() - len(cids))
        total_collisions += collisions
        (masked, pm), (ablated, pa) = losses_with_and_without_mask(batch)
        row = {
            "batch": i,
            "excluded_offdiag_pairs": collisions,
            "distinct_classes": int(len(np.unique(cids))),
            "loss_masked": round(float(masked), 5),
            "loss_ablated": round(float(ablated), 5),
            "delta": round(float(ablated) - float(masked), 5),
            "words_delta": round(float(pa["words_loss"])
                                 - float(pm["words_loss"]), 5),
            "sent_delta": round(float(pa["sentence_loss"])
                                - float(pm["sentence_loss"]), 5),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    active = total_collisions > 0 and any(r["delta"] != 0.0 for r in rows)
    rows.append({
        "summary": "same-class exclusion mask "
                   + ("ACTIVE on real data" if active else "NOT exercised"),
        "total_excluded_pairs": total_collisions,
        "batches": len(rows),
    })
    print(json.dumps(rows[-1]), flush=True)
    if not active:
        sys.exit(1)
    return rows


if __name__ == "__main__":
    main()
