#!/usr/bin/env python
"""Adversarial (GAN) training on the GPU: ``python -m attngan_torch.cli.train``.

Port of attngan_tpu/cli/train.py. Loads the dataset and its pseudo-captions,
restores the DAMSM-pretrained text and image encoders (frozen, reference
train.py:88-90) from a port checkpoint, and runs the four-optimizer
adversarial loop: per-resolution discriminator steps, then a generator
step with the adversarial, DAMSM and KL terms. Checkpoints go to
--checkpoint-dir/gan; sample grids, attention strips and loss plots to
--image-dir. ``python -m attngan_torch.cli.infer --checkpoint
<checkpoint-dir>/gan`` serves the result.

--data-root decodes images eagerly with Pillow or, with --stream (on by
itself above 50k records), batch by batch through the native JPEG loader;
the synthetic path needs neither Pillow nor matplotlib. --mesh-shape is a
later slice of the port: argparse refuses it.

Examples:
  python -m attngan_torch.cli.train --synthetic 64 --epochs 2 \\
      --damsm-checkpoint checkpoints/damsm
  python -m attngan_torch.cli.train --synthetic 16 --batch-size 4 \\
      --num-stages 2 --gf-dim 8 --df-dim 8 --emb-dim 32 --seq-len 4 \\
      --image-encoder tiny --epochs 1 --device cpu
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    from attngan_torch.core.config import Config

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-root", default=Config.DATA_ROOT)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--max-images", type=int, default=99999)
    p.add_argument("--stream", action="store_true",
                   help="bounded-memory streaming loader: decode batches on "
                        "demand instead of eagerly holding the whole corpus "
                        "in host RAM; required for LSUN-scale corpora; on "
                        "by itself above 50k records")
    p.add_argument("--captions-path", default=Config.CAPTIONS_JSON)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-stages", type=int, default=3, choices=[1, 2, 3])
    p.add_argument("--gf-dim", type=int, default=32)
    p.add_argument("--df-dim", type=int, default=64)
    p.add_argument("--emb-dim", type=int, default=256)
    p.add_argument("--seq-len", type=int, default=5)
    p.add_argument("--gen-lr", type=float, default=2e-4)
    p.add_argument("--disc-lr", type=float, default=2e-4)
    p.add_argument("--loss-variant", default="non_saturating",
                   choices=["non_saturating", "standard"])
    p.add_argument("--image-encoder", default="inception_v3",
                   choices=["inception_v3", "tiny"])
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--damsm-checkpoint", default="",
                   help="a cli.pretrain checkpoint dir (its newest step) or "
                        "step_* dir to restore the encoders from; none = "
                        "random encoders")
    p.add_argument("--checkpoint-dir", default=Config.CHECKPOINT_DIR)
    p.add_argument("--image-dir", default=Config.IMAGE_DIR)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest GAN checkpoint; epoch "
                        "numbering continues and --epochs is the TOTAL "
                        "epoch count")
    p.add_argument("--checkpoint-every-epochs", type=int, default=1,
                   help="save a checkpoint + sample grid every N epochs "
                        "(and the last; each save is a separate step_* dir)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50,
                   help="print losses + steps/s every N steps")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of steps 2-7")
    p.add_argument("--device", default=None,
                   help="default: the GPU (an error without one); 'cpu' "
                        "runs the plain PyTorch versions of the kernels")
    return p.parse_args(argv)


def load_damsm_encoders(path: str, cfg, vocab_size: int, seq_len: int,
                        device=None):
    """(rnn, cnn) of the DAMSM checkpoint at ``path``: a cli.pretrain
    checkpoint dir (its newest step) or one ``step_*`` dir. Reads only
    ``rnn.pt`` and ``cnn.pt``: the Adam's moments and the step stay on
    disk."""
    from attngan_torch.core.config import DamsmConfig
    from attngan_torch.train.checkpoint import latest_checkpoint, load_part
    from attngan_torch.train.damsm_trainer import DamsmTrainer

    dcfg = DamsmConfig(emb_dim=cfg.emb_dim, image_encoder=cfg.image_encoder,
                       compute_dtype=cfg.compute_dtype)
    trainer = DamsmTrainer(dcfg, vocab_size=vocab_size, seq_len=seq_len,
                           device=device)
    ckpt = latest_checkpoint(path) or path
    state = trainer.init_state(seed=0)
    state.rnn.load_state_dict(load_part(ckpt, "rnn"))
    state.cnn.load_state_dict(load_part(ckpt, "cnn"))
    return state.rnn, state.cnn


def main(argv=None):
    """Returns run_gan_training's (trainer, state, {metric: history})."""
    args = parse_args(argv)
    from attngan_torch.core.config import GanConfig, RunConfig
    from attngan_torch.data.streaming import open_dataset
    from attngan_torch.data.synthetic import make_synthetic_dataset
    from attngan_torch.train.loops import run_gan_training

    if args.synthetic:
        dataset = make_synthetic_dataset(args.synthetic)
    else:
        dataset = open_dataset(args.data_root, max_images=args.max_images,
                               stream=args.stream)
        dataset.load_captions_and_class_ids(args.captions_path)
    dataset.build_vocab()

    cfg = GanConfig(gf_dim=args.gf_dim, df_dim=args.df_dim,
                    emb_dim=args.emb_dim, seq_len=args.seq_len,
                    batch_size=args.batch_size, gen_lr=args.gen_lr,
                    disc_lr=args.disc_lr, epochs=args.epochs,
                    num_stages=args.num_stages, loss_variant=args.loss_variant,
                    image_encoder=args.image_encoder,
                    compute_dtype=args.compute_dtype)
    run_cfg = RunConfig(seed=args.seed, checkpoint_dir=args.checkpoint_dir,
                        log_every=args.log_every,
                        image_dir=args.image_dir, profile=args.profile,
                        checkpoint_every_epochs=args.checkpoint_every_epochs)

    rnn = cnn = None
    if args.damsm_checkpoint:
        rnn, cnn = load_damsm_encoders(
            args.damsm_checkpoint, cfg, dataset.vocab.n_words, args.seq_len,
            device=args.device)
    return run_gan_training(cfg, run_cfg, dataset, rnn=rnn, cnn=cnn,
                            resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
