#!/usr/bin/env python
"""DAMSM pretraining on the GPU: ``python -m attngan_torch.cli.pretrain``.

Port of attngan_tpu/cli/pretrain.py. Builds the dataset (synthetic, or the
images under --data-root, decoded eagerly or, with --stream or above 50k
records, batch by batch), gives it pseudo-captions (with --cluster, the
clustering captioner: a seeded ResNet-18 embeds every image on the GPU,
the embeddings are reduced and clustered at a ladder of k, and the
captions JSON is written to --captions-path; else the captions of
--captions-path), then trains the BiLSTM text encoder and the image
encoder's heads with the DAMSM word and sentence losses, the words loss
through the hand-written kernels. Checkpoints go to --checkpoint-dir/damsm,
loss plots to --image-dir. A synthetic run writes its captions to
--captions-path, from which the GAN and serving phases rebuild the same
vocabulary.

The JAX CLI's pretrain options are here: --cache-features (the frozen
trunk's features computed once, the steps trained against them),
--superbatch K (one trunk forward for K steps), --trunk-train-mode-bn (the
reference's train-mode trunk BatchNorm) and --pretrained-cnn (a
torchvision Inception-v3 .pth, read by name: no conversion step).

--data-root decodes images with the native JPEG loader or Pillow; the
synthetic path needs neither Pillow nor matplotlib, and --cluster needs
scipy but not scikit-learn (unless --reducer spectral or tsne). The JAX
CLI's --trunk-int8 is a later slice of the port: argparse refuses it.

Under ``torchrun`` each rank is one process (its own card, or several
sharing one over gloo), --batch-size is the global batch, and
--mesh-shape picks the ranks as the JAX CLI picks devices; rank 0 writes
the captions JSON, the checkpoints and the plots.

Examples:
  python -m attngan_torch.cli.pretrain --data-root /data/bedrooms \\
      --cluster --stream --epochs 30
  python -m attngan_torch.cli.pretrain --synthetic 128 --epochs 2
  python -m attngan_torch.cli.pretrain --synthetic 512 --cache-features \\
      --pretrained-cnn inception_v3_google.pth
  python -m attngan_torch.cli.pretrain --synthetic 16 --batch-size 4 \\
      --epochs 1 --emb-dim 32 --image-encoder tiny --device cpu
  torchrun --standalone --nproc-per-node 2 -m attngan_torch.cli.pretrain \\
      --synthetic 128 --epochs 2 --mesh-shape 2
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    from attngan_torch.core.config import Config

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-root", default=Config.DATA_ROOT)
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic images instead of --data-root")
    p.add_argument("--max-images", type=int, default=99999)
    p.add_argument("--stream", action="store_true",
                   help="bounded-memory streaming loader: decode batches on "
                        "demand (native C++ thread-pool decoder, overlapped "
                        "with training via prefetch) instead of eagerly "
                        "holding the whole corpus in host RAM; required "
                        "for LSUN-scale corpora; on by itself above 50k "
                        "records")
    p.add_argument("--captions-path", default=Config.CAPTIONS_JSON)
    p.add_argument("--cluster", action="store_true",
                   help="run the clustering captioner (else load captions "
                        "JSON)")
    p.add_argument("--cluster-method", default="agglomerative_complete",
                   choices=["kmeans", "agglomerative_single_linkage",
                            "agglomerative_complete"])
    p.add_argument("--latent-dims", type=int, default=128)
    p.add_argument("--reducer", default="auto",
                   choices=["auto", "umap", "pca", "spectral", "tsne"],
                   help="embedding reducer before clustering; umap = the "
                        "native implementation (data/umap_native.py); "
                        "spectral and tsne need scikit-learn; auto = pca, "
                        "the measured real-photo default")
    p.add_argument("--min-clusters", type=int, default=5)
    p.add_argument("--max-vocab-size", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--emb-dim", type=int, default=256)
    p.add_argument("--image-encoder", default="inception_v3",
                   choices=["inception_v3", "tiny"])
    p.add_argument("--pretrained-cnn", default="",
                   help="torchvision Inception-v3 state_dict (.pth, loaded "
                        "by name: the trunk has torchvision's keys)")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--cache-features", action="store_true",
                   help="precompute frozen-trunk region features once and "
                        "train against the cache (removes the Inception "
                        "forward from every step)")
    p.add_argument("--superbatch", type=int, default=1,
                   help="amortize the frozen trunk: run it once at "
                        "superbatch*batch_size images, then do that many "
                        "sequential batch_size contrastive steps (exact "
                        "step semantics, fewer trunk launches)")
    p.add_argument("--checkpoint-dir", default=Config.CHECKPOINT_DIR)
    p.add_argument("--image-dir", default=Config.IMAGE_DIR)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint (exact resume: "
                        "weights, optimizer state, step, generator state); "
                        "epoch numbering continues and --epochs is the "
                        "TOTAL epoch count")
    p.add_argument("--checkpoint-every-epochs", type=int, default=1,
                   help="save a checkpoint every N epochs (and the last)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trunk-train-mode-bn", action="store_true",
                   help="reproduce the reference quirk: frozen Inception "
                        "trunk runs with train-mode BatchNorm (the reference "
                        "never calls eval() on it, pretrain_damsm.py:59-73)")
    p.add_argument("--log-every", type=int, default=50,
                   help="print loss + steps/s every N steps")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of steps 2-7")
    p.add_argument("--device", default=None,
                   help="default: the GPU (an error without one); 'cpu' "
                        "runs the plain PyTorch versions of the kernels")
    p.add_argument("--mesh-shape", type=int, nargs="*", default=[],
                   help="device mesh shape: empty=auto 1-D; one int=1-D over "
                        "n devices; two ints=2-D (slices, chips) multi-slice"
                        " (ranks of a torchrun launch; the batch is global)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns run_damsm_training's (trainer, state, loss history)."""
    args = parse_args(argv)
    from attngan_torch.parallel.mesh import launched

    with launched(args.device) as device:
        return _main(args, device)


def _main(args, device):
    from attngan_torch.core.config import DamsmConfig, RunConfig
    from attngan_torch.data.streaming import open_dataset
    from attngan_torch.data.synthetic import make_synthetic_dataset
    from attngan_torch.parallel.mesh import global_rank
    from attngan_torch.train.loops import run_damsm_training

    if args.stream and args.cache_features:
        raise SystemExit(
            "--stream and --cache-features are incompatible: the feature "
            "cache holds ~300 KB/image in host RAM, which defeats the "
            "streaming loader's bounded-memory guarantee; drop one")
    if args.synthetic:
        dataset = make_synthetic_dataset(args.synthetic,
                                         with_captions=not args.cluster)
    else:
        dataset = open_dataset(args.data_root, max_images=args.max_images,
                               stream=args.stream)

    if args.cluster:
        from attngan_torch.data.clusterer import HierarchicalClusterer

        for rec in dataset.records:     # reset_captions_and_class_ids
            rec.caption, rec.class_id = [], None
        HierarchicalClusterer(device=device).cluster(
            dataset, latent_dims=args.latent_dims,
            max_vocab_size=args.max_vocab_size,
            min_clusters=args.min_clusters, method=args.cluster_method,
            reducer=args.reducer)
    if args.cluster or args.synthetic:
        # clustered or synthetic captions live in memory; persist them so
        # the GAN and serving phases can rebuild the same vocab from JSON
        if global_rank() == 0:
            os.makedirs(os.path.dirname(args.captions_path) or ".",
                        exist_ok=True)
            dataset.save_captions_and_class_ids(args.captions_path)
    else:
        dataset.load_captions_and_class_ids(args.captions_path)

    cfg = DamsmConfig(emb_dim=args.emb_dim, batch_size=args.batch_size,
                      lr=args.lr, epochs=args.epochs,
                      image_encoder=args.image_encoder,
                      compute_dtype=args.compute_dtype,
                      cache_region_features=args.cache_features,
                      superbatch=args.superbatch,
                      trunk_train_mode_bn=args.trunk_train_mode_bn)
    run_cfg = RunConfig(seed=args.seed, checkpoint_dir=args.checkpoint_dir,
                        log_every=args.log_every,
                        image_dir=args.image_dir, profile=args.profile,
                        checkpoint_every_epochs=args.checkpoint_every_epochs,
                        mesh_shape=tuple(args.mesh_shape))
    pretrained = None
    if args.pretrained_cnn:
        from attngan_torch.convert import load_pretrained_trunk

        pretrained = load_pretrained_trunk(args.pretrained_cnn)
    return run_damsm_training(cfg, run_cfg, dataset, resume=args.resume,
                              device=device, pretrained_cnn=pretrained)


if __name__ == "__main__":
    main()
