"""Clustering-captioner quality run: port of tools/cluster_quality_run.py.

Measures what the reference only ever judged by eye (its clusterer,
data/bedrooms.py:241-304, from grid plots):

* the silhouette score of every k level of the ladder,
* the adjusted Rand index of each level against the corpus's generative
  factors (the procedural scene corpus, or the photo-patch corpus; none
  for a --data-root of real photos),
* cluster-size balance,
* the reference's own evaluate_clustering grids and a caption-swap demo.

Both metrics are the port's own (data/clusterer.py: ``silhouette_score``,
``adjusted_rand_index``, equal to scikit-learn's), so it runs where
scikit-learn is missing.

    python -m attngan_torch.tools.cluster_quality_run --num-images 512 \\
        --out /tmp/clusterq
    python -m attngan_torch.tools.cluster_quality_run --data-root PHOTOS \\
        --out ...

Prints one JSON summary line at the end.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num-images", type=int, default=512)
    p.add_argument("--data-root", default="",
                   help="real photo directory (recursive .jpg scan); "
                        "default: the procedural scene corpus")
    p.add_argument("--photo-patches", action="store_true",
                   help="the real-photograph patch corpus from the photos "
                        "bundled with scikit-learn / matplotlib (ARI vs "
                        "source photo and quadrant; data/synthetic.py)")
    p.add_argument("--max-images", type=int, default=2000)
    p.add_argument("--latent-dims", type=int, default=128)
    p.add_argument("--max-vocab-size", type=int, default=64)
    p.add_argument("--min-clusters", type=int, default=5)
    p.add_argument("--method", default="agglomerative_complete",
                   choices=["kmeans", "agglomerative_single_linkage",
                            "agglomerative_complete"])
    p.add_argument("--reducer", default="pca",
                   choices=["auto", "umap", "pca", "spectral", "tsne"],
                   help="umap = the native implementation "
                        "(data/umap_native.py); auto = pca")
    p.add_argument("--embedder-weights", default="",
                   help="a ResNet18 state_dict (.pt) from "
                        "attngan_torch.tools.convert_torch_weights resnet18;"
                        " default: seeded random weights")
    p.add_argument("--out", default="cluster_quality")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the GPU")
    return p.parse_args(argv)


def run(args) -> dict:
    import numpy as np
    import torch

    from attngan_torch.data.captions import CaptionHandler
    from attngan_torch.data.clusterer import (
        HierarchicalClusterer,
        adjusted_rand_index,
        determine_k_values,
        reduce_dimensionality,
        silhouette_score,
    )
    from attngan_torch.data.dataset import Dataset
    from attngan_torch.models.resnet import ImageEmbedder

    factors = None
    if args.data_root:
        dataset = Dataset(args.data_root, max_images=args.max_images)
    elif args.photo_patches:
        from attngan_torch.data.synthetic import make_photo_patch_dataset

        dataset, factors = make_photo_patch_dataset(args.num_images,
                                                    seed=args.seed)
    else:
        from attngan_torch.data.synthetic import make_scene_dataset

        dataset, factors = make_scene_dataset(args.num_images, seed=args.seed)
    for rec in dataset.records:         # reset_captions_and_class_ids
        rec.caption, rec.class_id = [], None

    variables = None
    if args.embedder_weights:
        variables = torch.load(args.embedder_weights, map_location="cpu",
                               weights_only=True)
    embedder = ImageEmbedder(variables=variables, seed=args.seed,
                             device=args.device)
    clusterer = HierarchicalClusterer(embedder=embedder, device=args.device)
    x = clusterer.embed_dataset(dataset)
    if args.latent_dims < x.shape[1]:
        x = reduce_dimensionality(x, args.latent_dims, args.reducer,
                                  clusterer.device)
    # cluster the SAME reduced embedding the silhouette is scored against
    # (x is at latent_dims already: the clusterer's own reduction is a
    # no-op), so that a stochastic reducer scores its own labels
    clusterer.cluster(dataset, latent_dims=args.latent_dims,
                      max_vocab_size=args.max_vocab_size,
                      min_clusters=args.min_clusters, method=args.method,
                      embeddings=x, reducer=args.reducer)

    k_values = determine_k_values(args.max_vocab_size, args.min_clusters)
    summary = {"n_images": len(dataset.records), "k_ladder": k_values,
               "method": args.method, "reducer": args.reducer, "levels": []}
    for level, k in enumerate(k_values):
        tokens = [rec.caption[level] for rec in dataset.records]
        labels = np.asarray([int(t.split("c")[1]) for t in tokens])
        sizes = np.bincount(labels)
        level_info = {
            "k": k,
            "silhouette": round(silhouette_score(x, labels), 4),
            "size_max": int(sizes.max()), "size_min": int(sizes.min()),
        }
        if factors is not None:
            level_info["ari_vs_factors"] = {
                name: round(adjusted_rand_index(truth, labels), 4)
                for name, truth in factors.items()}
        summary["levels"].append(level_info)

    os.makedirs(args.out, exist_ok=True)
    # the reference's own check: co-cluster grids of one image
    counts = dataset.evaluate_clustering(0, folder=args.out, max_images=36,
                                         nrow=6)
    summary["grid_member_counts"] = {str(k): v for k, v in counts.items()}

    # the caption-swap demo (the controllability check, reference
    # test.py:105-106)
    caps_path = os.path.join(args.out, "captions.json")
    dataset.save_captions_and_class_ids(caps_path)
    handler = CaptionHandler(caps_path)
    pair = handler.get_captions([dataset.records[0].fpath,
                                 dataset.records[-1].fpath])
    swapped = handler.swap_captions([list(pair[0]), list(pair[1])], num=1)
    summary["caption_swap_demo"] = {"before": pair, "after": swapped}

    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
