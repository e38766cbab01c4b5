"""Write the real-photograph patch corpus to disk as .jpg files: port of
tools/make_photo_corpus.py.

The reference trains on a DIRECTORY of photographs (pretrain_damsm.py:
48-53, a recursive .jpg scan). This writes the corpus that
data/synthetic.py::make_photo_patch_dataset carves from the photographs
bundled with scikit-learn / matplotlib (random-scale patches) as JPEG
files, so the whole pipeline can run on it through the CLIs:

    python -m attngan_torch.tools.make_photo_corpus --num-images 384 \\
        --out /tmp/photo_corpus
    python -m attngan_torch.cli.pretrain --data-root /tmp/photo_corpus \\
        --cluster ...

Also writes factors.json ({name: {photo, region}}), so that clustering
quality on the same corpus stays measurable (ARI against the source
photo). Where neither package ships its sample photos (neither is
installed), it exits non-zero and says so.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num-images", type=int, default=384)
    p.add_argument("--out", default="photo_corpus")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quality", type=int, default=95)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from PIL import Image

    from attngan_torch.data.synthetic import (
        find_bundled_photos,
        make_photo_patch_dataset,
    )

    args = parse_args(argv)
    if not find_bundled_photos():
        raise SystemExit("no bundled photographs: neither scikit-learn's "
                         "sample images nor matplotlib's sample data is "
                         "installed here, so there is no corpus to write")
    dataset, factors = make_photo_patch_dataset(args.num_images,
                                                seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    meta = {}
    for i, rec in enumerate(dataset.records):
        name = os.path.basename(rec.fpath)          # e.g. china_00012.jpg
        Image.fromarray(rec.pixels).save(os.path.join(args.out, name),
                                         quality=args.quality)
        meta[name] = {"photo": int(factors["photo"][i]),
                      "region": int(factors["region"][i])}
    with open(os.path.join(args.out, "factors.json"), "w") as f:
        json.dump(meta, f)
    print(f"wrote {len(meta)} patches to {args.out}")
    return meta


if __name__ == "__main__":
    main()
