"""Synthetic in-memory datasets for tests and the chip run.

Port of the numpy-only part of attngan_tpu/data/synthetic.py (the port
imports nothing of the JAX package): the same seed gives the same pixels
and captions in both. The reference has no test assets (its data paths are
hardcoded Windows directories, bedrooms.py:105). This generator produces
structured fake datasets, so the whole pipeline (DAMSM -> GAN -> inference)
runs end to end without LSUN. The scene corpus with known factors and the
photo-patch corpus (Pillow and scikit-learn's sample images), both made
to measure the clustering captioner, wait for the clusterer's slice.
"""

from __future__ import annotations

from typing import List

import numpy as np

from attngan_torch.data.dataset import CANONICAL_RES, Dataset, Record


def make_synthetic_dataset(
    num_images: int = 32,
    num_classes: int = 4,
    seed: int = 0,
    with_captions: bool = True,
    levels: int = 2,
    res: int = CANONICAL_RES,
) -> Dataset:
    rng = np.random.default_rng(seed)
    records: List[Record] = []
    for i in range(num_images):
        cls = i % num_classes
        base = np.zeros((res, res, 3), np.float32)
        base[..., cls % 3] = 120 + 40 * (cls // 3)      # class-correlated hue
        noise = rng.normal(0, 30, (res, res, 3))
        pixels = np.clip(base + noise + 80, 0, 255).astype(np.uint8)
        rec = Record(fpath=f"synthetic/{i:05d}.jpg", pixels=pixels)
        if with_captions:
            # mimic the clusterer's coarse->fine "k{k}c{c}" token ladder
            rec.caption = [f"k{2 ** (lvl + 1)}c{cls % (2 ** (lvl + 1))}"
                           for lvl in range(levels)]
            rec.class_id = cls
        records.append(rec)
    return Dataset(records=records)
