"""Synthetic in-memory datasets for tests and the chip run.

Port of attngan_tpu/data/synthetic.py (the port imports nothing of the
JAX package): the same seed gives the same pixels, captions and factors in
both. The reference has no test assets (its data paths are
hardcoded Windows directories, bedrooms.py:105). This generator produces
structured fake datasets, so the whole pipeline (DAMSM -> GAN -> inference)
runs end to end without LSUN. Two corpora with known factors measure the
clustering captioner: procedural scenes (``make_scene_dataset``, numpy
only) and patches of the real photographs that ship inside scikit-learn
and matplotlib (``make_photo_patch_dataset``, which needs them and
Pillow; where they are absent, as on the GPU machine,
``find_bundled_photos`` finds nothing and the corpus raises).
"""

from __future__ import annotations

from typing import List

import numpy as np

from attngan_torch.data.dataset import CANONICAL_RES, Dataset, Record


def make_scene_dataset(
    num_images: int = 512,
    seed: int = 0,
    res: int = CANONICAL_RES,
):
    """Procedural 'bedroom-like' scene corpus with KNOWN generative factors.

    LSUN is not fetchable in this environment, so clustering-captioner
    quality is measured on structured scenes instead of color blobs: each
    image is a room with a wall/floor split, a wall color family, a bed
    rectangle whose color/position varies, a window, and a lighting
    gradient. The latent factors are returned per image so cluster quality
    is measurable as agreement (adjusted Rand index) between discovered
    clusters and ground truth — a measurement the reference never had
    (its clusterer, bedrooms.py:241-304, was only ever eyeballed).

    Returns (Dataset, factors) where factors is a dict of int arrays:
    'wall' (6 families), 'bed' (5 colors), 'layout' (3 horizon bands).
    """
    rng = np.random.default_rng(seed)
    wall_palette = np.array([
        [188, 170, 150], [210, 200, 190], [150, 160, 180],
        [170, 185, 160], [200, 175, 185], [160, 150, 140]], np.float32)
    bed_palette = np.array([
        [160, 60, 60], [60, 80, 150], [200, 190, 170],
        [80, 130, 80], [120, 90, 140]], np.float32)
    records: List[Record] = []
    walls = rng.integers(0, len(wall_palette), num_images)
    beds = rng.integers(0, len(bed_palette), num_images)
    layouts = rng.integers(0, 3, num_images)
    yy = np.linspace(0, 1, res, dtype=np.float32)[:, None, None]
    for i in range(num_images):
        wall = wall_palette[walls[i]] * rng.uniform(0.85, 1.15)
        bed = bed_palette[beds[i]] * rng.uniform(0.85, 1.15)
        horizon = int(res * (0.45 + 0.12 * layouts[i]))
        img = np.empty((res, res, 3), np.float32)
        img[:horizon] = wall
        img[horizon:] = wall * 0.55 + 40.0          # darker floor
        # window: bright rectangle on the wall
        wx = rng.integers(res // 10, res // 2)
        ww, wh = res // 5, horizon // 3
        img[wh: 2 * wh, wx: wx + ww] = [235, 240, 245]
        # bed: rectangle straddling the horizon
        bx = rng.integers(res // 8, res // 2)
        bw = rng.integers(res // 3, res // 2)
        bh = res // 4
        img[horizon - bh // 3: horizon + bh, bx: bx + bw] = bed
        # headboard
        img[horizon - bh // 2: horizon - bh // 3, bx: bx + bw] = bed * 0.6
        # lighting gradient + sensor noise
        img = img * (0.8 + 0.4 * (1.0 - yy))
        img = img + rng.normal(0, 6, img.shape)
        records.append(Record(
            fpath=f"scenes/{i:05d}.jpg",
            pixels=np.clip(img, 0, 255).astype(np.uint8)))
    dataset = Dataset(records=records)
    return dataset, {"wall": walls, "bed": beds, "layout": layouts}


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


def find_bundled_photos() -> "dict[str, str]":
    """Paths of real photographs shipped inside the baked-in python
    packages (the only real-photo bytes reachable without egress):
    sklearn's china.jpg / flower.jpg sample images and matplotlib's
    grace_hopper.jpg. Returns {name: path} for the ones present. The
    packages are found, not imported."""
    import importlib.util
    import os

    def package_dir(name):
        spec = importlib.util.find_spec(name)
        return spec.submodule_search_locations[0] if spec else None

    candidates = {}
    sklearn_dir = package_dir("sklearn")
    if sklearn_dir:
        for name in ("china", "flower"):
            candidates[name] = os.path.join(sklearn_dir, "datasets", "images",
                                            f"{name}.jpg")
    mpl_dir = package_dir("matplotlib")
    if mpl_dir:
        candidates["hopper"] = os.path.join(mpl_dir, "mpl-data", "sample_data",
                                            "grace_hopper.jpg")
    return {name: p for name, p in candidates.items() if os.path.exists(p)}


def make_photo_patch_dataset(
    num_images: int = 384,
    seed: int = 0,
    res: int = CANONICAL_RES,
):
    """REAL-photograph corpus with known factors for clustering quality.

    LSUN is not fetchable here, so this carves ``num_images`` random
    square patches (random scale + position, 50% mirrored) out of the
    real photographs bundled with sklearn/matplotlib — actual camera
    sensor data with natural texture, lighting, and color statistics,
    unlike the procedural scene corpus. Ground truth for ARI: 'photo'
    (source photograph) and 'region' (2x2 quadrant of the patch center —
    a weaker within-photo factor).

    Returns (Dataset, factors) like make_scene_dataset.
    """
    from PIL import Image

    photos = find_bundled_photos()
    if not photos:
        raise RuntimeError("no bundled real photos found "
                           "(sklearn/matplotlib missing)")
    names = sorted(photos)
    arrays = []
    for n in names:
        with Image.open(photos[n]) as im:
            arrays.append(np.asarray(im.convert("RGB")))
    rng = np.random.default_rng(seed)
    records: List[Record] = []
    photo_ids = rng.integers(0, len(arrays), num_images)
    regions = np.empty(num_images, np.int64)
    for i in range(num_images):
        src = arrays[photo_ids[i]]
        h, w = src.shape[:2]
        side = int(rng.integers(160, min(h, w) + 1))
        y = int(rng.integers(0, h - side + 1))
        x = int(rng.integers(0, w - side + 1))
        cy, cx = (y + side // 2) * 2 // h, (x + side // 2) * 2 // w
        regions[i] = min(cy, 1) * 2 + min(cx, 1)
        patch = src[y: y + side, x: x + side]
        if rng.random() < 0.5:
            patch = patch[:, ::-1]
        img = Image.fromarray(patch).resize((res, res), Image.BILINEAR)
        records.append(Record(
            fpath=f"photo_patches/{names[photo_ids[i]]}_{i:05d}.jpg",
            pixels=np.asarray(img, np.uint8)))
    dataset = Dataset(records=records)
    return dataset, {"photo": photo_ids, "region": regions}
