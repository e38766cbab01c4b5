"""Human-captioned dataset loaders (legacy pipeline capability): port of
attngan_tpu/data/captioned.py.

Reference: data/preprocessor.py:18-189 — the pre-clustering data path where
captions come from humans instead of the clusterer: a folder-name ->
caption-string lookup for architecture photos (BuildingsDataset, :37-104)
and a CSV-indexed captioned dataset (:106-189). The live bedrooms pipeline
replaced these, but the capability (training on real captions) is kept:

* ``folder_caption_dataset``: per-class-folder caption lookup; class_id =
  folder index; comma/space tokenization.
* ``csv_caption_dataset``: an index file of ``filename,caption text`` rows.

Both return the standard Dataset so every downstream phase (DAMSM, GAN,
inference) works unchanged. The reference's 25-entry architecture lookup
table is user data, not framework code — callers pass their own mapping.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

from attngan_torch.data.dataset import Dataset, Record, decode_image


def tokenize_caption(text: str) -> List[str]:
    """Split on commas and whitespace (reference splits captions on ','
    with comma-joined token strings, preprocessor.py:30-31, 205-209)."""
    return [tok for chunk in text.split(",") for tok in chunk.split() if tok]


def folder_caption_dataset(
    imagedir: str,
    caption_lookup: Dict[str, str],
    max_images: int = 99999,
    flip_augment: bool = True,
) -> Dataset:
    """Images under per-class folders; each folder maps to one caption
    string and one class id (reference BuildingsDataset.make_data)."""
    records: List[Record] = []
    for class_id, folder in enumerate(sorted(os.listdir(imagedir))):
        folder_path = os.path.join(imagedir, folder)
        if not os.path.isdir(folder_path) or folder not in caption_lookup:
            continue
        caption = tokenize_caption(caption_lookup[folder])
        for fname in sorted(os.listdir(folder_path)):
            path = os.path.join(folder_path, fname)
            try:
                pixels = decode_image(path)
            except OSError:
                continue
            records.append(Record(path, pixels, caption=list(caption),
                                  class_id=class_id))
            if flip_augment:
                records.append(Record(f"{path}_r", pixels, flip=True,
                                      caption=list(caption),
                                      class_id=class_id))
            if len(records) >= max_images:
                return Dataset(records=records)
    return Dataset(records=records)


def csv_caption_dataset(
    indexdoc: str,
    imagedir: str,
    max_images: int = 99999,
    flip_augment: bool = True,
    filename_col: int = 0,
    caption_col: int = 1,
) -> Dataset:
    """CSV rows of (filename, caption) (reference Dataset.load_index,
    preprocessor.py:126-139). class_id is the row index (every image its
    own contrastive class, like the clusterer's finest level)."""
    records: List[Record] = []
    with open(indexdoc, newline="") as f:
        for row_id, row in enumerate(csv.reader(f)):
            if len(row) <= max(filename_col, caption_col):
                continue
            path = os.path.join(imagedir, row[filename_col])
            try:
                pixels = decode_image(path)
            except OSError:
                continue
            caption = tokenize_caption(row[caption_col])
            records.append(Record(path, pixels, caption=caption,
                                  class_id=row_id))
            if flip_augment:
                records.append(Record(f"{path}_r", pixels, flip=True,
                                      caption=list(caption), class_id=row_id))
            if len(records) >= max_images:
                break
    return Dataset(records=records)
