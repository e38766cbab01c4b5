"""Bounded-memory streaming dataset: decode-on-demand over the same
batching semantics as the eager Dataset. Port of
attngan_tpu/data/streaming.py.

The reference eagerly decodes the whole corpus into host tensors before
training starts (data/bedrooms.py:137-147), and the eager ``Dataset``
mirrors that: ~200 KB of host RAM per 256x256 uint8 record, so an
LSUN-scale corpus (~3M bedrooms, the reference's own live path,
bedrooms.py:105) would need ~600 GB. This class keeps only the file paths
and captions resident and decodes each batch when it is yielded, so host
memory is bounded by the batches in flight, whatever the corpus size.

* The record list (scan order, ``<path>_r`` flip duplicates, the
  ``max_images`` cap) is built by the eager rule, and ``iter_batches`` is
  inherited unchanged: the epoch's seeded permutation, caption encoding
  and ragged-batch drop are the same code. Only the pixel hooks differ, so
  for a given seed the two classes yield identical batches (when both
  decode through the same decoder).
* A batch is one ``native_loader.decode_batch`` call (libjpeg across a
  thread pool) where the library is built, else Pillow file by file. Flip
  duplicates in one batch share one decode; the flip itself happens on the
  device in ``preprocess_pyramid``.
* The training loops' prefetch thread (data/prefetch.py) runs
  ``iter_batches``, so decoding overlaps the GPU step.
* An unreadable file cannot be dropped up front without decoding
  everything once, and batch shapes are static, so it yields zero pixels
  and a warning (the first 20 failures are logged).

Selected from the CLIs with ``--stream``, and by ``open_dataset`` above
STREAM_AUTO_THRESHOLD records.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np

from attngan_torch.data import native_loader
from attngan_torch.data.dataset import (
    CANONICAL_RES,
    Dataset,
    Record,
    decode_image,
    scan_image_paths,
)
from attngan_torch.data.vocab import Vocab

logger = logging.getLogger(__name__)

# Above this many records the eager path would hold >~10 GB of pixels
# resident; open_dataset switches to streaming by itself.
STREAM_AUTO_THRESHOLD = 50_000


class StreamingDataset(Dataset):
    """Dataset with path-only records and decode-on-demand batches."""

    def __init__(self, rootdir: str = "", max_images: int = 99999,
                 flip_augment: bool = True, use_native_loader: bool = True):
        self.rootdir = rootdir
        self.vocab = Vocab()
        self.use_native_loader = use_native_loader
        self._decode_failures = 0
        self.records: List[Record] = []
        if rootdir:
            for path in scan_image_paths(rootdir, max_images):
                self.records.append(Record(path, None))
                if flip_augment:
                    self.records.append(Record(f"{path}_r", None, flip=True))
                if len(self.records) >= max_images:
                    break

    @staticmethod
    def _source_path(record: Record) -> str:
        """The file behind a record (a flip duplicate's fpath is
        '<path>_r'; its pixels are the file's, pre-flip)."""
        return record.fpath[:-2] if record.flip else record.fpath

    def _batch_pixels(self, records: List[Record]) -> np.ndarray:
        paths = [self._source_path(r) for r in records]
        unique = list(dict.fromkeys(paths))
        if self.use_native_loader and native_loader.available():
            images, ok = native_loader.decode_batch(unique, CANONICAL_RES)
        else:
            images = np.zeros((len(unique), CANONICAL_RES, CANONICAL_RES, 3),
                              np.uint8)
            ok = np.zeros((len(unique),), bool)
            for i, path in enumerate(unique):
                try:
                    images[i] = decode_image(path)
                    ok[i] = True
                except OSError:
                    pass
        if not ok.all():
            bad = [p for p, good in zip(unique, ok) if not good]
            self._decode_failures += len(bad)
            if self._decode_failures <= 20:
                logger.warning(
                    "streaming decode failed for %d file(s) (zero-filled to "
                    "keep batch shapes static; eager loading would have "
                    "dropped them up front): %s", len(bad), bad[:3])
        index = {p: i for i, p in enumerate(unique)}
        return images[[index[p] for p in paths]]

    def _record_pixels(self, record: Record) -> np.ndarray:
        return self._batch_pixels([record])[0]


def open_dataset(rootdir: str, max_images: int = 99999,
                 flip_augment: bool = True, stream: bool = False) -> Dataset:
    """The CLIs' constructor: the eager Dataset (Pillow), or the
    bounded-memory StreamingDataset (the native loader where it builds)
    when ``stream`` or when the scan gives more than STREAM_AUTO_THRESHOLD
    records."""
    n_scanned = len(scan_image_paths(rootdir, max_images))
    n_records = min(max_images, n_scanned * (2 if flip_augment else 1))
    if not stream and n_records > STREAM_AUTO_THRESHOLD:
        print(f"dataset: {n_records} records exceed the eager-decode "
              f"threshold ({STREAM_AUTO_THRESHOLD}); switching to the "
              "bounded-memory streaming loader (pass --stream to silence)")
        stream = True
    cls = StreamingDataset if stream else Dataset
    return cls(rootdir, max_images=max_images, flip_augment=flip_augment)
