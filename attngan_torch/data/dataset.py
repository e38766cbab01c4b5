"""Dataset: host file scan + device-side multi-scale preprocessing.

Port of attngan_tpu/data/dataset.py (the port imports nothing of the JAX
package). The host decodes each image once to a canonical 256x256 uint8
array; the 64/128/256 pyramid, the [-1, 1] normalisation and the
horizontal flip run as one batched torch function on the batch's device
(``preprocess_pyramid``). Batches have static shapes (captions padded to
max_seqlen) and, like the reference's loops, ragged final batches are
dropped (reference train.py:112-113).

Reference: data/bedrooms.py:104-238 — a recursive .jpg scan, eager PIL
decode of every image at 3 resolutions plus a flipped duplicate, per-res
Resize/ToTensor/Normalize(0.5, 0.5), JSON caption persistence, and a
TensorDataset DataLoader of (tokens, lengths, class_ids, img64, img128,
img256).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from attngan_torch.data.vocab import Vocab
from attngan_torch.models.cnn_encoder import resize_bilinear

CANONICAL_RES = 256
IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def scan_image_paths(rootdir: str, max_images: int = 99999) -> List[str]:
    """Recursive scan for image files (reference bedrooms.py:122-132)."""
    paths: List[str] = []
    for dirpath, _, filenames in sorted(os.walk(rootdir)):
        for fname in sorted(filenames):
            if fname.lower().endswith(IMAGE_EXTS):
                paths.append(os.path.join(dirpath, fname))
                if len(paths) >= max_images:
                    return paths
    return paths


def decode_image(path: str, res: int = CANONICAL_RES) -> np.ndarray:
    """Host-side decode to (res, res, 3) uint8. Needs Pillow, which only
    ``--data-root`` reaches."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB").resize((res, res), Image.BILINEAR)
        return np.asarray(img, np.uint8)


def preprocess_pyramid(images_u8: torch.Tensor, flip: torch.Tensor
                       ) -> Dict[int, torch.Tensor]:
    """uint8 (B, H, W, 3) + bool (B,) -> {256: x, 128: ..., 64: ...}, NHWC
    fp32 in [-1, 1] on the images' device (key 256 is the input's own
    size).

    Replaces the reference's per-res PIL transform stack
    (bedrooms.py:149-164): scale to [-1, 1] (Normalize(0.5, 0.5) on
    ToTensor output), horizontal flip where ``flip`` (the
    RandomHorizontalFlip(p=1) duplicate, bedrooms.py:141-146), bilinear
    resize to 128 and 64, antialiased where it shrinks, as
    jax.image.resize is.
    """
    x = images_u8.to(torch.float32) / 255.0
    x = torch.where(flip.to(torch.bool)[:, None, None, None],
                    x.flip(2), x)
    x = torch.clamp((x - 0.5) / 0.5, -1.0, 1.0)  # guard fp32 rounding past 1.0
    nchw = x.permute(0, 3, 1, 2)
    out = {256: x}
    for res in (128, 64):
        out[res] = resize_bilinear(nchw, res).permute(0, 2, 3, 1)
    return out


def _decode_records(paths: List[str], max_images: int, flip_augment: bool,
                    use_native: bool) -> List["Record"]:
    """Eager decode of the scanned files into Records, through the
    multithreaded native C++ loader (data/native_loader.py) where asked
    and built, else Pillow; unreadable files are skipped (reference
    bedrooms.py:143-144)."""
    from attngan_torch.data import native_loader

    records: List[Record] = []
    native = use_native and native_loader.available()
    if native:
        images, ok = native_loader.decode_batch(paths, CANONICAL_RES)
        decoded = {p: images[i] for i, p in enumerate(paths) if ok[i]}
    for path in paths:
        if native:
            pixels = decoded.get(path)
            if pixels is None:
                continue
        else:
            try:
                pixels = decode_image(path)
            except OSError:
                continue
        records.append(Record(path, pixels))
        if flip_augment:
            records.append(Record(f"{path}_r", pixels, flip=True))
        if len(records) >= max_images:
            break
    return records


@dataclass
class Record:
    """One image record (reference SingleImage, bedrooms.py:28-57)."""

    fpath: str
    pixels: np.ndarray            # (256, 256, 3) uint8, pre-flip
    flip: bool = False
    caption: List[str] = field(default_factory=list)
    class_id: Optional[int] = None


class Dataset:
    """Eagerly-decoded image dataset + vocab + caption persistence."""

    def __init__(self, rootdir: str = "", max_images: int = 99999,
                 flip_augment: bool = True,
                 records: Optional[List[Record]] = None,
                 use_native_loader: bool = False):
        # use_native_loader: the C++ thread-pool decoder, off by default as
        # in the JAX package (its resize filter differs from Pillow's by a
        # few levels, tests/test_native_loader.py)
        self.rootdir = rootdir
        self.vocab = Vocab()
        if records is not None:
            self.records = records
        else:
            self.records = []
            if rootdir:
                paths = scan_image_paths(rootdir, max_images)
                self.records = _decode_records(paths, max_images, flip_augment,
                                               use_native_loader)

    def __len__(self) -> int:
        return len(self.records)

    # ----- pixel access (overridden by data/streaming.py) -----
    #
    # Everything that touches pixels goes through these two hooks, so the
    # bounded-memory StreamingDataset can decode on demand under the same
    # batching, vocab and caption semantics.

    def _record_pixels(self, record: Record) -> np.ndarray:
        """(256, 256, 3) uint8 pre-flip pixels of one record."""
        return record.pixels

    def _batch_pixels(self, records: List[Record]) -> np.ndarray:
        """(N, 256, 256, 3) uint8 pre-flip pixels of a batch of records."""
        return np.stack([self._record_pixels(r) for r in records])

    @property
    def max_seqlen(self) -> int:
        return max((len(r.caption) for r in self.records), default=0)

    # ----- caption persistence (reference bedrooms.py:166-180) -----

    def save_captions_and_class_ids(self, path: str) -> None:
        mapping = {r.fpath: [r.caption, r.class_id] for r in self.records}
        with open(path, "w") as f:
            json.dump(mapping, f)

    def load_captions_and_class_ids(self, path: str) -> None:
        with open(path) as f:
            mapping = json.load(f)
        by_path = {r.fpath: r for r in self.records}
        for fpath, (caption, class_id) in mapping.items():
            if fpath in by_path:
                by_path[fpath].caption = caption
                by_path[fpath].class_id = class_id

    # ----- batching (replaces make_dataloaders, bedrooms.py:209-238) -----

    def build_vocab(self) -> None:
        if not self.vocab.vocab_built:
            self.vocab.build([r.caption for r in self.records])

    def iter_batches(
        self,
        batch_size: int,
        max_seqlen: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_ragged: bool = True,
        with_pixels: bool = True,
        rows: Optional[slice] = None,
        keep: Optional[Callable[[Dict[str, np.ndarray]], bool]] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yields static-shape host batches; ``device_batch`` moves one to
        the device and builds its pyramid there. Ragged final batches are
        dropped like the reference's `len(words) < BATCH_SIZE` skip
        (train.py:112-113). ``with_pixels=False`` leaves out the pixels
        and flips (a batch of cached trunk features does not read them).
        ``keep`` decides on the whole batch, before its pixels are read,
        whether it is yielded; ``rows`` (a data-parallel rank's share) then
        cuts it to those rows, so that every rank decides alike."""
        self.build_vocab()
        max_seqlen = max_seqlen or self.max_seqlen
        order = np.arange(len(self.records))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            if drop_ragged and len(idx) < batch_size:
                continue
            recs = [self.records[i] for i in idx]
            tokens, lengths = self.vocab.encode_batch(
                [r.caption for r in recs], max_seqlen
            )
            batch = {
                "indices": idx,
                "tokens": tokens,
                "lengths": lengths,
                "class_ids": np.asarray(
                    [r.class_id if r.class_id is not None else 0 for r in recs],
                    np.int32,
                ),
            }
            if keep is not None and not keep(batch):
                continue
            if rows is not None:
                recs = recs[rows]
                batch = {k: v[rows] for k, v in batch.items()}
            if with_pixels:
                batch.update(pixels=self._batch_pixels(recs),
                             flip=np.asarray([r.flip for r in recs], bool))
            yield batch

    def evaluate_clustering(self, idx, max_images: int = 50, nrow: int = 10,
                            folder: str = "images_testing", seed: int = 0):
        """For each cluster level of one image's caption (finest first),
        write a grid of up to ``max_images`` co-clustered members to
        ``folder/k-<k>.png`` (reference bedrooms.py:186-207). ``idx`` is a
        record index or fpath. Returns {k value: member count}."""
        from attngan_torch.utils.imaging import image_grid, save_image

        record = (self.records[idx] if isinstance(idx, int)
                  else next(r for r in self.records if r.fpath == idx))
        counts = {}
        rng = np.random.default_rng(seed)
        for i, token in enumerate(reversed(record.caption), 1):
            k_value = token.split("c")[0].lstrip("k")
            members = [r for r in self.records
                       if len(r.caption) >= i and r.caption[-i] == token]
            counts[k_value] = len(members)
            chosen = list(members)
            rng.shuffle(chosen)
            chosen = chosen[:max_images]
            imgs = self._batch_pixels(chosen).astype(np.float32) / 255.0
            os.makedirs(folder, exist_ok=True)
            save_image(image_grid(imgs, nrow=nrow),
                       os.path.join(folder, f"k-{k_value}.png"))
        return counts

    @staticmethod
    def device_batch(host_batch: Dict[str, object],
                     device: str | torch.device) -> Dict[str, torch.Tensor]:
        """Move a host batch (numpy arrays, or the tensors of
        ``pinned_batch``) to ``device``: tokens, class_ids and either the
        image pyramid built there from its pixels (img64/128/256, NHWC fp32
        in [-1, 1]) or, for a batch of cached trunk features, its
        trunk_regions and trunk_pooled rows as they are. ``lengths`` stay
        on the host, where the BiLSTM's packing reads them: on the device
        they would cost a copy back and a stream drain every step."""
        device = torch.device(device)

        def put(key):
            return torch.as_tensor(host_batch[key]).to(device,
                                                       non_blocking=True)

        out = {"tokens": put("tokens"),
               "lengths": torch.as_tensor(host_batch["lengths"]),
               "class_ids": put("class_ids")}
        if "trunk_regions" in host_batch:
            out.update(trunk_regions=put("trunk_regions"),
                       trunk_pooled=put("trunk_pooled"))
        else:
            pyramid = preprocess_pyramid(put("pixels"), put("flip"))
            out.update(img64=pyramid[64], img128=pyramid[128],
                       img256=pyramid[256])
        return out


def pinned_batch(host_batch: Dict[str, np.ndarray],
                 device: str | torch.device,
                 cache: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
    """The arrays ``device_batch`` copies, as host tensors, in page-locked
    memory when ``device`` is a GPU so that its copies run asynchronously
    (the prefetch thread's transform; ``lengths`` stay ordinary host
    memory). With ``cache`` ({"regions", "pooled"}: host tensors of
    cached trunk features, one row a record) the batch carries the rows of
    its ``indices`` as trunk_regions / trunk_pooled, gathered straight into
    the page-locked buffers, in place of its pixels."""
    pin = torch.device(device).type == "cuda"
    keys = ("tokens", "lengths", "class_ids")
    if cache is None:
        keys += ("pixels", "flip")
    out = {}
    for key in keys:
        t = torch.from_numpy(np.ascontiguousarray(host_batch[key]))
        out[key] = t.pin_memory() if pin and key != "lengths" else t
    if cache is not None:
        idx = torch.from_numpy(np.asarray(host_batch["indices"], np.int64))
        for key, rows in (("trunk_regions", cache["regions"]),
                          ("trunk_pooled", cache["pooled"])):
            out[key] = torch.empty((len(idx), *rows.shape[1:]),
                                   dtype=rows.dtype, pin_memory=pin)
            torch.index_select(rows, 0, idx, out=out[key])
    return out


def word_mask(lengths: torch.Tensor, max_seqlen: int) -> torch.Tensor:
    """(B,) lengths -> (B, L) int32 mask, 1 at real words, 0 at padding
    (reference _make_mask, train.py:96-100)."""
    steps = torch.arange(max_seqlen, device=lengths.device)
    return (steps[None, :] < lengths[:, None]).to(torch.int32)
