"""Image grids, loss plots, attention-map dumps: arrays in, PNGs out.

Port of attngan_tpu/utils/imaging.py (the port imports nothing of the JAX
package) without Pillow or matplotlib, which the GPU machine need not
have: ``save_image`` encodes an 8-bit RGB PNG with the standard library,
and ``plot_history`` rasterises the moving-average curves with numpy into
an image of matplotlib's default size (the axes and labels go).

Reference: trainers/trainer.py:49-107 (moving-average loss plots, per-epoch
image grids and single-image PNGs) and pretrain_damsm.py:150-164
(attention viewers).
"""

from __future__ import annotations

import binascii
import math
import os
import struct
import zlib
from typing import List, Sequence

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PLOT_SIZE = (480, 640)      # matplotlib's default 6.4 x 4.8 in at 100 dpi
PLOT_MARGIN = 0.08          # share of each side left blank
# matplotlib's default colour cycle (tab10), one colour per history
PLOT_COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
               (148, 103, 189), (140, 86, 75), (227, 119, 194))


def _ensure_dir(path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def moving_average(values: Sequence[float], window: int) -> np.ndarray:
    """Same simple sliding mean the reference plots (trainer.py:55-63)."""
    v = np.asarray(values, np.float64)
    if len(v) < window:
        return v
    kernel = np.ones(window) / window
    return np.convolve(v, kernel, mode="valid")


def plot_history(histories, path: str, window: int = 100) -> None:
    """The moving average of one history (or of each of a list of them) as
    line(s) on a white PNG, x the step, y the value scaled to the finite
    values' range."""
    if len(histories) and not isinstance(histories[0], (list, np.ndarray)):
        histories = [histories]
    h, w = PLOT_SIZE
    canvas = np.full((h, w, 3), 255, np.uint8)
    curves = [moving_average(v, min(window, max(len(v), 1)))
              for v in histories]
    finite = np.concatenate([c[np.isfinite(c)] for c in curves] or [[]])
    lo, hi = (finite.min(), finite.max()) if finite.size else (0.0, 1.0)
    span = hi - lo if hi > lo else 1.0
    top, left = int(h * PLOT_MARGIN), int(w * PLOT_MARGIN)
    rows, cols = h - 2 * top, w - 2 * left
    for i, curve in enumerate(curves):
        if not len(curve):
            continue
        # the curve at each pixel column, then each column's vertical span
        # to the next one's, so that steep stretches stay joined
        xs = np.linspace(0, len(curve) - 1, cols)
        ys = np.interp(xs, np.arange(len(curve)), curve)
        px = np.round((hi - ys) / span * (rows - 1)).astype(np.int64) + top
        px = np.clip(px, top, top + rows - 1)
        nxt = np.append(px[1:], px[-1])
        for c in range(cols):
            a, b = sorted((px[c], nxt[c]))
            canvas[a:b + 1, left + c] = PLOT_COLORS[i % len(PLOT_COLORS)]
    _write_png(canvas, path)


def image_grid(images: np.ndarray, nrow: int = 0) -> np.ndarray:
    """(N, H, W, 3) in [0, 1] -> one (gh*H, gw*W, 3) grid array."""
    n, h, w, c = images.shape
    if nrow <= 0:
        nrow = max(int(math.sqrt(n)), 1)
    ncol = math.ceil(n / nrow)
    grid = np.zeros((nrow * h, ncol * w, c), images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        if r < nrow:
            grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = images[i]
    return grid


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", binascii.crc32(tag + data) & 0xFFFFFFFF))


def save_image(array: np.ndarray, path: str) -> None:
    """(H, W, 3) in [0, 1] -> 8-bit RGB PNG (every row unfiltered, one
    zlib stream)."""
    if array.ndim != 3 or array.shape[-1] != 3:
        raise ValueError(f"save_image takes (H, W, 3); got {array.shape}")
    _write_png((np.clip(array, 0, 1) * 255).astype(np.uint8), path)


def _write_png(pixels: np.ndarray, path: str) -> None:
    h, w, _ = pixels.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           pixels.reshape(h, w * 3)], axis=1)
    _ensure_dir(path)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                  0, 0))
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG that ``save_image`` wrote (8-bit RGB, rows
    unfiltered); raises ValueError on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if (struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
                != binascii.crc32(tag + body) & 0xFFFFFFFF):
            raise ValueError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + length
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an unfiltered 8-bit RGB PNG: {header}")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 3)


def save_image_grids(fake_images: List[np.ndarray], epoch: int,
                     folder: str = "generated_images") -> None:
    """Per-resolution grids, like reference trainer.py:68-102."""
    for images in fake_images:
        res = images.shape[1]
        save_image(image_grid(np.asarray(images)),
                   os.path.join(folder, f"epoch_{epoch}-{res}x{res}.png"))


def save_attention_maps(attn: np.ndarray, path: str) -> None:
    """(L, H, W) attention -> horizontal strip PNG (pretrain viewers)."""
    l, h, w = attn.shape
    normalized = attn / (attn.max(axis=(1, 2), keepdims=True) + 1e-8)
    strip = normalized.transpose(1, 0, 2).reshape(h, l * w)
    save_image(np.repeat(strip[..., None], 3, axis=-1), path)
