"""Image output (the part of attngan_tpu/utils/imaging.py serving uses)."""

from __future__ import annotations

import os

import numpy as np


def save_image(array: np.ndarray, path: str) -> None:
    """(H, W, 3) in [0, 1] -> PNG."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((np.clip(array, 0, 1) * 255).astype(np.uint8)).save(path)
