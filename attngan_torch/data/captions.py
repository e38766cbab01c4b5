"""Inference-time caption utilities.

A copy of attngan_tpu/data/captions.py (the port imports nothing of the
JAX package).

Reference: data/bedrooms.py:307-361 (CaptionHandler) — rebuilds the vocab
from the saved captions JSON, fuzzy-matches image names to their captions
(rapidfuzz ratio), swaps coarse/fine cluster tokens between two captions for
controllability demos, and tokenizes captions into padded index/length
arrays for the text encoder.
"""

from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np

from attngan_torch.data.vocab import Vocab


class CaptionHandler:
    def __init__(self, vocab_path: str):
        self.vocab_path = vocab_path
        self.vocab = Vocab()
        self.img2caption: dict = {}
        with open(vocab_path) as f:
            mapping = json.load(f)
        self.vocab.build_from_mapping(mapping)
        for path, (caption, _class_id) in mapping.items():
            self.img2caption[path] = caption

    @property
    def vocab_size(self) -> int:
        return self.vocab.n_words

    def get_captions(self, imgnames: List[str]) -> List[List[str]]:
        return [self._get_caption(name) for name in imgnames]

    def _get_caption(self, imgname: str) -> List[str]:
        """Best fuzzy substring match over stored paths (bedrooms.py:351-361)."""
        try:
            from rapidfuzz.fuzz import ratio
        except ImportError:  # fallback: plain substring match
            ratio = lambda a, b: float(a in b)
        best, best_score = None, -1.0
        for path in self.img2caption:
            if imgname in path:
                score = ratio(imgname, path)
                if score > best_score:
                    best, best_score = path, score
        if best is None:
            raise KeyError(f"no stored caption matches {imgname!r}")
        return self.img2caption[best]

    def swap_captions(
        self, captions: List[List[str]], num: int = 1, reverse: bool = False
    ) -> List[List[str]]:
        """Exchange the first (or last, reverse=True) ``num`` cluster tokens
        between two captions (bedrooms.py:331-340)."""
        if len(captions) != 2:
            raise ValueError(f"swap_captions takes 2 captions; got "
                             f"{len(captions)}")
        c1, c2 = captions
        n1, n2 = list(c1), list(c2)
        for i in range(1, num + 1):
            j = -i if reverse else (i - 1)
            n1[j], n2[j] = c2[j], c1[j]
        return [n1, n2]

    def preprocess(
        self, captions: List[List[str]], max_seqlen: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Captions -> (padded indices (N, L) int32, lengths (N,) int32)
        (bedrooms.py:342-349, with static-width padding for jit)."""
        max_seqlen = max_seqlen or max(len(c) for c in captions)
        return self.vocab.encode_batch(captions, max_seqlen)
