"""Vocabulary for the clustering-derived pseudo-captions.

A copy of attngan_tpu/data/vocab.py (the port imports nothing of the JAX
package) without its ``index2word`` and ``word2count``, which nothing
reads.

Reference: data/bedrooms.py:59-101 (Vocab). Differences, both deliberate:
  * unknown words map to '[UNK]' only if present (reference behavior is a
    latent KeyError when '[UNK]' never appeared in training captions,
    bedrooms.py:70-77); here '[UNK]' is always registered at build time.
  * captions are padded to a STATIC max_seqlen for jit; padded positions use
    token id 0 and are excluded everywhere by the length masks, so no
    dedicated PAD token is required (the legacy data/preprocessor.py:192-267
    PAD-aware vocab inspired this).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

UNK = "[UNK]"


class Vocab:
    def __init__(self):
        self.word2index: Dict[str, int] = {}
        self.n_words = 0
        self.vocab_built = False

    def _add_word(self, word: str) -> None:
        if word not in self.word2index:
            self.word2index[word] = self.n_words
            self.n_words += 1

    def add_caption(self, caption: List[str]) -> None:
        for word in caption:
            self._add_word(word)

    def build(self, captions: List[List[str]]) -> None:
        self._add_word(UNK)
        for caption in captions:
            self.add_caption(caption)
        self.vocab_built = True

    def build_from_mapping(self, mapping: dict) -> None:
        """mapping: {fpath: [caption tokens, class_id]} (bedrooms.py:84-88)."""
        self._add_word(UNK)
        for _, (caption, _) in mapping.items():
            self.add_caption(caption)
        self.vocab_built = True

    def process(self, tokens: List[str]) -> List[int]:
        """Words -> indices, unknowns -> [UNK] (bedrooms.py:70-77)."""
        return [self.word2index.get(w, self.word2index[UNK]) for w in tokens]

    def encode_batch(
        self, captions: List[List[str]], max_seqlen: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad/truncate to (N, max_seqlen) int32 + true lengths (N,)."""
        n = len(captions)
        ids = np.zeros((n, max_seqlen), np.int32)
        lengths = np.zeros((n,), np.int32)
        for i, caption in enumerate(captions):
            idx = self.process(caption)[:max_seqlen]
            ids[i, : len(idx)] = idx
            lengths[i] = len(idx)
        return ids, lengths
