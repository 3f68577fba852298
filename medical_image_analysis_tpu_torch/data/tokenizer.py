"""Word-level tokenizer: the serving subset of the JAX package's.

Counterpart of ``medical_image_analysis_tpu/data/tokenizer.py:
WordTokenizer`` (same special ids, vocabulary file and decode rules), so
that the port imports nothing of the JAX package. Building a vocabulary
from a corpus belongs to the training recipes and is not ported yet.
"""

from __future__ import annotations

import json
from typing import Iterable


class WordTokenizer:
    PAD, BOS, EOS, UNK = 0, 1, 2, 3

    def __init__(self, vocab: list[str]):
        self.itos = ["<pad>", "<bos>", "<eos>", "<unk>"] + list(vocab)
        self.stoi = {w: i for i, w in enumerate(self.itos)}

    @property
    def vocab_size(self) -> int:
        return len(self.itos)

    def encode(self, text: str, max_len: int | None = None,
               add_bos: bool = False, add_eos: bool = False) -> list[int]:
        ids = [self.stoi.get(w, self.UNK) for w in text.split()]
        if add_bos:
            ids = [self.BOS] + ids
        if add_eos:
            ids = ids + [self.EOS]
        if max_len is not None:
            ids = ids[:max_len]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        words = []
        for i in ids:
            i = int(i)
            if i == self.EOS:
                break
            if i in (self.PAD, self.BOS):
                continue
            words.append(self.itos[i] if i < len(self.itos) else "<unk>")
        return " ".join(words)

    @classmethod
    def load(cls, path: str) -> "WordTokenizer":
        """A vocabulary saved by the JAX package's ``WordTokenizer.save``."""
        with open(path) as f:
            return cls(json.load(f))
