"""Word-level tokenizer built from the training corpus.

Counterpart of ``medical_image_analysis_tpu/data/tokenizer.py:
WordTokenizer`` (same special ids, vocabulary file, corpus rule and
decode rules), so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Iterable


class WordTokenizer:
    PAD, BOS, EOS, UNK = 0, 1, 2, 3

    def __init__(self, vocab: list[str]):
        self.itos = ["<pad>", "<bos>", "<eos>", "<unk>"] + list(vocab)
        self.stoi = {w: i for i, w in enumerate(self.itos)}

    @classmethod
    def from_corpus(cls, texts: Iterable[str], min_freq: int = 3,
                    max_vocab: int = 8192) -> "WordTokenizer":
        counter = Counter()
        for t in texts:
            counter.update(t.split())
        vocab = [
            w for w, c in counter.most_common(max_vocab) if c >= min_freq
        ]
        return cls(vocab)

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

    def pad(self, ids: list[int], max_len: int) -> tuple[list[int], list[int]]:
        mask = [1] * len(ids) + [0] * (max_len - len(ids))
        return ids + [self.PAD] * (max_len - len(ids)), mask

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

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.itos[4:], f)

    @classmethod
    def load(cls, path: str) -> "WordTokenizer":
        """A vocabulary saved by ``save`` (this one or the JAX package's)."""
        with open(path) as f:
            return cls(json.load(f))
