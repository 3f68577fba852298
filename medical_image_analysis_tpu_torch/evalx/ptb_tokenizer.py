"""PTB tokenization + punctuation removal (no Java).

Replaces the Stanford-CoreNLP subprocess bridge
(``R2GenCSR/evalcap/tokenizer/ptbtokenizer.py:28-52``):
lowercase, PTB-style token splitting (contractions, punctuation
separation, bracket normalisation), then removal of the same
PUNCTUATIONS list. A copy of
``medical_image_analysis_tpu/evalx/ptb_tokenizer.py`` without its native
C++ fast path: this pure-Python version is the reference behavior.
"""

from __future__ import annotations

import re

PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

_BRACKETS = {
    "(": "-LRB-", ")": "-RRB-", "{": "-LCB-", "}": "-RCB-",
    "[": "-LSB-", "]": "-RSB-",
}

_CONTRACTIONS = re.compile(
    r"\b(can)(not)\b|\b(d')(ye)\b|\b(gim)(me)\b|\b(gon)(na)\b|"
    r"\b(got)(ta)\b|\b(lem)(me)\b|\b(wan)(na)\b",
    re.IGNORECASE,
)


def ptb_tokenize_sentence(text: str) -> list[str]:
    """Lowercased PTB-ish token list with PUNCTUATIONS removed."""
    t = " " + text.lower().replace("\n", " ") + " "
    t = _CONTRACTIONS.sub(lambda m: " ".join(g for g in m.groups() if g), t)
    # n't and 'xx clitics
    t = re.sub(r"(\w)(n't)\b", r"\1 \2", t)
    t = re.sub(r"(\w)('s|'re|'ve|'ll|'d|'m)\b", r"\1 \2", t)
    # ellipses / double dash first
    t = t.replace("...", " ... ").replace("--", " -- ")
    # brackets -> PTB names
    for ch, name in _BRACKETS.items():
        t = t.replace(ch, f" {name} ")
    # separate remaining punctuation
    t = re.sub(r"([.,?!;:@#$%&\"])", r" \1 ", t)
    t = re.sub(r"\s+", " ", t).strip()
    return [tok for tok in t.split(" ") if tok and tok not in PUNCTUATIONS]


def tokenize(captions: dict[str, list[str]]) -> dict[str, list[str]]:
    """{id: [sentences]} -> {id: [space-joined tokenized sentences]},
    the PTBTokenizer.tokenize interface."""
    return {
        k: [" ".join(ptb_tokenize_sentence(s)) for s in vs]
        for k, vs in captions.items()
    }
