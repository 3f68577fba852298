"""Corpus BLEU-1..4 — pycocoevalcap semantics.

Port of the math of ``R2GenCSR/evalcap/bleu/bleu_scorer.py``
(264 LoC): clipped n-gram precision accumulated over the corpus,
*closest* reference length for the brevity penalty, geometric mean of
precisions up to n for Bleu_n.
"""

from __future__ import annotations

import math
from collections import Counter

_TINY = 1e-15
_SMALL = 1e-9


def _ngrams(tokens: list[str], n: int) -> Counter:
    return Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


def bleu(
    gts: dict[str, list[str]], res: dict[str, list[str]], max_n: int = 4
) -> list[float]:
    """gts/res: id -> list of sentences (res has one). Returns Bleu_1..4."""
    totals = [0.0] * max_n  # clipped matches per n
    guess = [0.0] * max_n  # candidate n-gram counts per n
    c_len = 0
    r_len = 0.0
    for sid, cands in res.items():
        cand = cands[0].split()
        refs = [r.split() for r in gts[sid]]
        c_len += len(cand)
        # closest reference length (ties -> shorter)
        r_len += min(
            (abs(len(r) - len(cand)), len(r)) for r in refs
        )[1]
        for n in range(1, max_n + 1):
            cand_ng = _ngrams(cand, n)
            max_ref = Counter()
            for r in refs:
                for ng, cnt in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], cnt)
            clipped = sum(
                min(cnt, max_ref.get(ng, 0)) for ng, cnt in cand_ng.items()
            )
            totals[n - 1] += clipped
            guess[n - 1] += max(len(cand) - n + 1, 0)

    bp = 1.0 if c_len > r_len else math.exp(1.0 - r_len / max(c_len, 1))
    scores = []
    log_sum = 0.0
    for n in range(max_n):
        p = (totals[n] + _TINY) / (guess[n] + _SMALL)
        log_sum += math.log(max(p, _TINY))
        scores.append(bp * math.exp(log_sum / (n + 1)))
    return scores
