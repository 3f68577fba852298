"""CIDEr — pycocoevalcap semantics.

Port of the math of ``R2GenCSR/evalcap/cider/cider_scorer.py``
(192 LoC): tf-idf weighted n-gram (1..4) cosine similarity, document
frequency from the reference corpus, Gaussian length penalty sigma=6,
final score x10.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict

SIGMA = 6.0
N = 4


def _ngram_counts(tokens: list[str]) -> list[Counter]:
    return [
        Counter(
            tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
        )
        for n in range(1, N + 1)
    ]


def cider(gts: dict[str, list[str]], res: dict[str, list[str]]) -> float:
    # Document frequencies over reference sets.
    df: dict = defaultdict(float)
    all_refs = {}
    for sid, refs in gts.items():
        counts = [_ngram_counts(r.split()) for r in refs]
        all_refs[sid] = counts
        seen = set()
        for c in counts:
            for n in range(N):
                seen.update(c[n].keys())
        for ng in seen:
            df[ng] += 1.0
    log_n_docs = math.log(max(len(gts), 1))

    def vec(counts: list[Counter]):
        vecs, norms, length = [], [], 0
        for n in range(N):
            v = {}
            norm = 0.0
            for ng, cnt in counts[n].items():
                idf = log_n_docs - math.log(max(df.get(ng, 0.0), 1.0))
                v[ng] = cnt * idf
                norm += v[ng] ** 2
            if n == 0:
                length = sum(counts[n].values())
            vecs.append(v)
            norms.append(math.sqrt(norm))
        return vecs, norms, length

    scores = []
    for sid, cands in res.items():
        c_vec, c_norm, c_len = vec(_ngram_counts(cands[0].split()))
        ref_scores = []
        for r_counts in all_refs[sid]:
            r_vec, r_norm, r_len = vec(r_counts)
            sim = 0.0
            for n in range(N):
                dot = sum(
                    min(c_vec[n].get(ng, 0.0), v) * v
                    for ng, v in r_vec[n].items()
                    if ng in c_vec[n]
                )
                # pycocoevalcap clips candidate counts to ref counts via
                # min() on tf-idf values, then cosine-normalises.
                if c_norm[n] > 0 and r_norm[n] > 0:
                    sim += dot / (c_norm[n] * r_norm[n])
            delta = float(c_len - r_len)
            sim *= math.exp(-(delta**2) / (2 * SIGMA**2))
            ref_scores.append(sim * 10.0 / N)
        scores.append(sum(ref_scores) / max(len(ref_scores), 1))
    return sum(scores) / max(len(scores), 1)
