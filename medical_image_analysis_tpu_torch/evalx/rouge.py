"""ROUGE-L — pycocoevalcap semantics.

Port of the math of ``R2GenCSR/evalcap/rouge/rouge.py``
(105 LoC): LCS-based F-measure with beta=1.2, max precision/recall over
references, mean over the corpus.
"""

from __future__ import annotations

BETA = 1.2


def _lcs_len(a: list[str], b: list[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(gts: dict[str, list[str]], res: dict[str, list[str]]) -> float:
    scores = []
    for sid, cands in res.items():
        cand = cands[0].split()
        prec, rec = [], []
        for ref in gts[sid]:
            r = ref.split()
            lcs = _lcs_len(cand, r)
            prec.append(lcs / len(cand) if cand else 0.0)
            rec.append(lcs / len(r) if r else 0.0)
        p, r_ = max(prec), max(rec)
        if p + r_ > 0:
            scores.append(((1 + BETA**2) * p * r_) / (r_ + BETA**2 * p))
        else:
            scores.append(0.0)
    return sum(scores) / max(len(scores), 1)
