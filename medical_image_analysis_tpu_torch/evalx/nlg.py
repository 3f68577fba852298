"""NLG metric aggregator — the reference's per-model ``score()``.

``R2GenCSR/models/R2GenCSR.py:202-225``: BLEU-1..4,
ROUGE-L, METEOR, CIDEr over {id: [sentence]} dicts; chinese datasets
space-join characters first (:215-217).
"""

from __future__ import annotations

import logging

from . import meteor as meteor_mod
from .bleu import bleu
from .cider import cider
from .meteor import meteor
from .rouge import rouge_l

_warned_bundled = False


def _meteor_caveat_once() -> None:
    """Surface the bundled-tables caveat at the point of use.

    The default synonym/paraphrase tables are a curated radiology
    vocabulary, not meteor-1.5.jar's WordNet + full paraphrase data, so
    METEOR values are self-consistent but not comparable to jar-scored
    published tables. `tools/extract_meteor_tables.py` + the
    MIA_METEOR_TABLES env var give jar-comparable scores.
    """
    global _warned_bundled
    if _warned_bundled:
        return
    meteor_mod.default_tables()  # resolves which tables are in effect
    if meteor_mod.using_bundled_tables:
        logging.getLogger(__name__).warning(
            "METEOR: using bundled curated radiology tables — values are "
            "self-consistent but NOT comparable to meteor-1.5.jar-scored "
            "published numbers. For jar parity run "
            "tools/extract_meteor_tables.py and set MIA_METEOR_TABLES."
        )
    _warned_bundled = True


def compute_nlg_scores(
    gts: dict[str, list[str]],
    res: dict[str, list[str]],
    chinese: bool = False,
) -> dict[str, float]:
    if chinese:
        gts = {k: [" ".join(list(v.replace(" ", ""))) for v in vs]
               for k, vs in gts.items()}
        res = {k: [" ".join(list(v.replace(" ", ""))) for v in vs]
               for k, vs in res.items()}
    b = bleu(gts, res)
    _meteor_caveat_once()
    return {
        "Bleu_1": b[0],
        "Bleu_2": b[1],
        "Bleu_3": b[2],
        "Bleu_4": b[3],
        "ROUGE_L": rouge_l(gts, res),
        "METEOR": meteor(gts, res),
        "CIDEr": cider(gts, res),
    }
