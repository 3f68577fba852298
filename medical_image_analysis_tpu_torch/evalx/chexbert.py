"""Clinical-efficacy metrics: CheXpert 14-label extraction + P/R/F1.

The reference computes CE with a trained CheXbert BERT labeler
(``HD.../finetune/RG_english/compute_ce.py``; CheXbert csv also drives
R2GenCSR retrieval, ``R2GenCSR.py:323-344``). Network weights are not
available in this environment, so the default extractor is a rule-based
CheXpert-style keyword labeler with negation scoping; a learned labeler
(e.g. the :mod:`..models.text_encoder` tower finetuned on CheXbert csv)
plugs into :func:`clinical_efficacy` via ``labeler=``.
"""

from __future__ import annotations

import re
from typing import Callable

import numpy as np

CHEXPERT_LABELS = [
    "enlarged cardiomediastinum", "cardiomegaly", "lung opacity",
    "lung lesion", "edema", "consolidation", "pneumonia", "atelectasis",
    "pneumothorax", "pleural effusion", "pleural other", "fracture",
    "support devices", "no finding",
]

_KEYWORDS = {
    "enlarged cardiomediastinum": ["cardiomediastinum", "mediastinal contour"],
    "cardiomegaly": ["cardiomegaly", "heart size is enlarged",
                     "enlarged heart", "cardiac enlargement"],
    "lung opacity": ["opacity", "opacities", "opacification"],
    "lung lesion": ["lesion", "nodule", "mass"],
    "edema": ["edema"],
    "consolidation": ["consolidation"],
    "pneumonia": ["pneumonia", "infectious process"],
    "atelectasis": ["atelectasis", "atelectatic"],
    "pneumothorax": ["pneumothorax"],
    "pleural effusion": ["effusion", "effusions"],
    "pleural other": ["pleural thickening", "fibrothorax"],
    "fracture": ["fracture", "fractures"],
    "support devices": ["tube", "catheter", "pacemaker", "device", "line"],
}

_NEGATIONS = ["no ", "without ", "free of ", "negative for ", "clear of ",
              "absence of ", "resolved ", "removal of "]


def extract_labels(report: str) -> np.ndarray:
    """14-dim {0,1} CheXpert-style labels from a cleaned report."""
    text = " " + report.lower() + " "
    sentences = [s.strip() for s in text.split(".") if s.strip()]
    out = np.zeros(len(CHEXPERT_LABELS), np.int32)
    for li, label in enumerate(CHEXPERT_LABELS[:-1]):
        for sent in sentences:
            for kw in _KEYWORDS[label]:
                idx = sent.find(kw)
                if idx < 0:
                    continue
                prefix = sent[:idx]
                if any(neg in " " + prefix[-24:] for neg in _NEGATIONS):
                    continue
                out[li] = 1
    if out[:-1].sum() == 0:
        out[-1] = 1  # no finding
    return out


def clinical_efficacy(
    gts: dict[str, list[str]],
    res: dict[str, list[str]],
    labeler: Callable[[str], np.ndarray] = extract_labels,
) -> dict[str, float]:
    """Micro-averaged example-based P/R/F1 over extracted labels (the
    CheXbert CE protocol of compute_ce.py)."""
    y_true = np.stack([labeler(gts[k][0]) for k in res])
    y_pred = np.stack([labeler(res[k][0]) for k in res])
    tp = float(((y_pred == 1) & (y_true == 1)).sum())
    fp = float(((y_pred == 1) & (y_true == 0)).sum())
    fn = float(((y_pred == 0) & (y_true == 1)).sum())
    prec = tp / max(tp + fp, 1e-9)
    rec = tp / max(tp + fn, 1e-9)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return {"ce_precision": prec, "ce_recall": rec, "ce_f1": f1}
