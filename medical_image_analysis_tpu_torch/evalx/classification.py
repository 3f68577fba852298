"""Classification metrics: per-label accuracy, AUC, attribute metrics.

A numpy copy of ``medical_image_analysis_tpu/evalx/classification.py``:
per-head accuracy and rank-statistic AUC (SwinCheX validation) and the
DP pedestrian-style metrics (label-wise mean accuracy, instance-level
precision, recall, F1).
"""

from __future__ import annotations

import numpy as np


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Binary AUC via the rank statistic (ties averaged); NaN when a class
    is missing."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    both = np.concatenate([pos, neg])
    order = np.argsort(both, kind="mergesort")
    _, inv, counts = np.unique(both[order], return_inverse=True,
                               return_counts=True)
    cum = np.cumsum(counts)
    ranks = np.empty(len(order), np.float64)
    ranks[order] = (cum - (counts - 1) / 2.0)[inv]  # average ranks of ties
    r_pos = ranks[: len(pos)].sum()
    return float(
        (r_pos - len(pos) * (len(pos) + 1) / 2) / (len(pos) * len(neg)))


def multilabel_auc(scores: np.ndarray, labels: np.ndarray) -> dict:
    """scores, labels (N, C) -> per-label AUC and their mean over the
    labels that have one."""
    aucs = [roc_auc(scores[:, c], labels[:, c])
            for c in range(scores.shape[1])]
    valid = [a for a in aucs if not np.isnan(a)]
    return {"auc_per_label": aucs,
            "auc_mean": float(np.mean(valid)) if valid else float("nan")}


def per_label_accuracy(logits2: np.ndarray, labels: np.ndarray) -> dict:
    """logits2 (N, C, 2): the softmax heads' predictions against labels."""
    acc = (logits2.argmax(-1) == labels).mean(axis=0)
    return {"acc_per_label": acc.tolist(), "acc_mean": float(acc.mean())}


def pedestrian_metrics(preds: np.ndarray, labels: np.ndarray,
                       threshold: float = 0.5) -> dict:
    """Label-wise mean accuracy and instance precision, recall, F1 and
    accuracy of thresholded scores."""
    p = (preds > threshold).astype(np.float64)
    g = labels.astype(np.float64)
    eps = 1e-20
    tp = ((p == 1) & (g == 1)).sum(0)
    tn = ((p == 0) & (g == 0)).sum(0)
    pos = (g == 1).sum(0)
    neg = (g == 0).sum(0)
    label_ma = float(((tp / (pos + eps) + tn / (neg + eps)) / 2).mean())
    inter = ((p == 1) & (g == 1)).sum(1)
    union = ((p == 1) | (g == 1)).sum(1)
    acc = float((inter / (union + eps)).mean())
    prec = float((inter / (p.sum(1) + eps)).mean())
    rec = float((inter / (g.sum(1) + eps)).mean())
    f1 = 2 * prec * rec / (prec + rec + eps)
    return {"ma": label_ma, "instance_acc": acc, "instance_prec": prec,
            "instance_rec": rec, "instance_f1": f1}
