"""GradCAM over SwinCheX tokens, and AM-MRG's memory-bank generators.

Counterpart of ``medical_image_analysis_tpu/utils/cam.py``.
:func:`swin_grad_cam` takes the final-stage tokens without a gradient
(so the Swin blocks run deterministic and gradient-free, which on the
card is the window-attention kernel, ``ops/swin_block.py``), then the
gradient of the positive logit of one class w.r.t. those tokens through
the heads (``SwinCheX.logits_from_tokens``): weights = GAP(d logit /
d tokens), cam = relu(sum_c w_c token_c) on the final-stage grid,
min-max normalised. :func:`extract_cam_features`,
:func:`build_visual_memory` and :func:`build_report_memory` are the JAX
package's numpy, with the same ``default_rng`` draws.
"""

from __future__ import annotations

import numpy as np
import torch


def swin_grad_cam(model, images: torch.Tensor, class_idx: int):
    """Returns (cam (B, g, g) in [0, 1], tokens (B, L, C)); ``model`` is a
    :class:`..models.swin.SwinCheX`."""
    with torch.no_grad():
        tokens = model.tokens(images)
    tok = tokens.detach().requires_grad_()
    logits = model.logits_from_tokens(tok)
    (grads,) = torch.autograd.grad(logits[:, class_idx, 1].sum(), tok)
    weights = grads.mean(dim=1, keepdim=True)  # GAP over tokens
    cam = torch.clamp((weights * tokens).sum(-1), min=0.0)  # (B, L)
    b, l = cam.shape
    g = int(round(l**0.5))
    cam = cam.reshape(b, g, g)
    cmin = cam.amin(dim=(1, 2), keepdim=True)
    cmax = cam.amax(dim=(1, 2), keepdim=True)
    return (cam - cmin) / torch.clamp(cmax - cmin, min=1e-8), tokens


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def extract_cam_features(tokens, cam, top_n: int = 8) -> np.ndarray:
    """Per-image top-N token features by CAM weight (B, top_n, C)."""
    toks = _numpy(tokens)
    b, l, c = toks.shape
    flat = _numpy(cam).reshape(b, l)
    out = []
    for i in range(b):
        idx = np.argsort(-flat[i])[:top_n]
        out.append(toks[i, idx])
    return np.stack(out)


def build_visual_memory(disease_tokens: np.ndarray, cam_features: np.ndarray,
                        max_features: int = 256, seed: int = 0) -> np.ndarray:
    """Visual memory bank [disease_tokens (14, D) ; up to ``max_features``
    of the CAM features (N, D), sampled without replacement]."""
    rng = np.random.default_rng(seed)
    n = min(max_features, len(cam_features))
    idx = rng.choice(len(cam_features), n, replace=False)
    return np.concatenate([disease_tokens, cam_features[idx]], axis=0)


def build_report_memory(report_embs: np.ndarray, labels: np.ndarray,
                        size: int = 6000, seed: int = 0) -> np.ndarray:
    """A label-proportional sample of ``size`` report embeddings (M, D)
    with labels (M, 14); all of them when M <= size."""
    rng = np.random.default_rng(seed)
    m = len(report_embs)
    if m <= size:
        return report_embs
    counts = labels.sum(axis=0)
    probs = np.zeros(m)
    for c in range(labels.shape[1]):
        members = labels[:, c] == 1
        if members.sum() > 0:
            probs[members] += counts[c] / max(counts.sum(), 1) / members.sum()
    if probs.sum() == 0:
        probs = np.ones(m)
    probs = probs / probs.sum()
    idx = rng.choice(m, size, replace=False, p=probs)
    return report_embs[idx]
