"""Disease-prediction classifiers and their losses.

Counterpart of ``medical_image_analysis_tpu/models/classifiers.py``:

- :class:`VSSMClassifier`: VSSM backbone, average pool, linear head (the
  VMamba classification runner);
- :class:`DPClassifier`: ViT encoder, global pool over the patch tokens,
  per-attribute linear head, trained with :func:`weighted_bce_loss`;
- :func:`swinchex_loss`: the sum of 14 per-head 2-way cross-entropies of
  ``models.swin.SwinCheX``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from .vit import ViT
from .vmamba import VSSM


class VSSMClassifier(nn.Module):
    """VSSM backbone (pooled) + linear head -> (B, num_classes)."""

    def __init__(self, num_classes: int = 14, vssm_kwargs: Any = None,
                 device=None):
        super().__init__()
        self.backbone = VSSM(**(vssm_kwargs or {}), device=device)
        self.head = nn.Linear(self.backbone.dims[-1], num_classes,
                              device=device)

    def forward(self, images, deterministic: bool = True):
        pooled = self.backbone(images, pool=True, deterministic=deterministic)
        return self.head(pooled)


class DPClassifier(nn.Module):
    """ViT global pool + per-attribute linear head -> (B, num_attrs)."""

    def __init__(self, num_attrs: int = 14, vit_kwargs: Any = None,
                 device=None):
        super().__init__()
        self.encoder = ViT(**(vit_kwargs or {}), device=device)
        self.head = nn.Linear(self.encoder.cls_token.shape[-1], num_attrs,
                              device=device)

    def forward(self, images, deterministic: bool = True):
        tokens = self.encoder(images, deterministic)
        return self.head(tokens[:, 1:].mean(dim=1))  # pool over patches


def weighted_bce_loss(logits, labels, sample_weight=None):
    """Sigmoid BCE with optional per-attribute positive weighting."""
    loss = -(labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))
    if sample_weight is not None:
        loss = loss * sample_weight
    return loss.mean()


def swinchex_loss(logits, labels):
    """logits (B, C, 2), labels (B, C): the sum of per-head CEs. Labels may
    be soft (mixup/cutmix): p(positive) per head."""
    lp = torch.log_softmax(logits, dim=-1)
    pos = labels.to(lp.dtype)
    ll = (1.0 - pos) * lp[..., 0] + pos * lp[..., 1]
    return -ll.mean(dim=0).sum()
