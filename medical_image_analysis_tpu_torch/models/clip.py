"""CLIP alignment head and the symmetric InfoNCE (MambaXray-VL stage 2).

Counterpart of ``medical_image_analysis_tpu/models/clip.py``: linear
vision and text projections to ``proj_dim``, each row divided by its L2
norm clipped below at 1e-6, a learnable 0-d ``logit_scale`` initialised to
log(1 / 0.07); the batch is the contrastive pool.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..parallel.mesh import gather_rows


class CLIPHead(nn.Module):
    """``forward(image_feats, text_feats)`` -> (v, t, scale): both
    projections L2-normalised, and ``exp(logit_scale)``. The flax module
    infers its input widths; here they are ``vision_dim`` and
    ``text_dim``."""

    def __init__(self, vision_dim: int, text_dim: int, proj_dim: int = 2048,
                 device=None):
        super().__init__()
        self.vision_proj = nn.Linear(vision_dim, proj_dim, device=device)
        self.text_proj = nn.Linear(text_dim, proj_dim, device=device)
        self.logit_scale = nn.Parameter(torch.empty((), device=device))

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        self.logit_scale.fill_(math.log(1.0 / 0.07))

    def forward(self, image_feats: torch.Tensor, text_feats: torch.Tensor):
        v = self.vision_proj(image_feats)
        t = self.text_proj(text_feats)
        v = v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-6)
        t = t / torch.linalg.norm(t, dim=-1, keepdim=True).clamp_min(1e-6)
        return v, t, torch.exp(self.logit_scale)


def clip_loss(v: torch.Tensor, t: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the batch: the mean of the image-to-text and
    text-to-image cross-entropies, row i's match at column i. In a
    data-parallel step the batch is the global one: every rank's rows of
    ``v`` and ``t`` are gathered (``parallel.mesh.gather_rows``)."""
    v, t = gather_rows(v), gather_rows(t)
    logits = scale * v @ t.T  # (B, B)
    li = -torch.diagonal(torch.log_softmax(logits, dim=1)).mean()
    lt = -torch.diagonal(torch.log_softmax(logits, dim=0)).mean()
    return 0.5 * (li + lt)
