"""Q-Former heads: the BLIP-2 Q-Former of AM-MRG and R2GenKG, and the
mini Q-Former projector of R2GenGPT's ``projector: qformer``.

Counterpart of ``medical_image_analysis_tpu/models/qformer.py``, with its
parameter names (``blip2/query_tokens``, ``blip2/bert/...``;
``qformer/...`` and ``linear`` in the projector). The recipes run
query-only mode: learnable queries self-attend and cross-attend into the
image features every ``cross_attention_freq`` layers (post-LN BERT blocks,
``models/bert.py``). ``Blip2QFormer(text=True)`` provides the text path.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .bert import Blip2QFormer


class QFormer(nn.Module):
    """``Blip2QFormer`` under the name ``blip2``. ``enc_dim`` is the width
    of the image features (the JAX ``Dense`` infers it).

    ``forward(encoder_states (B, L, enc_dim))`` -> (B, num_queries, dim).
    """

    def __init__(self, dim: int = 768, num_layers: int = 12,
                 num_heads: int = 12, num_queries: int = 14,
                 cross_attention_freq: int = 2, intermediate: int = 3072,
                 enc_dim: int | None = None, device=None):
        super().__init__()
        self.blip2 = Blip2QFormer(
            num_queries=num_queries, dim=dim, n_layers=num_layers,
            n_heads=num_heads, intermediate=intermediate,
            cross_attention_freq=cross_attention_freq, enc_dim=enc_dim,
            device=device)

    def forward(self, encoder_states: torch.Tensor) -> torch.Tensor:
        return self.blip2(encoder_states)


class EncoderProjectorQFormer(nn.Module):
    """A Q-Former of ``num_layers`` layers and ``num_queries`` queries with
    cross-attention in every layer, then ``linear`` into ``out_dim``: vision
    features (B, L, enc_dim) -> (B, num_queries, out_dim)."""

    def __init__(self, dim: int = 768, out_dim: int = 4096,
                 num_queries: int = 64, num_layers: int = 2,
                 num_heads: int = 12, enc_dim: int | None = None,
                 device=None):
        super().__init__()
        self.qformer = QFormer(dim=dim, num_layers=num_layers,
                               num_heads=num_heads, num_queries=num_queries,
                               cross_attention_freq=1, intermediate=dim * 4,
                               enc_dim=enc_dim, device=device)
        self.linear = nn.Linear(dim, out_dim, device=device)

    def forward(self, image_feats: torch.Tensor) -> torch.Tensor:
        return self.linear(self.qformer(image_feats))
