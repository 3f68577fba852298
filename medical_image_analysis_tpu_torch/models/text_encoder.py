"""Bidirectional text encoder (the scratch Bio_ClinicalBERT stand-in) for
CLIP alignment.

Counterpart of ``medical_image_analysis_tpu/models/text_encoder.py``, with
its parameter names (``tok_embed``, ``pos_embed``, ``embed_norm``,
``ln1_<i>``, ``qkv_<i>``, ``proj_<i>``, ``ln2_<i>``, ``fc1_<i>``,
``fc2_<i>``, ``final_norm``). Pre-LN blocks; LayerNorms at flax's eps
(1e-6); padded keys get an additive -1e9; the MLP takes flax's default
``nn.gelu``, the tanh form.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import layer_norm, trunc_normal_


class TextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 30522, dim: int = 768,
                 depth: int = 6, num_heads: int = 12, max_len: int = 256,
                 device=None):
        super().__init__()
        self.dim, self.depth, self.num_heads = dim, depth, num_heads
        self.tok_embed = nn.Embedding(vocab_size, dim, device=device)
        self.pos_embed = nn.Parameter(torch.empty(1, max_len, dim,
                                                  device=device))
        self.embed_norm = layer_norm(dim, device=device)
        for i in range(depth):
            self.add_module(f"ln1_{i}", layer_norm(dim, device=device))
            self.add_module(f"qkv_{i}", nn.Linear(dim, 3 * dim, device=device))
            self.add_module(f"proj_{i}", nn.Linear(dim, dim, device=device))
            self.add_module(f"ln2_{i}", layer_norm(dim, device=device))
            self.add_module(f"fc1_{i}", nn.Linear(dim, 4 * dim, device=device))
            self.add_module(f"fc2_{i}", nn.Linear(4 * dim, dim, device=device))
        self.final_norm = layer_norm(dim, device=device)

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        trunc_normal_(self.pos_embed, 0.02, gen)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids/mask (B, L) -> token features (B, L, D)."""
        x = self.tok_embed(ids.long())
        x = x + self.pos_embed[:, : ids.shape[1]].to(x.dtype)
        x = self.embed_norm(x)
        nh, hd = self.num_heads, self.dim // self.num_heads
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(x.dtype)
        b, l, _ = x.shape
        for i in range(self.depth):
            h = getattr(self, f"ln1_{i}")(x)
            qkv = getattr(self, f"qkv_{i}")(h).reshape(b, l, 3, nh, hd)
            q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            a = torch.softmax(
                torch.einsum("bhqd,bhkd->bhqk", q, k) * hd**-0.5 + bias,
                dim=-1)
            o = torch.einsum("bhqk,bhkd->bhqd", a, v)
            o = o.transpose(1, 2).reshape(b, l, self.dim)
            x = x + getattr(self, f"proj_{i}")(o)
            h = getattr(self, f"fc1_{i}")(getattr(self, f"ln2_{i}")(x))
            x = x + getattr(self, f"fc2_{i}")(F.gelu(h, approximate="tanh"))
        return self.final_norm(x)

    @staticmethod
    def pool_eos(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The feature at the last valid token, ``max(sum(mask) - 1, 0)``
        (EOS pooling)."""
        last = torch.clamp(mask.sum(dim=1) - 1, min=0).long()
        return feats[torch.arange(feats.shape[0], device=feats.device), last]
