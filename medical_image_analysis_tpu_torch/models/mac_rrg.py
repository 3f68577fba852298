"""MAC-RRG: R2GenGPT whose prompt also carries the agents' embeddings.

Counterpart of ``medical_image_analysis_tpu/models/mac_rrg.py``, with its
parameter names: a ``vision`` tower (Swin in the preset), and the LLM
prompt [image, rag, concept, text]: the image tokens through
``proj_norm`` (flax LayerNorm, eps 1e-6) and ``proj``, the retrieved
chunks' embeddings (B, max_chunks, rag_dim) through ``rag_proj`` and the
concepts' (B, max_entities, concept_dim) through ``concept_proj``. No row
is masked: the zero-padded rag and concept rows still carry their
projections' biases, as in the JAX package. The rag and concept arrays
come from the host-side agents (``agents/``, ``data.side_inputs.
MACContext``) over a draft report; ``train/mac_driver.py`` iterates
draft -> agents -> regenerate. ``rag_dim`` and ``concept_dim`` are the
widths the JAX ``Dense`` layers infer.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

from .common import layer_norm
from .llm import LLMConfig, TransformerLM
from .mrg import GenerateConfig, MRGMixin, VisionEncoder, _encode_views


class MACRRG(nn.Module, MRGMixin):
    def __init__(self, llm_cfg: LLMConfig, chosen: str = "swin",
                 vision_kwargs: Any = None, use_feature_mean: bool = True,
                 rag_dim: int = 64, concept_dim: int = 64, device=None):
        super().__init__()
        self.llm_cfg = llm_cfg
        self.use_feature_mean = use_feature_mean
        self.vision = VisionEncoder(
            chosen, **{f"{chosen}_kwargs": vision_kwargs}, device=device)
        self.llm = TransformerLM(llm_cfg, device=device)
        vis_dim = self.vision.out_dim
        self.proj_norm = layer_norm(vis_dim, device=device)
        self.proj = nn.Linear(vis_dim, llm_cfg.dim, device=device)
        self.rag_proj = nn.Linear(rag_dim, llm_cfg.dim, device=device)
        self.concept_proj = nn.Linear(concept_dim, llm_cfg.dim, device=device)

    def encode_img(self, images, rag_embeds, concept_embeds,
                   deterministic: bool = True):
        tokens = _encode_views(
            lambda x: self.vision(x, deterministic), images,
            self.use_feature_mean,
        )
        return torch.cat([self.proj(self.proj_norm(tokens)),
                          self.rag_proj(rag_embeds),
                          self.concept_proj(concept_embeds)], dim=1)

    def forward(self, images, rag_embeds, concept_embeds, before_ids,
                after_ids, target_ids, target_mask,
                deterministic: bool = True):
        img = self.encode_img(images, rag_embeds, concept_embeds,
                              deterministic)
        prompt = self._wrap(img, before_ids, after_ids)
        return self._loss(prompt, target_ids, target_mask)

    @torch.no_grad()
    def generate(self, images, rag_embeds, concept_embeds, before_ids,
                 after_ids, gcfg: GenerateConfig = GenerateConfig()):
        img = self.encode_img(images, rag_embeds, concept_embeds, True)
        prompt = self._wrap(img, before_ids, after_ids)
        return self._generate(prompt, gcfg)
