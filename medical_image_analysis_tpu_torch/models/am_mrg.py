"""AM-MRG: report generation with Hopfield associative memories.

Counterpart of ``medical_image_analysis_tpu/models/am_mrg.py``, with its
parameter names: a bare ARM tower (``vision``), ``qformer_proj`` to
``qformer_width``, a BLIP-2 ``qformer`` with ``num_disease_queries``
queries, two ``HopfieldLayer`` lookups (``visual_memory`` into the stage-1
CAM visual memory bank, ``report_memory`` into the report memory bank),
and the LLM input [visual, query, disease memory, report memory], each
through its own projection into the LLM's width.

The banks are call-time inputs, (M, bank width), shared by the batch
(``data/side_inputs.py`` builds them). The JAX ``Dense`` layers infer the
widths they read; here ``visual_bank_dim`` and ``report_bank_dim`` give
the banks' (``qformer_dim`` when 0), and the tower's width comes from
``arm_kwargs``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

from .hopfield import HopfieldLayer
from .llm import LLMConfig, TransformerLM
from .mamba import ARM
from .mrg import GenerateConfig, MRGMixin, _encode_views
from .qformer import QFormer


class AMMRG(nn.Module, MRGMixin):
    def __init__(self, llm_cfg: LLMConfig, arm_kwargs: Any = None,
                 qformer_dim: int = 768, qformer_width: int = 1408,
                 num_disease_queries: int = 14, qformer_layers: int = 12,
                 qformer_heads: int = 12, hopfield_hidden: int = 0,
                 hopfield_heads: int = 6, hopfield_scaling: float = 4.0,
                 visual_bank_dim: int = 0, report_bank_dim: int = 0,
                 device=None):
        super().__init__()
        self.llm_cfg = llm_cfg
        self.vision = ARM(**(arm_kwargs or {}), device=device)
        vis_dim = self.vision.norm_f.normalized_shape[0]
        self.qformer_proj = nn.Linear(vis_dim, qformer_width, device=device)
        self.qformer = QFormer(dim=qformer_dim, num_layers=qformer_layers,
                               num_heads=qformer_heads,
                               num_queries=num_disease_queries,
                               enc_dim=qformer_width, device=device)
        # the reference's association width: 1024 a head at 768
        hh = hopfield_hidden or 4 * qformer_dim // 3
        for name, bank_dim in (("visual_memory", visual_bank_dim),
                               ("report_memory", report_bank_dim)):
            self.add_module(name, HopfieldLayer(
                qformer_dim, hh, num_heads=hopfield_heads,
                pattern_dim=qformer_dim, scaling=hopfield_scaling,
                bank_dim=bank_dim or qformer_dim, device=device))
        self.llm = TransformerLM(llm_cfg, device=device)
        self.visual_proj = nn.Linear(vis_dim, llm_cfg.dim, device=device)
        for name in ("query_proj", "dmem_proj", "rmem_proj"):
            self.add_module(name, nn.Linear(qformer_dim, llm_cfg.dim,
                                            device=device))

    def encode_img(self, images, visual_bank, report_bank,
                   deterministic: bool = True):
        """(B, V, H, W, 3) views (their tokens averaged) or (B, H, W, 3)
        images -> the LLM's image embeddings (B, L + 3 x queries, dim)."""
        if images.dim() == 5:
            tokens = _encode_views(lambda x: self.vision(x, deterministic),
                                   images)
        else:
            tokens = self.vision(images, deterministic)
        query = self.qformer(self.qformer_proj(tokens))
        dmem = self.visual_memory(query, visual_bank)
        rmem = self.report_memory(query, report_bank)
        return torch.cat([self.visual_proj(tokens), self.query_proj(query),
                          self.dmem_proj(dmem), self.rmem_proj(rmem)], dim=1)

    def forward(self, images, visual_bank, report_bank, before_ids,
                after_ids, target_ids, target_mask,
                deterministic: bool = True):
        img = self.encode_img(images, visual_bank, report_bank, deterministic)
        prompt = self._wrap(img, before_ids, after_ids)
        return self._loss(prompt, target_ids, target_mask)

    @torch.no_grad()
    def generate(self, images, visual_bank, report_bank, before_ids,
                 after_ids, gcfg: GenerateConfig = GenerateConfig()):
        img = self.encode_img(images, visual_bank, report_bank, True)
        prompt = self._wrap(img, before_ids, after_ids)
        return self._generate(prompt, gcfg)
