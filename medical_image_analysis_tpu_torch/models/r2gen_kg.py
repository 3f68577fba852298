"""R2GenKG: report generation over a multi-scale knowledge graph.

Counterpart of ``medical_image_analysis_tpu/models/r2gen_kg.py``, with its
parameter names: a ``vision`` tower (Swin in the preset), a BLIP-2
``qformer`` of disease queries over its tokens, a ``lookup`` of the
queries into the disease-token bank, one ``rgcn<i>`` a graph scale, the
multi-scale ``fusion``, the graph <-> image cross blocks ``g2i`` and
``i2g``, and the LLM input [image, g2i, i2g, query, check], each through
its own projection into the LLM's width.

Graph tensors (each scale's node features (N_s + 1, node_dim) with the
dummy pad row last, edge_index (2, E), edge_type (E,)) and the disease
bank (M, bank_dim) are call-time inputs shared by the batch
(``data/side_inputs.py``). The graph branch does not depend on the images,
so the R-GCNs and the fusion run once and their output is broadcast over
the batch; the JAX package computes the same rows for every item.
``node_dim`` and ``bank_dim`` (``graph_dim`` when 0) are the widths the
JAX ``Dense`` layers infer.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

from .llm import LLMConfig, TransformerLM
from .mrg import GenerateConfig, MRGMixin, VisionEncoder
from .qformer import QFormer
from .rgcn import (
    RGCN,
    CrossAttentionLookup,
    MultiScaleSelfAttentionFusion,
    ResidualCrossAttentionBlock,
)


class R2GenKG(nn.Module, MRGMixin):
    def __init__(self, llm_cfg: LLMConfig, chosen: str = "swin",
                 vision_kwargs: Any = None, graph_dim: int = 768,
                 num_scales: int = 5, num_disease_queries: int = 14,
                 qformer_layers: int = 2, qformer_heads: int = 12,
                 num_fusion_heads: int = 8, node_dim: int = 0,
                 bank_dim: int = 0, device=None):
        super().__init__()
        self.llm_cfg = llm_cfg
        self.num_scales = num_scales
        self.vision = VisionEncoder(
            chosen, **{f"{chosen}_kwargs": vision_kwargs}, device=device)
        vis_dim = self.vision.out_dim
        self.qformer = QFormer(dim=graph_dim, num_layers=qformer_layers,
                               num_heads=qformer_heads,
                               num_queries=num_disease_queries,
                               enc_dim=vis_dim, device=device)
        self.lookup = CrossAttentionLookup(graph_dim, bank_dim or graph_dim,
                                           device=device)
        for i in range(num_scales):
            self.add_module(f"rgcn{i}", RGCN(node_dim or graph_dim,
                                             graph_dim, graph_dim,
                                             device=device))
        self.fusion = MultiScaleSelfAttentionFusion(
            graph_dim, num_scales, num_fusion_heads, device=device)
        self.img_to_graph_dim = nn.Linear(vis_dim, graph_dim, device=device)
        self.g2i = ResidualCrossAttentionBlock(graph_dim, num_fusion_heads,
                                               device=device)
        self.i2g = ResidualCrossAttentionBlock(graph_dim, num_fusion_heads,
                                               device=device)
        self.llm = TransformerLM(llm_cfg, device=device)
        self.img_proj = nn.Linear(vis_dim, llm_cfg.dim, device=device)
        for name in ("g2i_proj", "i2g_proj", "query_proj", "check_proj"):
            self.add_module(name, nn.Linear(graph_dim, llm_cfg.dim,
                                            device=device))

    def encode_img(self, images, node_feats, edge_indices, edge_types,
                   disease_bank, deterministic: bool = True):
        """(B, V, H, W, 3) views (their tokens averaged) and the graph ->
        the LLM's image embeddings."""
        b, v = images.shape[:2]
        tokens = self.vision(images.reshape(b * v, *images.shape[2:]),
                             deterministic)
        tokens = tokens.reshape(b, v, *tokens.shape[1:]).mean(dim=1)
        query = self.qformer(tokens)
        check = self.lookup(query, disease_bank)
        scale_feats = [
            getattr(self, f"rgcn{i}")(node_feats[i], edge_indices[i],
                                      edge_types[i])[None, :-1]
            for i in range(self.num_scales)]  # the dummy row dropped
        fused = self.fusion(scale_feats).expand(b, -1, -1)
        img_g = self.img_to_graph_dim(tokens)
        g2i = self.g2i(img_g, fused)  # graph into the image tokens
        i2g = self.i2g(fused, img_g)  # the image into the graph nodes
        return torch.cat([self.img_proj(tokens), self.g2i_proj(g2i),
                          self.i2g_proj(i2g), self.query_proj(query),
                          self.check_proj(check)], dim=1)

    def forward(self, images, node_feats, edge_indices, edge_types,
                disease_bank, before_ids, after_ids, target_ids, target_mask,
                deterministic: bool = True):
        img = self.encode_img(images, node_feats, edge_indices, edge_types,
                              disease_bank, deterministic)
        prompt = self._wrap(img, before_ids, after_ids)
        return self._loss(prompt, target_ids, target_mask)

    @torch.no_grad()
    def generate(self, images, node_feats, edge_indices, edge_types,
                 disease_bank, before_ids, after_ids,
                 gcfg: GenerateConfig = GenerateConfig()):
        img = self.encode_img(images, node_feats, edge_indices, edge_types,
                              disease_bank, True)
        prompt = self._wrap(img, before_ids, after_ids)
        return self._generate(prompt, gcfg)
