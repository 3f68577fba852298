"""MambaXray-VL's stage-2 CLIP alignment model.

Counterpart of ``medical_image_analysis_tpu/models/mambaxray_vl.py``: the
ARM tower (``visual_encoder``, mean-pooled over its tokens) beside a text
tower (``text_encoder``, EOS-pooled): the scratch
:class:`.text_encoder.TextEncoder`, or with ``text_tower="bert"`` the
Bio_ClinicalBERT-shaped :class:`.bert.BertModel`; then
:class:`.clip.CLIPHead` (``head``) and the symmetric InfoNCE. Stage 3 is
:class:`.mrg.R2GenGPT` on the ARM, reached through ``model.vision_init``
(``ckpt/bridge.py``).
"""

from __future__ import annotations

from typing import Any

import torch.nn as nn

from .bert import BertConfig, BertModel
from .clip import CLIPHead, clip_loss
from .mamba import ARM
from .text_encoder import TextEncoder


class MambaXrayVLCLIP(nn.Module):
    def __init__(self, arm_kwargs: Any = None, text_kwargs: Any = None,
                 proj_dim: int = 2048, text_tower: str = "scratch",
                 device=None):
        super().__init__()
        self.visual_encoder = ARM(**(arm_kwargs or {}), device=device)
        if text_tower == "bert":
            cfg = BertConfig(**(text_kwargs or {}))
            self.text_encoder = BertModel(cfg, device=device)
            text_dim = cfg.dim
        else:
            self.text_encoder = TextEncoder(**(text_kwargs or {}),
                                            device=device)
            text_dim = self.text_encoder.dim
        vision_dim = self.visual_encoder.norm_f.normalized_shape[0]
        self.head = CLIPHead(vision_dim, text_dim, proj_dim, device=device)

    def encode_img(self, images, deterministic: bool = True):
        return self.visual_encoder(images, deterministic).mean(dim=1)

    def encode_txt(self, ids, mask):
        return TextEncoder.pool_eos(self.text_encoder(ids, mask), mask)

    def forward(self, images, text_ids, text_mask,
                deterministic: bool = True):
        v = self.encode_img(images, deterministic)
        t = self.encode_txt(text_ids, text_mask)
        return clip_loss(*self.head(v, t))
