"""EMRRG: an ARM encoder and the hybrid gated cross-attention decoder.

Counterpart of ``medical_image_analysis_tpu/models/emrrg.py``, with its
parameter names: a bare ARM tower (``vision``), whose tokens are split
into *slow* ones (cls, then the patch grid averaged over 2x2 windows of
stride 2), which enter the LLM's prompt through ``proj_norm`` and
``proj``, and *fast* ones (every patch token), which the hybrid layers'
cross-attention reads through ``fast_proj``; the LLM is
``HybridTransformerLM`` (``models/hybrid_decoder.py``). With
``text_only_cross`` the gate is closed over the prompt's visual span in
training (the reference's ``onlytext2media`` variant).

The partial LoRA on the tower's in_proj X half is ``train.lora_vision``
(``peft/lora.py``), not part of the module.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn as nn

from .common import layer_norm, remove_token
from .hybrid_decoder import HybridTransformerLM
from .llm import LLMConfig
from .mamba import ARM
from .mrg import GenerateConfig, MRGMixin, _encode_views


def slow_fast_split(tokens: torch.Tensor, cls_pos: int):
    """(B, L + 1, D) tokens with cls at ``cls_pos`` -> (slow (B, 1 +
    (g/2)^2, D): cls then the g x g patch grid averaged over 2x2 windows of
    stride 2; fast (B, L, D): every patch token)."""
    b, l1, d = tokens.shape
    cls, rest = remove_token(tokens, cls_pos)
    g = math.isqrt(l1 - 1)
    h = g // 2
    grid = rest.reshape(b, g, g, d)[:, : 2 * h, : 2 * h]
    slow = grid.reshape(b, h, 2, h, 2, d).sum(dim=(2, 4)) / 4.0
    return torch.cat([cls, slow.reshape(b, h * h, d)], dim=1), rest


class EMRRG(nn.Module, MRGMixin):
    def __init__(self, llm_cfg: LLMConfig, arm_kwargs: Any = None,
                 cross_every: int = 4, gate_fn: str = "tanh",
                 text_only_cross: bool = False, device=None):
        super().__init__()
        self.llm_cfg = llm_cfg
        self.cross_every = cross_every
        self.text_only_cross = text_only_cross
        self.vision = ARM(**(arm_kwargs or {}), device=device)
        self.llm = HybridTransformerLM(llm_cfg, cross_every=cross_every,
                                       gate_fn=gate_fn,
                                       text_only_cross=text_only_cross,
                                       device=device)
        vis_dim = self.vision.norm_f.normalized_shape[0]
        self.proj_norm = layer_norm(vis_dim, device=device)
        self.proj = nn.Linear(vis_dim, llm_cfg.dim, device=device)
        self.fast_proj = nn.Linear(vis_dim, llm_cfg.dim, device=device)

    def encode_img(self, images, deterministic: bool = True):
        """(B, V, H, W, 3) views (their tokens averaged; cls stays at the
        middle) or (B, H, W, 3) images -> (slow prompt tokens, fast vision
        tokens), both in the LLM's width."""
        if images.dim() == 5:
            tokens = _encode_views(lambda x: self.vision(x, deterministic),
                                   images)
        else:
            tokens = self.vision(images, deterministic)
        slow, fast = slow_fast_split(tokens, (tokens.shape[1] - 1) // 2)
        return self.proj(self.proj_norm(slow)), self.fast_proj(fast)

    def forward(self, images, before_ids, after_ids, target_ids, target_mask,
                deterministic: bool = True):
        slow, fast = self.encode_img(images, deterministic)
        prompt = self._wrap(slow, before_ids, after_ids)
        kwargs = {"vision": fast}
        if self.text_only_cross:
            # the gate closed over the visual token span
            b, dev = prompt.shape[0], prompt.device
            lb, lv = before_ids.shape[1], slow.shape[1]
            la, lt = after_ids.shape[1], target_ids.shape[1]
            kwargs["text_mask"] = torch.cat(
                [torch.ones(b, lb, device=dev), torch.zeros(b, lv, device=dev),
                 torch.ones(b, la + lt, device=dev)], dim=1)
        return self._loss(prompt, target_ids, target_mask, **kwargs)

    @torch.no_grad()
    def generate(self, images, before_ids, after_ids,
                 gcfg: GenerateConfig = GenerateConfig()):
        slow, fast = self.encode_img(images, True)
        prompt = self._wrap(slow, before_ids, after_ids)
        return self._generate(prompt, gcfg, vision=fast)
