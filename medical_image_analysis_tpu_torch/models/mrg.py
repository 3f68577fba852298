"""Medical report generation: R2GenGPT and R2GenCSR in PyTorch.

Counterpart of ``medical_image_analysis_tpu/models/mrg.py``:
``encoder -> projector (LayerNorm + Linear, or a Q-Former) -> [prompt,
visual, text] -> LLM``, a teacher-forced cross-entropy forward, and
HF-style generation with the shared-prompt split beam cache.

Batch convention (as in the JAX package):
  images       (B, V, H, W, 3)    V views, channels-last
  context_images (B, 2N, H, W, 3) R2GenCSR: N positive, then N negative
  before_ids   (B, Lb)  prompt text before the image (starts with BOS)
  after_ids    (B, La)  prompt text after the image
  target_ids   (B, Lt)  report tokens, target_mask (B, Lt) 1 = real
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn as nn

from ..parallel.mesh import loss_denominator
from .common import layer_norm
from .generation import beam_generate, greedy_generate
from .llm import (
    LLMConfig,
    TransformerLM,
    init_cache,
    reorder_cache,
    split_beam_cache,
)
from .mamba import ARM
from .qformer import EncoderProjectorQFormer
from .swin import SwinTransformer
from .vit import ViT
from .vmamba import VSSM


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    """HF-generate settings (R2GenCSR/configs/config.py:62-68)."""

    num_beams: int = 3
    max_new_tokens: int = 120
    min_new_tokens: int = 80
    repetition_penalty: float = 2.0
    length_penalty: float = 2.0
    no_repeat_ngram_size: int = 2
    eos_id: int = 2
    max_cache_len: int = 1024
    # Split append-only beam KV cache: prompt KV once per item, generated
    # KV per beam, ancestry resolved inside attention. Same tokens as the
    # reorder path.
    beam_ancestry: bool = True


def lm_cross_entropy(logits, labels, mask):
    """Shifted teacher-forced CE: logits[t] predicts labels[t+1]."""
    logits = logits[:, :-1]
    labels = labels[:, 1:]
    mask = mask[:, 1:]
    lp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(lp, -1, labels[..., None].long())[..., 0]
    return -torch.sum(ll * mask) / loss_denominator(torch.sum(mask), 1.0)


def _encode_views(vision_fn, images, use_feature_mean=True):
    """Run the encoder over views and mean or concat them."""
    b, v = images.shape[:2]
    tokens = vision_fn(images.reshape(b * v, *images.shape[2:]))
    tokens = tokens.reshape(b, v, *tokens.shape[1:])
    if use_feature_mean:
        return tokens.mean(dim=1)
    return tokens.reshape(b, -1, tokens.shape[-1])


class VisionEncoder(nn.Module):
    """Encoder dispatch -> tokens (B, L, D): the Swin tower's final tokens,
    the VSSM's last feature map flattened row-major, the ARM tower, or the
    ViT's patch tokens (cls dropped). ``out_dim`` is D."""

    def __init__(self, chosen: str = "swin", swin_kwargs: Any = None,
                 vssm_kwargs: Any = None, arm_kwargs: Any = None,
                 vit_kwargs: Any = None, device=None):
        super().__init__()
        self.chosen = chosen
        if chosen == "swin":
            self.swin = SwinTransformer(**(swin_kwargs or {}), device=device)
            self.out_dim = self.swin.out_dim
        elif chosen == "vssm":
            self.vssm = VSSM(**(vssm_kwargs or {}), device=device)
            self.out_dim = self.vssm.dims[-1]
        elif chosen == "arm":
            self.arm = ARM(**(arm_kwargs or {}), device=device)
            self.out_dim = self.arm.norm_f.normalized_shape[0]
        elif chosen == "vit":
            self.vit = ViT(**(vit_kwargs or {}), device=device)
            self.out_dim = self.vit.cls_token.shape[-1]
        else:
            raise ValueError(f"unknown vision tower {chosen!r}")

    def forward(self, x, deterministic: bool = True):
        if self.chosen == "swin":
            return self.swin(x, deterministic)
        if self.chosen == "vssm":
            fmap = self.vssm(x, pool=False, deterministic=deterministic)
            b, h, w, c = fmap.shape
            return fmap.reshape(b, h * w, c)
        if self.chosen == "vit":
            # MAE-pretrained ViT patch features: the patch tokens
            return self.vit(x, deterministic)[:, 1:]
        return self.arm(x, deterministic)


class MRGMixin:
    """Shared prompt assembly / loss / generate for MRG models.

    Subclasses provide ``llm``, ``llm_cfg`` and ``encode_img``.
    """

    def _wrap(self, img_emb, before_ids, after_ids):
        be = self.llm.embed(before_ids)
        ae = self.llm.embed(after_ids)
        return torch.cat([be, img_emb.to(be.dtype), ae], dim=1)

    def _loss(self, prompt_emb, target_ids, target_mask, **llm_kwargs):
        te = self.llm.embed(target_ids)
        embeds = torch.cat([prompt_emb, te], dim=1)
        b, lp = prompt_emb.shape[:2]
        dev = prompt_emb.device
        attn = torch.cat(
            [torch.ones(b, lp, dtype=torch.int32, device=dev),
             target_mask.to(torch.int32)], dim=1,
        )
        logits = self.llm(inputs_embeds=embeds, attention_mask=attn,
                          **llm_kwargs)
        labels = torch.cat(
            [torch.zeros(b, lp, dtype=target_ids.dtype, device=dev),
             target_ids], dim=1,
        )
        mask = torch.cat(
            [torch.zeros(b, lp, device=dev), target_mask.float()], dim=1
        )
        return lm_cross_entropy(logits, labels, mask)

    def _generate(self, prompt_emb, gcfg: GenerateConfig, **llm_kwargs):
        b, lp, _ = prompt_emb.shape
        dev = prompt_emb.device
        nb = gcfg.num_beams
        use_split = nb > 1 and gcfg.beam_ancestry

        def repeat_rows(kw):
            return {k: v.repeat_interleave(nb, dim=0)
                    if isinstance(v, torch.Tensor) else v
                    for k, v in kw.items()}

        if nb > 1 and not use_split:
            prompt_emb = prompt_emb.repeat_interleave(nb, dim=0)
            llm_kwargs = repeat_rows(llm_kwargs)
        if use_split:
            # shared-prompt prefill on B rows, promoted to the split cache
            prefill_rows = b
            cache = init_cache(self.llm_cfg, b, lp, device=dev,
                               n_kv_heads=self.llm.kv_heads)
        else:
            prefill_rows = b * max(nb, 1)
            cache = init_cache(self.llm_cfg, prefill_rows,
                               gcfg.max_cache_len, device=dev,
                               n_kv_heads=self.llm.kv_heads)
        positions = torch.arange(lp, device=dev).expand(prefill_rows, lp)
        first, cache = self.llm(inputs_embeds=prompt_emb,
                                positions=positions, cache=cache,
                                **llm_kwargs)
        first = first[:, -1]
        if use_split:
            cache = split_beam_cache(cache, nb, gcfg.max_new_tokens)
            first = first.repeat_interleave(nb, dim=0)
            llm_kwargs = repeat_rows(llm_kwargs)

        def step(tokens, cache, t):
            # body t consumes the token picked at step t-1, at absolute
            # position lp + t - 1 (cache slot == position)
            pos = torch.full((tokens.shape[0], 1), lp + t - 1, device=dev)
            logits, cache = self.llm(input_ids=tokens, positions=pos,
                                     cache=cache, **llm_kwargs)
            return logits[:, 0], cache

        def step_anc(tokens, cache, anc, t):
            pos = torch.full((tokens.shape[0], 1), lp + t - 1, device=dev)
            logits, cache = self.llm(input_ids=tokens, positions=pos,
                                     cache=cache, beam=anc.reshape(b, nb, -1),
                                     **llm_kwargs)
            return logits[:, 0], cache

        if nb > 1:
            return beam_generate(
                step_anc if use_split else step, cache, first,
                batch=b, num_beams=nb,
                max_new_tokens=gcfg.max_new_tokens, eos_id=gcfg.eos_id,
                min_new_tokens=gcfg.min_new_tokens,
                repetition_penalty=gcfg.repetition_penalty,
                length_penalty=gcfg.length_penalty,
                no_repeat_ngram_size=gcfg.no_repeat_ngram_size,
                reorder_cache_fn=reorder_cache,
                # anc indexes the GENERATED segment only; writes there
                # start at gen slot 0, hence prompt_len=0
                ancestry_slots=gcfg.max_new_tokens if use_split else None,
                prompt_len=0,
            )
        return greedy_generate(
            step, cache, first,
            max_new_tokens=gcfg.max_new_tokens, eos_id=gcfg.eos_id,
            min_new_tokens=gcfg.min_new_tokens,
            repetition_penalty=gcfg.repetition_penalty,
            no_repeat_ngram_size=gcfg.no_repeat_ngram_size,
        )


class R2GenGPT(nn.Module, MRGMixin):
    """The canonical MRG skeleton: vision tower, projector, decoder LM. The
    ``linear`` projector is LayerNorm + Linear (``proj_norm``, ``proj``);
    ``qformer`` is a 2-layer, 64-query Q-Former into the LLM's width
    (``proj_q``, ``models/qformer.py``)."""

    def __init__(
        self,
        llm_cfg: LLMConfig,
        chosen: str = "swin",
        vision_kwargs: Any = None,
        projector: str = "linear",
        use_feature_mean: bool = True,
        global_only: bool = False,
        device=None,
    ):
        super().__init__()
        if projector not in ("linear", "qformer"):
            raise ValueError(f"unknown projector {projector!r}")
        self.llm_cfg = llm_cfg
        self.projector = projector
        self.use_feature_mean = use_feature_mean
        self.global_only = global_only
        self.vision = VisionEncoder(
            chosen, **{f"{chosen}_kwargs": vision_kwargs}, device=device)
        self.llm = TransformerLM(llm_cfg, device=device)
        vis_dim = self.vision.out_dim
        if projector == "linear":
            self.proj_norm = layer_norm(vis_dim, device=device)
            self.proj = nn.Linear(vis_dim, llm_cfg.dim, device=device)
        else:
            self.proj_q = EncoderProjectorQFormer(
                out_dim=llm_cfg.dim, enc_dim=vis_dim, device=device)

    def encode_img(self, images, deterministic: bool = True):
        tokens = _encode_views(
            lambda x: self.vision(x, deterministic), images,
            self.use_feature_mean,
        )
        if self.global_only:
            tokens = tokens.mean(dim=1, keepdim=True)
        if self.projector == "linear":
            return self.proj(self.proj_norm(tokens))
        return self.proj_q(tokens)

    def forward(self, images, before_ids, after_ids, target_ids, target_mask,
                deterministic: bool = True):
        img = self.encode_img(images, deterministic)
        prompt = self._wrap(img, before_ids, after_ids)
        return self._loss(prompt, target_ids, target_mask)

    @torch.no_grad()
    def generate(self, images, before_ids, after_ids,
                 gcfg: GenerateConfig = GenerateConfig()):
        img = self.encode_img(images, True)
        prompt = self._wrap(img, before_ids, after_ids)
        return self._generate(prompt, gcfg)


class R2GenCSR(nn.Module, MRGMixin):
    """Context-sample retrieval MRG.

    The context images (N positive then N negative exemplars per study,
    drawn by the data layer) are encoded by the same tower without a
    gradient and pooled; the prompt carries the residuals (the study's
    global image feature minus each context feature, through ``ctx_proj``)
    behind learnable positive and negative marker embeddings, then the
    study's projected image tokens.
    """

    def __init__(
        self,
        llm_cfg: LLMConfig,
        chosen: str = "swin",
        vision_kwargs: Any = None,
        use_feature_mean: bool = True,
        device=None,
    ):
        super().__init__()
        self.llm_cfg = llm_cfg
        self.use_feature_mean = use_feature_mean
        self.vision = VisionEncoder(
            chosen, **{f"{chosen}_kwargs": vision_kwargs}, device=device)
        self.llm = TransformerLM(llm_cfg, device=device)
        vis_dim = self.vision.out_dim
        self.proj_norm = layer_norm(vis_dim, device=device)
        self.proj = nn.Linear(vis_dim, llm_cfg.dim, device=device)
        self.ctx_proj = nn.Linear(vis_dim, llm_cfg.dim, device=device)
        self.pos_marker = nn.Parameter(
            torch.empty(1, 1, llm_cfg.dim, device=device))
        self.neg_marker = nn.Parameter(
            torch.empty(1, 1, llm_cfg.dim, device=device))

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        for marker in (self.pos_marker, self.neg_marker):
            tmp = torch.empty(marker.shape, device=marker.device)
            marker.copy_(tmp.normal_(0.0, 0.02, generator=gen))

    def encode_img(self, images, deterministic: bool = True):
        """(projected image tokens (B, L, dim), global feature (B, D_vis))."""
        tokens = _encode_views(
            lambda x: self.vision(x, deterministic), images,
            self.use_feature_mean,
        )
        return self.proj(self.proj_norm(tokens)), tokens.mean(dim=1)

    def context_residuals(self, global_feat, context_images):
        """(B, D_vis) global features minus the pooled features of the
        (B, N, H, W, 3) context images, in LLM space. The context tower runs
        without a gradient (the JAX package's ``stop_gradient``)."""
        b, n = context_images.shape[:2]
        flat = context_images.reshape(b * n, *context_images.shape[2:])
        with torch.no_grad():
            ctx = self.vision(flat, True).mean(dim=1).reshape(b, n, -1)
        return self.ctx_proj(global_feat[:, None, :] - ctx)

    def _prompt(self, images, context_images, before_ids, after_ids,
                deterministic):
        img, global_feat = self.encode_img(images, deterministic)
        return self.context_prompt(img, global_feat, context_images,
                                   before_ids, after_ids)

    def context_prompt(self, img, global_feat, context_images, before_ids,
                       after_ids):
        """The prompt from ``encode_img``'s outputs: [before, pos marker,
        positive residuals, neg marker, negative residuals, image tokens,
        after]."""
        ctx = self.context_residuals(global_feat, context_images)
        b, n = ctx.shape[0], ctx.shape[1] // 2
        pos = self.pos_marker.expand(b, 1, self.llm_cfg.dim)
        neg = self.neg_marker.expand(b, 1, self.llm_cfg.dim)
        ctx_emb = torch.cat([pos, ctx[:, :n], neg, ctx[:, n:]], dim=1)
        return self._wrap(torch.cat([ctx_emb, img], dim=1), before_ids,
                          after_ids)

    def forward(self, images, context_images, before_ids, after_ids,
                target_ids, target_mask, deterministic: bool = True):
        prompt = self._prompt(images, context_images, before_ids, after_ids,
                              deterministic)
        return self._loss(prompt, target_ids, target_mask)

    @torch.no_grad()
    def generate(self, images, context_images, before_ids, after_ids,
                 gcfg: GenerateConfig = GenerateConfig()):
        prompt = self._prompt(images, context_images, before_ids, after_ids,
                              True)
        return self._generate(prompt, gcfg)
