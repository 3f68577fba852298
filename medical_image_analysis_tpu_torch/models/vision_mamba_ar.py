"""Autoregressive Mamba pretraining (MambaXray-VL stage 1) in PyTorch.

Counterpart of ``medical_image_analysis_tpu/models/vision_mamba_ar.py``
(``to_clusters``, ``cluster_causal_mask``, ``CrossAttnDecoderBlock``,
``VisionMambaAR``, ``AR_CONFIGS``, ``build_vision_mamba_ar``), with the flax
modules' parameter names (``patch_embed``, ``layers_<i>``, ``norm_<k>``,
``enc2dec``, ``ar_token``, ``dec_block<i>``, ``ar_norm``, ``ar_pred``), so
that :mod:`..ckpt.from_jax` loads a JAX ``init`` into it.

Patch embed, 2-D sin-cos positions, 4x4 token clusters in cluster-major
order without the last cluster, a one-direction Mamba encoder (the fused
layer with K=1 on ``scan_backend="auto"``), the ``skip`` layers'
LayerNorms concatenated into ``enc2dec``, four cross-attention decoder
blocks under a block-causal mask, then the next cluster's pixels under a
per-patch-normalised MSE. The decoder's attention is plain PyTorch, as it
is XLA's work in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from .common import Mlp, PatchEmbed, layer_norm, trunc_normal_
from .mamba import MambaBlock
from .vit import patchify, sincos_pos_embed_2d

CLUSTER = 4  # 4x4 patches per cluster


def to_clusters(x: torch.Tensor, grid: int) -> torch.Tensor:
    """(B, grid*grid, C) row-major -> (B, n_clusters, 16, C) cluster-major."""
    b, _, c = x.shape
    g = grid // CLUSTER
    x = x.reshape(b, g, CLUSTER, g, CLUSTER, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, g * g, CLUSTER * CLUSTER, c)


def cluster_causal_mask(n_clusters: int, tokens: int = 16) -> np.ndarray:
    """Block-tril additive mask: 0 where a query's cluster may see the key's
    (its own and every earlier cluster), -inf elsewhere."""
    tril = np.tril(np.ones((n_clusters, n_clusters), np.float32))
    mask = np.where(tril == 0, -np.inf, 0.0).astype(np.float32)
    return np.repeat(np.repeat(mask, tokens, axis=0), tokens, axis=1)


class CrossAttnDecoderBlock(nn.Module):
    """Query tokens cross-attend into encoder latents under an additive
    mask, then an MLP (erf GELU); LayerNorms at flax's eps."""

    def __init__(self, dim: int, num_heads: int = 16, mlp_ratio: float = 4.0,
                 device=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.norm1 = layer_norm(dim, device=device)
        self.norm_ctx = layer_norm(dim, device=device)
        self.q = nn.Linear(dim, dim, device=device)
        self.k = nn.Linear(dim, dim, device=device)
        self.v = nn.Linear(dim, dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)
        self.norm2 = layer_norm(dim, device=device)

    def forward(self, q_tokens, context, mask):
        b, lq, _ = q_tokens.shape
        nh, hd = self.num_heads, self.dim // self.num_heads
        x = self.norm1(q_tokens)
        ctx = self.norm_ctx(context)
        q = self.q(x).reshape(b, lq, nh, hd)
        k = self.k(ctx).reshape(b, -1, nh, hd)
        v = self.v(ctx).reshape(b, -1, nh, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd**-0.5 + mask
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, lq, self.dim)
        q_tokens = q_tokens + self.proj(out)
        return q_tokens + self.mlp(self.norm2(q_tokens))


class VisionMambaAR(nn.Module):
    """AR-pretrain VisionMamba over channels-last images (B, H, W, C);
    ``forward`` returns the scalar loss. The grid of patches must be a
    multiple of 4 on each side."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, dec_embed_dim: int = 512, expand: int = 1,
                 d_state: int = 16, in_chans: int = 3, dec_heads: int = 16,
                 scan_backend: str = "auto", device=None):
        super().__init__()
        self.patch_size, self.in_chans = patch_size, in_chans
        self.depth, self.dec_embed_dim = depth, dec_embed_dim
        self.patch_embed = PatchEmbed(patch_size, embed_dim, in_chans,
                                      device=device)
        self.layers = nn.ModuleList(
            MambaBlock(embed_dim, d_state=d_state, expand=expand,
                       bimamba_type="none", scan_backend=scan_backend,
                       device=device)
            for _ in range(depth))
        for k in range(1, len(self.skip) + 1):
            self.add_module(f"norm_{k}", layer_norm(embed_dim, device=device))
        self.enc2dec = nn.Linear(len(self.skip) * embed_dim,
                                 4 * dec_embed_dim, device=device)
        self.ar_token = nn.Parameter(torch.empty(1, 1, dec_embed_dim,
                                                 device=device))
        for i in range(4):
            self.add_module(f"dec_block{i}", CrossAttnDecoderBlock(
                dec_embed_dim, dec_heads, device=device))
        self.ar_norm = layer_norm(dec_embed_dim, device=device)
        self.ar_pred = nn.Linear(dec_embed_dim, patch_size**2 * in_chans,
                                 device=device)

    @property
    def skip(self) -> list[int]:
        if self.depth == 12:
            return [6, 8, 10, 12]
        if self.depth == 24:
            return [12, 16, 20, 24]
        k = min(4, self.depth)  # small configs (tests): last k layers
        return list(range(self.depth - k + 1, self.depth + 1))

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        trunc_normal_(self.ar_token, 0.02, gen)

    def forward(self, imgs: torch.Tensor, deterministic: bool = True):
        b = imgs.shape[0]
        x = self.patch_embed(imgs)
        _, l, c = x.shape
        grid = math.isqrt(l)
        x = x + torch.from_numpy(sincos_pos_embed_2d(c, grid, False)).to(x)
        clusters = to_clusters(x, grid)  # (B, n_clusters, 16, C)
        n_ar = clusters.shape[1] - 1
        h = clusters[:, :-1].reshape(b, n_ar * 16, c)

        feats = []
        for i, layer in enumerate(self.layers):
            h = layer(h, None, deterministic)
            if (i + 1) in self.skip:
                feats.append(h)
        feats = torch.cat([getattr(self, f"norm_{k + 1}")(f)
                           for k, f in enumerate(feats)], dim=-1)
        dc = self.dec_embed_dim
        latents = self.enc2dec(feats).reshape(b, n_ar * 16, dc, 4)

        # decoder queries for clusters 1..n: the learnable ar_token plus
        # fixed sin-cos positions (next-cluster prediction)
        dec_pos = torch.from_numpy(sincos_pos_embed_2d(dc, grid, False))
        q = (self.ar_token + dec_pos.to(self.ar_token)).to(x.dtype)
        q = to_clusters(q, grid)[:, 1:].reshape(1, n_ar * 16, dc)
        q = q.expand(b, n_ar * 16, dc)
        mask = torch.from_numpy(cluster_causal_mask(n_ar)).to(x)
        for i in range(4):
            q = getattr(self, f"dec_block{i}")(q, latents[..., i], mask)
        pred = self.ar_pred(self.ar_norm(q))

        # per-patch-normalised MSE against clusters 1..n (population var)
        target = patchify(imgs, self.patch_size)
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, unbiased=False, keepdim=True)
        target = (target - mean) / torch.sqrt(var + 1e-6)
        target = to_clusters(target, grid)[:, 1:].reshape(b, n_ar * 16, -1)
        return torch.mean((pred - target) ** 2)


AR_CONFIGS = {
    "arm_base_pz16": dict(embed_dim=768, depth=12, dec_embed_dim=512),
    "arm_large_pz16": dict(embed_dim=1024, depth=24, dec_embed_dim=512),
    # HD 1280^2 variant, patch 64
    "arm_base_pz16_1280": dict(
        patch_size=64, embed_dim=768, depth=12, dec_embed_dim=512
    ),
}


def build_vision_mamba_ar(name: str, device=None,
                          **overrides) -> VisionMambaAR:
    cfg = dict(AR_CONFIGS[name])
    cfg.update(overrides)
    return VisionMambaAR(**cfg, device=device)
