"""The masked autoencoder (MAE) with X-ray region masking, and its ViT blocks.

Counterpart of ``medical_image_analysis_tpu/models/vit.py``
(``sincos_pos_embed_2d``, ``TransformerBlock``, ``patchify``,
``unpatchify``, ``random_mask_ids``, ``random_masking``,
``region_masking``, ``MAE``, ``MAE_CONFIGS``, ``build_mae``), with the
region masking's ids split out (``region_split``, ``region_mask_ids``) and
``set_fused`` for the plain comparison path. Inputs are
channels-last (B, H, W, C), as in the JAX package. ``ViT`` is not ported
yet (ROADMAP.md, queue 1, item 14).

Masking takes its noise from the caller: ``noise`` (B, L) uniform in [0, 1)
stands for the JAX package's ``jax.random.uniform(rng, (n, l))`` in random
masking, and for the two draws of region masking side by side (the
exterior's ``len(idx_out)`` columns first, then the interior's). Training
draws it from a ``torch.Generator`` (``train.loop.mae_mask_noise``); a
test hands both packages the same numbers. Shuffles are stable argsorts, as
``jnp.argsort`` is.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..ops.gather import perm_gather, subset_gather, take_rows
from ..ops.vit_block import fused_attn_block, fused_mlp_block
from .common import (
    DropPath,
    PatchEmbed,
    layer_norm,
    lecun_normal_,
    trunc_normal_,
)


def sincos_pos_embed_2d(dim: int, grid: int, cls_token: bool = True) -> np.ndarray:
    """Fixed 2D sin-cos positional embedding, (1, grid²(+1), dim)."""
    assert dim % 4 == 0
    coords = np.arange(grid, dtype=np.float32)
    gy, gx = np.meshgrid(coords, coords, indexing="ij")
    omega = np.arange(dim // 4, dtype=np.float32) / (dim / 4)
    omega = 1.0 / 10000**omega

    def embed(pos):
        out = pos.reshape(-1)[:, None] * omega[None, :]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    pe = np.concatenate([embed(gy), embed(gx)], axis=1)  # (L, dim)
    if cls_token:
        pe = np.concatenate([np.zeros((1, dim), np.float32), pe], axis=0)
    return pe[None]


def _pos(dim: int, grid: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(sincos_pos_embed_2d(dim, grid)).to(
        device=like.device, dtype=like.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN ViT block over raw parameters in the JAX layout
    (``qkv_kernel`` (d, 3d), ``proj_kernel`` (d, d), ``fc1_kernel``
    (d, hidden), ``fc2_kernel`` (hidden, d), ``ln1_scale``, ...).

    Each sub-layer goes through the kernel wrappers of ``ops/vit_block.py``
    (the kernels on a CUDA tensor, their plain versions on a CPU tensor);
    ``plain`` takes the plain versions on any device, forward and backward
    (for comparisons). Stochastic depth in training drops each sub-layer's
    branch ``y - x`` around the wrapper's output.
    """

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, plain: bool = False, device=None):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.dim, self.num_heads, self.plain = dim, num_heads, plain
        self.drop_path = drop_path

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.ln1_scale, self.ln1_bias = param(dim), param(dim)
        self.qkv_kernel, self.qkv_bias = param(dim, 3 * dim), param(3 * dim)
        self.proj_kernel, self.proj_bias = param(dim, dim), param(dim)
        self.ln2_scale, self.ln2_bias = param(dim), param(dim)
        self.fc1_kernel, self.fc1_bias = param(dim, hidden), param(hidden)
        self.fc2_kernel, self.fc2_bias = param(hidden, dim), param(dim)
        self.dp1, self.dp2 = DropPath(drop_path), DropPath(drop_path)

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        """flax's initialisers: lecun_normal kernels, zero biases, unit
        LayerNorm scales."""
        for k in (self.qkv_kernel, self.proj_kernel, self.fc1_kernel,
                  self.fc2_kernel):
            lecun_normal_(k, k.shape[0], gen)
        for bias in (self.ln1_bias, self.qkv_bias, self.proj_bias,
                     self.ln2_bias, self.fc1_bias, self.fc2_bias):
            bias.zero_()
        self.ln1_scale.fill_(1.0)
        self.ln2_scale.fill_(1.0)

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        dt = x.dtype

        def w(p):
            return p.to(dt)

        dropping = self.drop_path > 0 and not deterministic
        y = fused_attn_block(
            x, w(self.qkv_kernel), w(self.qkv_bias), w(self.proj_kernel),
            w(self.proj_bias), w(self.ln1_scale), w(self.ln1_bias),
            self.num_heads, self.plain)
        x = x + self.dp1(y - x, deterministic) if dropping else y
        y = fused_mlp_block(
            x, w(self.fc1_kernel), w(self.fc1_bias), w(self.fc2_kernel),
            w(self.fc2_bias), w(self.ln2_scale), w(self.ln2_bias), self.plain)
        return x + self.dp2(y - x, deterministic) if dropping else y


def set_fused(module: nn.Module, fused: bool) -> None:
    """Every ``TransformerBlock`` under ``module`` through the kernel
    wrappers (``fused``) or the plain versions."""
    for m in module.modules():
        if isinstance(m, TransformerBlock):
            m.plain = not fused


def patchify(imgs: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, L, p*p*C)."""
    b, h, w, c = imgs.shape
    x = imgs.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, p: int, h: int, w: int, c: int) -> torch.Tensor:
    b = x.shape[0]
    x = x.reshape(b, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _ids_from_shuffle(ids_shuffle: torch.Tensor, len_keep: int):
    n, l = ids_shuffle.shape
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    mask = torch.ones(n, l, device=ids_shuffle.device)
    mask[:, :len_keep] = 0.0
    return (ids_shuffle[:, :len_keep], torch.gather(mask, 1, ids_restore),
            ids_restore)


def random_mask_ids(noise: torch.Tensor, mask_ratio: float):
    """Keep/restore indices for per-sample random masking from ``noise``
    (n, l). Returns (ids_keep (n, len_keep), mask (n, l; 1 = removed),
    ids_restore (n, l))."""
    l = noise.shape[1]
    len_keep = int(l * (1 - mask_ratio))
    return _ids_from_shuffle(torch.argsort(noise, dim=1, stable=True),
                             len_keep)


def random_masking(x: torch.Tensor, noise: torch.Tensor, mask_ratio: float):
    """Per-sample random masking; returns (x_keep, mask, ids_restore)."""
    ids_keep, mask, ids_restore = random_mask_ids(noise, mask_ratio)
    return take_rows(x, ids_keep), mask, ids_restore


def region_split(l: int) -> tuple[np.ndarray, np.ndarray]:
    """(idx_out, idx_in) of the chest region of a sqrt(l) grid: rows
    [0.25s+1, 0.75s+1) and cols [0.125s+1, 0.75s+1) are the interior."""
    s = int(math.isqrt(l))
    assert s * s == l
    label = np.zeros((s, s), np.int32)
    label[int(s * 0.25) + 1 : int(s * 0.75) + 1,
          int(s * 0.125) + 1 : int(s * 0.75) + 1] = 1
    label = label.reshape(-1)
    return np.nonzero(label == 0)[0], np.nonzero(label == 1)[0]


def region_mask_ids(noise: torch.Tensor, mask_ratio_outer: float,
                    mask_ratio_inner: float):
    """Keep/restore indices of chest-region masking from ``noise`` (n, l):
    its first ``len(idx_out)`` columns shuffle the exterior, masked at
    ``mask_ratio_outer``, the rest the interior, masked at
    ``mask_ratio_inner``. Returns what :func:`random_mask_ids` returns."""
    l = noise.shape[1]
    idx_out, idx_in = region_split(l)
    keep_out = int(len(idx_out) * (1 - mask_ratio_outer))
    keep_in = int(len(idx_in) * (1 - mask_ratio_inner))
    dev = noise.device
    sh_out = torch.as_tensor(idx_out, device=dev)[
        torch.argsort(noise[:, : len(idx_out)], dim=1, stable=True)]
    sh_in = torch.as_tensor(idx_in, device=dev)[
        torch.argsort(noise[:, len(idx_out):], dim=1, stable=True)]
    ids_shuffle = torch.cat([sh_out[:, :keep_out], sh_in[:, :keep_in],
                             sh_out[:, keep_out:], sh_in[:, keep_in:]], dim=1)
    return _ids_from_shuffle(ids_shuffle, keep_out + keep_in)


def region_masking(x: torch.Tensor, noise: torch.Tensor,
                   mask_ratio_outer: float, mask_ratio_inner: float):
    """Chest-region masking (``random_masking_yiliao`` of the reference
    MAE); returns (x_keep, mask, ids_restore)."""
    ids_keep, mask, ids_restore = region_mask_ids(noise, mask_ratio_outer,
                                                  mask_ratio_inner)
    return subset_gather(x, ids_keep, ids_restore), mask, ids_restore


class MAE(nn.Module):
    """Masked autoencoder over channels-last images, with fixed sin-cos
    positions; parameter names and layouts are the flax module's
    (``block{i}``, ``dec_block{i}``, ``encoder_norm``, ...)."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 decoder_embed_dim: int = 512, decoder_depth: int = 8,
                 decoder_num_heads: int = 16, mlp_ratio: float = 4.0,
                 norm_pix_loss: bool = True, device=None):
        super().__init__()
        self.patch_size, self.in_chans = patch_size, in_chans
        self.norm_pix_loss = norm_pix_loss
        self.patch_embed = PatchEmbed(patch_size, embed_dim, in_chans,
                                      device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim,
                                                  device=device))
        self.blocks = []
        for i in range(depth):
            self.blocks.append(TransformerBlock(embed_dim, num_heads,
                                                mlp_ratio, device=device))
            self.add_module(f"block{i}", self.blocks[-1])
        self.encoder_norm = layer_norm(embed_dim, device=device)
        self.decoder_embed = nn.Linear(embed_dim, decoder_embed_dim,
                                       device=device)
        self.mask_token = nn.Parameter(torch.empty(1, 1, decoder_embed_dim,
                                                   device=device))
        self.decoder_blocks = []
        for i in range(decoder_depth):
            self.decoder_blocks.append(TransformerBlock(
                decoder_embed_dim, decoder_num_heads, mlp_ratio,
                device=device))
            self.add_module(f"dec_block{i}", self.decoder_blocks[-1])
        self.decoder_norm = layer_norm(decoder_embed_dim, device=device)
        self.decoder_pred = nn.Linear(decoder_embed_dim,
                                      patch_size**2 * in_chans, device=device)

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        trunc_normal_(self.cls_token, 0.02, gen)
        trunc_normal_(self.mask_token, 0.02, gen)

    def num_patches(self, imgs: torch.Tensor) -> int:
        p = self.patch_size
        return (imgs.shape[1] // p) * (imgs.shape[2] // p)

    def encode(self, imgs, noise=None, mask_type="random", mask_ratio=0.75,
               mask_ratio_inner=0.75, deterministic=True):
        """Returns (latent (B, 1 + kept, D), mask (B, L), ids_restore)."""
        if mask_type == "random" and noise is not None:
            # mask first: embed only the kept patches
            b, l = imgs.shape[0], self.num_patches(imgs)
            ids_keep, mask, ids_restore = random_mask_ids(noise, mask_ratio)
            kept = take_rows(patchify(imgs, self.patch_size), ids_keep)
            x = self.patch_embed.embed_flat(kept)
            d = x.shape[-1]
            pos = _pos(d, int(math.isqrt(l)), x)
            x = x + take_rows(pos[:, 1:].expand(b, l, d), ids_keep)
        else:
            x = self.patch_embed(imgs)
            b, l, d = x.shape
            pos = _pos(d, int(math.isqrt(l)), x)
            x = x + pos[:, 1:]
            if mask_type == "none" or noise is None:
                mask = torch.zeros(b, l, device=x.device)
                ids_restore = torch.arange(l, device=x.device).expand(b, l)
            else:
                x, mask, ids_restore = region_masking(
                    x, noise, mask_ratio, mask_ratio_inner)
        cls = (self.cls_token + pos[:, :1]).expand(b, 1, d).to(x.dtype)
        x = torch.cat([cls, x], dim=1)
        for blk in self.blocks:
            x = blk(x, deterministic)
        return self.encoder_norm(x), mask, ids_restore

    def decode(self, latent, ids_restore, deterministic=True):
        x = self.decoder_embed(latent)
        b, l_keep1, d = x.shape
        l = ids_restore.shape[1]
        mask_tokens = self.mask_token.expand(b, l + 1 - l_keep1, d).to(x.dtype)
        x_ = perm_gather(torch.cat([x[:, 1:], mask_tokens], dim=1),
                         ids_restore)
        x = torch.cat([x[:, :1], x_], dim=1)
        x = x + _pos(d, int(math.isqrt(l)), x)
        for blk in self.decoder_blocks:
            x = blk(x, deterministic)
        return self.decoder_pred(self.decoder_norm(x))[:, 1:]  # drop cls

    def loss(self, imgs, pred, mask):
        target = patchify(imgs, self.patch_size)
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, correction=0)  # jnp.var
            target = (target - mean) / torch.sqrt(var + 1e-6)
        per_patch = torch.mean((pred - target) ** 2, dim=-1)
        return torch.sum(per_patch * mask) / torch.clamp(torch.sum(mask),
                                                         min=1.0)

    def forward(self, imgs, noise=None, mask_type="random", mask_ratio=0.75,
                mask_ratio_inner=0.75, deterministic=True):
        """Returns (loss, pred (B, L, p*p*C), mask (B, L))."""
        latent, mask, ids_restore = self.encode(
            imgs, noise, mask_type, mask_ratio, mask_ratio_inner,
            deterministic)
        pred = self.decode(latent, ids_restore, deterministic)
        return self.loss(imgs, pred, mask), pred, mask


MAE_CONFIGS = {
    "mae_vit_base_patch16": dict(embed_dim=768, depth=12, num_heads=12),
    "mae_vit_large_patch16": dict(embed_dim=1024, depth=24, num_heads=16),
    # HD 1280x1280 single-channel variant (the reference's mae.py, patch 64)
    "mae_vit_base_patch64_hd": dict(
        patch_size=64, in_chans=1, embed_dim=768, depth=12, num_heads=12
    ),
}


def build_mae(name: str, device=None, **overrides) -> MAE:
    cfg = dict(MAE_CONFIGS[name])
    cfg.update(overrides)
    return MAE(**cfg, device=device)
