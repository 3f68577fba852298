"""Swin Transformer backbone and the SwinCheX multi-head disease classifier.

Counterpart of ``medical_image_analysis_tpu/models/swin.py``
(``window_partition``, ``window_reverse``, ``_relative_position_index``,
``_shift_attn_mask``, ``WindowAttention``, ``SwinBlock``, ``PatchMerging``,
``SwinTransformer``, ``SwinCheX``, ``SWIN_CONFIGS``, ``build_swin``).
Inputs are channels-last (B, H, W, C); parameter names are the flax
modules' (``stage{s}_block{b}/attn/qkv``, ``norm1``, ``merge{s}``,
``head{i}_fc{j}``, ...), so ``ckpt.from_jax`` carries them across with its
Dense, Conv and LayerNorm rules; ``relative_position_bias_table`` keeps its
layout. Every LayerNorm here has eps 1e-5, and the MLP's GELU is the erf
one.

Which path the window-attention sub-layer takes (``SwinBlock``, as the
JAX package's ``swin.py:191-199``):

- the CUDA kernel (``ops.swin_block.swin_attn_fwd``; its plain version on
  a CPU tensor, or when ``plain``, set by ``models.common.set_fused``)
  when the block runs deterministic (eval mode, JAX's ``deterministic``)
  and no gradient is needed through the sub-layer: under
  ``torch.no_grad()``, or when neither its input nor the block's
  parameters require grad;
- the unfused route, ordinary PyTorch ops that autograd differentiates,
  whenever a gradient is needed. That is the route the JAX package trains
  through; it has no backward kernel for this sub-layer.

The choice reads the grad mode and ``deterministic``, never a failure. So a
training step of ``swinchex`` launches the kernel zero times, and a
validation batch of swin_large launches it 24 times (2 + 2 + 18 + 2 blocks).

A block derives its window, shift and shift mask from each input's (H, W),
as the JAX block does, so any map whose sides the window divides is taken,
square or not. ``img_size`` only sizes each stage's bias table (the window
of that stage's map at ``img_size``), as the JAX package sizes it from the
input it first sees.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.swin_block import swin_attn_block_plain, swin_attn_fwd
from ..ops.vit_block import _ln
from .common import DropPath, Mlp, trunc_normal_

EPS = 1e-5


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))  # (2, ws, ws)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, L, L)
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, L, L) additive mask for shifted-window attention: -100 where
    two tokens come from different shift regions."""
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    windows = img.reshape(1, h // ws, ws, w // ws, ws, 1)
    windows = windows.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Takes PRE-norm windows and the block's ``norm1`` and returns
    ``windows + attn_delta`` (residual included), so the kernel path and
    the unfused route are drop-in equals. LN commutes with the roll and the
    partition (both permute tokens), so normalising in the window layout is
    exact."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True, device=None):
        super().__init__()
        self.dim, self.num_heads, self.window_size = dim, num_heads, window_size
        self.plain = False
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * window_size - 1) ** 2, num_heads, device=device))
        self.register_buffer("rel_index", torch.from_numpy(
            _relative_position_index(window_size).reshape(-1)).to(device),
            persistent=False)

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        trunc_normal_(self.relative_position_bias_table, 0.02, gen)

    def rel_bias(self) -> torch.Tensor:
        """(heads, L, L) fp32: the bias table gathered by relative
        position."""
        l = self.window_size**2
        return (self.relative_position_bias_table[self.rel_index]
                .reshape(l, l, self.num_heads).permute(2, 0, 1).float())

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None,
                ln: nn.LayerNorm, fused: bool = False) -> torch.Tensor:
        bn, l, c = x.shape
        nh = self.num_heads
        hd = self.dim // nh
        bias = self.rel_bias()
        if fused:
            dt = x.dtype
            qkv_b = (self.qkv.bias if self.qkv.bias is not None
                     else torch.zeros(3 * self.dim, device=x.device))
            mask_arr = (mask.float().contiguous() if mask is not None
                        else torch.zeros(1, l, l, device=x.device))
            fn = swin_attn_block_plain if self.plain else swin_attn_fwd
            return fn(x.contiguous(), self.qkv.weight.t().to(dt).contiguous(),
                      qkv_b.to(dt).contiguous(),
                      self.proj.weight.t().to(dt).contiguous(),
                      self.proj.bias.to(dt).contiguous(),
                      ln.weight.to(dt).contiguous(),
                      ln.bias.to(dt).contiguous(), bias.contiguous(),
                      mask_arr, nh)

        h = _ln(x, ln.weight, ln.bias, EPS).to(x.dtype)
        qkv = h @ self.qkv.weight.t().to(h.dtype)
        if self.qkv.bias is not None:
            qkv = qkv + self.qkv.bias.to(h.dtype)
        q, k, v = qkv.reshape(bn, l, 3, nh, hd).permute(2, 0, 3, 1, 4)
        attn = torch.einsum("bhqd,bhkd->bhqk", q, k) * hd**-0.5
        attn = attn + bias[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bn // nw, nw, nh, l, l)
                    + mask[None, :, None]).reshape(bn, nh, l, l)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        out = out.transpose(1, 2).reshape(bn, l, c)
        return x + (out @ self.proj.weight.t().to(out.dtype)
                    + self.proj.bias.to(out.dtype)).to(x.dtype)


class SwinBlock(nn.Module):
    """Shifted-window attention and MLP sub-layers on a (B, H, W, C) map.

    Each call derives its window ``min(window_size, H, W)``, its shift (0
    when the window covers the map's shorter side) and the shift mask from
    the map it is given, as the JAX block does; the mask is built once per
    (H, W, device). ``resolution`` only sizes the relative-position bias
    table: the window of a ``resolution``-square map, as the JAX package
    sizes it from the first map it sees. A map whose window differs from
    the table's raises, as flax's parameter shape check does."""

    def __init__(self, dim: int, num_heads: int, resolution: int,
                 window_size: int = 7, shift: int = 0, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, device=None):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = nn.LayerNorm(dim, eps=EPS, device=device)
        self.attn = WindowAttention(dim, num_heads,
                                    min(window_size, resolution),
                                    device=device)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=EPS, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)
        self.drop_path2 = DropPath(drop_path)
        self._masks: dict[tuple, torch.Tensor] = {}

    def _window(self, h: int, w: int, device) -> tuple:
        """(window, shift, mask or None) of an (h, w) map."""
        ws = min(self.window_size, h, w)
        if ws != self.attn.window_size:
            raise ValueError(
                f"SwinBlock: a {h}x{w} map takes window {ws}; the bias table "
                f"was sized for window {self.attn.window_size}")
        shift = self.shift if ws < min(h, w) else 0
        if shift == 0:
            return ws, 0, None
        key = (h, w, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                _shift_attn_mask(h, w, ws, shift)).to(device)
        return ws, shift, self._masks[key]

    def _needs_grad(self, x: torch.Tensor) -> bool:
        if not torch.is_grad_enabled():
            return False
        return x.requires_grad or any(
            p.requires_grad for m in (self.norm1, self.attn)
            for p in m.parameters())

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        b, h, w, c = x.shape
        ws, shift, mask = self._window(h, w, x.device)
        fused = deterministic and not self._needs_grad(x)
        y = torch.roll(x, (-shift, -shift), (1, 2)) if shift > 0 else x
        wout = self.attn(window_partition(y, ws), mask, self.norm1, fused)
        y = window_reverse(wout, ws, h, w)
        if shift > 0:
            y = torch.roll(y, (shift, shift), (1, 2))
        # wout included the residual in window layout; recover the delta so
        # that DropPath scales only the branch.
        x = x + self.drop_path1(y - x, deterministic)
        y = self.mlp(self.norm2(x), deterministic)
        return x + self.drop_path2(y, deterministic)


class PatchMerging(nn.Module):
    """2x2 patch merging: concat 4 neighbours -> LN -> Linear(2C), no bias."""

    def __init__(self, dim: int, out_dim: int, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=EPS, device=device)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


class SwinTransformer(nn.Module):
    """Swin backbone; returns the final token sequence (B, L, C_last)."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.1, patch_norm: bool = True,
                 img_size: int = 224, device=None):
        super().__init__()
        p = patch_size
        self.depths = tuple(depths)
        self.patch_embed = nn.Conv2d(3, embed_dim, p, stride=p, device=device)
        self.patch_embed_norm = (nn.LayerNorm(embed_dim, eps=EPS,
                                              device=device)
                                 if patch_norm else None)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        res, idx = img_size // p, 0
        self.stages: list[list[SwinBlock]] = []
        for stage, depth in enumerate(depths):
            dim = embed_dim * 2**stage
            blocks = []
            for blk in range(depth):
                blocks.append(SwinBlock(
                    dim, num_heads[stage], res, window_size,
                    shift=0 if blk % 2 == 0 else window_size // 2,
                    mlp_ratio=mlp_ratio, drop_path=dpr[idx], device=device))
                self.add_module(f"stage{stage}_block{blk}", blocks[-1])
                idx += 1
            self.stages.append(blocks)
            if stage < len(depths) - 1:
                self.add_module(f"merge{stage}",
                                PatchMerging(dim, 2 * dim, device=device))
                res //= 2
        self.out_dim = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(self.out_dim, eps=EPS, device=device)

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        w = self.patch_embed.weight
        x = self.patch_embed(x.to(w.dtype).permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1)
        if self.patch_embed_norm is not None:
            x = self.patch_embed_norm(x)
        for stage, blocks in enumerate(self.stages):
            for blk in blocks:
                x = blk(x, deterministic)
            if stage < len(self.stages) - 1:
                x = getattr(self, f"merge{stage}")(x)
        b, h, w_, c = x.shape
        return self.norm(x.reshape(b, h * w_, c))


class SwinCheX(nn.Module):
    """Swin classifier with per-disease MLP head stacks: each of
    ``num_classes`` diseases gets a [C -> 384 -> 48 (-> 48) -> 2] ReLU MLP
    over the token average, giving 2-way logits (B, num_classes, 2)."""

    _HEAD_DIMS = {0: (), 1: (48,), 2: (384, 48), 3: (384, 48, 48)}

    def __init__(self, backbone: SwinTransformer, num_classes: int = 14,
                 num_mlp_heads: int = 3, device=None):
        super().__init__()
        self.backbone = backbone
        self.heads: list[list[nn.Linear]] = []
        for i in range(num_classes):
            stack, d = [], backbone.out_dim
            for j, hd in enumerate(self._HEAD_DIMS[num_mlp_heads]):
                stack.append(nn.Linear(d, hd, device=device))
                self.add_module(f"head{i}_fc{j}", stack[-1])
                d = hd
            stack.append(nn.Linear(d, 2, device=device))
            self.add_module(f"head{i}_out", stack[-1])
            self.heads.append(stack)

    def tokens(self, x: torch.Tensor, deterministic: bool = True):
        """Final-stage token features (the GradCAM target layer)."""
        return self.backbone(x, deterministic)

    def logits_from_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        feat = tokens.mean(dim=1)  # avgpool over tokens
        logits = []
        for stack in self.heads:
            h = feat
            for layer in stack[:-1]:
                h = torch.relu(layer(h))
            logits.append(stack[-1](h))
        return torch.stack(logits, dim=1)

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        return self.logits_from_tokens(self.tokens(x, deterministic))


SWIN_CONFIGS = {
    "swin_tiny": dict(embed_dim=96, depths=(2, 2, 6, 2),
                      num_heads=(3, 6, 12, 24)),
    "swin_base": dict(embed_dim=128, depths=(2, 2, 18, 2),
                      num_heads=(4, 8, 16, 32)),
    "swin_large": dict(embed_dim=192, depths=(2, 2, 18, 2),
                       num_heads=(6, 12, 24, 48)),
}


def build_swin(name: str, device=None, **overrides) -> SwinTransformer:
    cfg = dict(SWIN_CONFIGS[name])
    cfg.update(overrides)
    return SwinTransformer(**cfg, device=device)
