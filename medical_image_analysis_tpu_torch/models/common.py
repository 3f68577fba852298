"""Shared model components (channels-last at the public boundary).

Counterpart of ``medical_image_analysis_tpu/models/common.py``, plus the
parameter initialisation that the flax modules get from their
initializers. Initial values follow the JAX package's distributions, not
its random bits: :func:`init_params` draws from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to +-2


def trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """Normal(0, std) truncated to +-2 std (flax ``truncated_normal``)."""
    with torch.no_grad():
        tmp = torch.empty(t.shape, device=t.device, dtype=torch.float32)
        nn.init.trunc_normal_(tmp, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=gen)
        t.copy_(tmp)
    return t


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax ``lecun_normal``: truncated normal with variance 1 / fan_in."""
    return trunc_normal_(t, math.sqrt(1.0 / fan_in) / _TRUNC_STD, gen)


@torch.no_grad()
def init_params(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Initialise every parameter of ``model`` from ``gen``.

    Linear and conv kernels get flax's ``lecun_normal`` and zero biases,
    norms ones and zeros, embeddings Normal(0, 1/sqrt(dim)); modules with
    parameters of their own define ``init_own_params(gen)``.
    """
    for m in model.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, gen)
        elif isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, nn.Embedding):
            tmp = torch.empty(m.weight.shape, device=m.weight.device)
            m.weight.copy_(tmp.normal_(0.0, m.weight.shape[1] ** -0.5,
                                       generator=gen))
        elif isinstance(m, (nn.LayerNorm, RMSNorm)):
            m.weight.fill_(1.0)
        if hasattr(m, "init_own_params"):
            m.init_own_params(gen)
        elif getattr(m, "bias", None) is not None and isinstance(
                m.bias, nn.Parameter):
            m.bias.zero_()
    return model


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: fp32 statistics, output promoted to fp32."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return xf * (torch.rsqrt(var + self.eps) * self.weight)


def layer_norm(dim: int, eps: float = 1e-6, device=None) -> nn.LayerNorm:
    """LayerNorm with flax's default eps (1e-6; torch's is 1e-5)."""
    return nn.LayerNorm(dim, eps=eps, device=device)


class PatchEmbed(nn.Module):
    """Image-to-patch embedding via a strided conv.

    (B, H, W, C) channels-last -> (B, H/p * W/p, dim), row-major tokens.
    The input is promoted to the kernel's dtype, as flax's ``nn.Conv``
    promotes it. ``proj.weight`` is OIHW (flax keeps HWIO).
    """

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 in_chans: int = 3, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.proj.weight.dtype).permute(0, 3, 1, 2)
        x = self.proj(x)  # (B, dim, h, w)
        return x.flatten(2).transpose(1, 2)

    def embed_flat(self, patches: torch.Tensor) -> torch.Tensor:
        """Embed already-patchified pixels (B, K, p*p*C), each patch in the
        conv's (p, p, C) order (``models.vit.patchify``): the conv as the
        product with its kernel flattened in that order (MAE's mask-first
        path embeds only the kept patches)."""
        w = self.proj.weight  # (dim, C, p, p)
        w = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        return F.linear(patches.to(w.dtype), w, self.proj.bias)


class DropPath(nn.Module):
    """Stochastic depth: drop the residual branch per sample."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, deterministic: bool = True):
        if self.rate == 0.0 or deterministic:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """Transformer MLP block: fc1, exact erf GELU, fc2 (flax ``Mlp`` with
    ``_gelu_exact``)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int | None = None,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.dropout = dropout
        self.fc1 = nn.Linear(in_dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, out_dim or in_dim, device=device)

    def forward(self, x, deterministic: bool = True):
        train = not deterministic
        x = F.dropout(F.gelu(self.fc1(x)), self.dropout, train)
        return F.dropout(self.fc2(x), self.dropout, train)


def insert_token(x: torch.Tensor, token: torch.Tensor, pos: int):
    """Insert a (B, 1, D) token at position ``pos`` of (B, L, D)."""
    return torch.cat([x[:, :pos], token, x[:, pos:]], dim=1)


def remove_token(x: torch.Tensor, pos: int):
    """Split out the token at ``pos``: returns (token (B,1,D), rest)."""
    tok = x[:, pos : pos + 1]
    rest = torch.cat([x[:, :pos], x[:, pos + 1 :]], dim=1)
    return tok, rest


def spatial_transpose_with_cls(x: torch.Tensor, pos: int) -> torch.Tensor:
    """Row-major -> column-major token order, keeping the cls token at
    ``pos`` fixed. Its own inverse. The non-cls length must be a square."""
    b, l, d = x.shape
    tok, rest = remove_token(x, pos)
    s = int(round((l - 1) ** 0.5))
    if s * s != l - 1:
        raise ValueError(f"sequence length {l - 1} is not a square")
    rest = rest.reshape(b, s, s, d).transpose(1, 2).reshape(b, l - 1, d)
    return insert_token(rest, tok, pos)
