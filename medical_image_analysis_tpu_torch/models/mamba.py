"""Mamba mixer, block, and the ARM vision backbone in PyTorch.

Counterpart of ``medical_image_analysis_tpu/models/mamba.py``. Parameter
names and layouts follow the flax modules (``conv_w (K, d_conv, d_inner)``,
``x_proj_w (K, R+2N, d_inner)``, ``dt_proj_w (K, d_inner, R)``, ``A_log``,
``D``), so :mod:`..ckpt.from_jax` maps one onto the other by name.

``scan_backend`` selects the mixer's inner path:

- ``"auto"``: :func:`..ops.mamba_fused.mamba_fused_dirs`, whose wrappers
  launch the CUDA kernels on CUDA tensors and run their plain versions
  on CPU tensors;
- ``"plain"``: the same fused semantics through the plain versions on
  any device (the comparison path on the card);
- ``"ref"``: per-direction ``causal_conv1d`` + ``selective_scan_ref``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.causal_conv import causal_conv1d
from ..ops.mamba_fused import mamba_fused_dirs
from ..ops.selective_scan import selective_scan_ref
from .common import (
    DropPath,
    PatchEmbed,
    RMSNorm,
    insert_token,
    layer_norm,
    spatial_transpose_with_cls,
    trunc_normal_,
)

_NUM_DIRS = {"none": 1, "v2": 2, "v3": 4}
SCAN_BACKENDS = ("auto", "plain", "ref")


class MambaMixer(nn.Module):
    """Selective-state-space mixer with 1/2/4-directional scans."""

    def __init__(
        self,
        d_model: int,
        d_state: int = 16,
        d_conv: int = 4,
        expand: int = 2,
        dt_rank: int = 0,  # 0 = ceil(d_model / 16)
        bimamba_type: str = "none",  # none | v2 | v3
        if_devide_out: bool = False,
        dt_min: float = 1e-3,
        dt_max: float = 0.1,
        dt_init_floor: float = 1e-4,
        conv_bias: bool = True,
        proj_bias: bool = False,
        scan_backend: str = "auto",
        device=None,
    ):
        super().__init__()
        if scan_backend not in SCAN_BACKENDS:
            raise ValueError(f"scan_backend {scan_backend!r} not in {SCAN_BACKENDS}")
        d_inner = expand * d_model
        rank = dt_rank or math.ceil(d_model / 16)
        k = _NUM_DIRS[bimamba_type]
        self.d_inner, self.rank, self.n, self.k = d_inner, rank, d_state, k
        self.d_conv = d_conv
        self.if_devide_out = if_devide_out
        self.dt_range = (dt_min, dt_max, dt_init_floor)
        self.scan_backend = scan_backend
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=proj_bias,
                                 device=device)
        self.out_proj = nn.Linear(d_inner, d_model, bias=proj_bias,
                                  device=device)

        def p(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.conv_w = p(k, d_conv, d_inner)
        self.conv_b = p(k, d_inner) if conv_bias else None
        self.x_proj_w = p(k, rank + 2 * d_state, d_inner)
        self.dt_proj_w = p(k, d_inner, rank)
        self.dt_bias = p(k, d_inner)
        self.A_log = p(k, d_inner, d_state)
        self.D = p(k, d_inner)

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        def uniform(t, scale):
            tmp = torch.empty(t.shape, device=t.device)
            t.copy_(tmp.uniform_(-scale, scale, generator=gen))

        uniform(self.conv_w, self.d_conv**-0.5)
        if self.conv_b is not None:
            uniform(self.conv_b, self.d_conv**-0.5)
        uniform(self.x_proj_w, self.d_inner**-0.5)
        uniform(self.dt_proj_w, self.rank**-0.5)
        dt_min, dt_max, floor = self.dt_range
        u = torch.empty(self.dt_bias.shape, device=self.dt_bias.device)
        u.uniform_(0.0, 1.0, generator=gen)
        dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min))
                       + math.log(dt_min)).clamp_min(floor)
        # softplus^-1 so that softplus(bias) lands in [dt_min, dt_max]
        self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        a = torch.arange(1, self.n + 1, dtype=torch.float32,
                         device=self.A_log.device)
        self.A_log.copy_(torch.log(a).expand_as(self.A_log))
        self.D.fill_(1.0)

    def _col_major(self, t, cls_pos):
        """Row-major tokens -> column-major (with middle-cls splicing)."""
        b, l, d = t.shape
        if cls_pos is not None:
            return spatial_transpose_with_cls(t, cls_pos)
        s = int(round(l**0.5))
        if s * s != l:
            raise ValueError("v3 column scan needs a square token grid")
        return t.reshape(b, s, s, d).transpose(1, 2).reshape(b, l, d)

    def _merge(self, y_dirs, z, cls_pos):
        """y_dirs (B, K, L, D) in source order -> gated, projected output."""
        y = y_dirs[:, 0]
        if self.k >= 2:
            y = y + y_dirs[:, 1]
        if self.k == 4:
            y = y + self._col_major(y_dirs[:, 2] + y_dirs[:, 3], cls_pos)
        y = y * F.silu(z)
        if self.if_devide_out and self.k > 1:
            y = y / self.k
        return self.out_proj(y)

    def forward(self, x: torch.Tensor, cls_pos: int | None = None):
        xi, z = self.in_proj(x).chunk(2, dim=-1)
        a = -torch.exp(self.A_log.float())
        if self.scan_backend != "ref":
            xc = self._col_major(xi, cls_pos) if self.k == 4 else None
            y_dirs = mamba_fused_dirs(
                xi, xc, self.conv_w, self.conv_b, self.x_proj_w,
                self.dt_proj_w, self.dt_bias, a, self.D,
                delta_softplus=True, plain=self.scan_backend == "plain",
            )
            return self._merge(y_dirs, z, cls_pos)

        seqs = [xi]
        if self.k >= 2:
            seqs.append(xi.flip(1))
        if self.k == 4:
            xc = self._col_major(xi, cls_pos)
            seqs += [xc, xc.flip(1)]
        rank, n = self.rank, self.n
        ys = []
        for i, s in enumerate(seqs):
            cb = None if self.conv_b is None else self.conv_b[i]
            h = causal_conv1d(s, self.conv_w[i], cb, activation="silu")
            x_dbl = torch.einsum("bld,cd->blc", h, self.x_proj_w[i])
            dt = torch.einsum("blr,dr->bld", x_dbl[..., :rank],
                              self.dt_proj_w[i])
            y = selective_scan_ref(
                h, dt, a[i], x_dbl[..., rank : rank + n],
                x_dbl[..., rank + n :], self.D[i], self.dt_bias[i],
                delta_softplus=True,
            )
            ys.append(y.flip(1) if i % 2 else y)  # back to source order
        return self._merge(torch.stack(ys, dim=1), z, cls_pos)


class MambaBlock(nn.Module):
    """Pre-norm residual Mamba block with an fp32 residual."""

    def __init__(
        self,
        d_model: int,
        d_state: int = 16,
        expand: int = 2,
        bimamba_type: str = "none",
        if_devide_out: bool = False,
        rms_norm: bool = True,
        norm_eps: float = 1e-5,
        residual_in_fp32: bool = True,
        drop_path: float = 0.0,
        scan_backend: str = "auto",
        device=None,
    ):
        super().__init__()
        self.residual_in_fp32 = residual_in_fp32
        self.norm = (
            RMSNorm(d_model, norm_eps, device=device) if rms_norm
            else layer_norm(d_model, norm_eps, device=device)
        )
        self.mixer = MambaMixer(
            d_model, d_state=d_state, expand=expand,
            bimamba_type=bimamba_type, if_devide_out=if_devide_out,
            scan_backend=scan_backend, device=device,
        )
        self.drop_path = DropPath(drop_path)

    def forward(self, x, cls_pos: int | None = None,
                deterministic: bool = True):
        residual = x.float() if self.residual_in_fp32 else x
        y = self.mixer(self.norm(x), cls_pos)
        y = self.drop_path(y, deterministic)
        out = residual + y.to(residual.dtype)
        return out.to(x.dtype)


class ARM(nn.Module):
    """Vim-style flat Mamba vision encoder with a middle cls token.

    Takes (B, H, W, 3) channels-last images; returns the full token
    sequence (B, num_patches + 1, D) after the final LayerNorm (cls at
    ``num_patches // 2``).
    """

    def __init__(
        self,
        patch_size: int = 16,
        embed_dim: int = 768,
        depth: int = 12,
        d_state: int = 16,
        expand: int = 1,  # the reference ARM hardcodes expand=1
        bimamba_type: str = "v3",
        if_devide_out: bool = True,
        rms_norm: bool = True,
        drop_path_rate: float = 0.1,
        scan_backend: str = "auto",
        img_size: int = 224,
        device=None,
    ):
        super().__init__()
        num_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim,
                                                  device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, num_patches + 1, embed_dim, device=device)
        )
        dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.layers = nn.ModuleList(
            MambaBlock(
                embed_dim, d_state=d_state, expand=expand,
                bimamba_type=bimamba_type, if_devide_out=if_devide_out,
                rms_norm=rms_norm, drop_path=dpr[i],
                scan_backend=scan_backend, device=device,
            )
            for i in range(depth)
        )
        self.norm_f = layer_norm(embed_dim, device=device)

    def init_own_params(self, gen: torch.Generator):
        trunc_normal_(self.cls_token, 0.02, gen)
        trunc_normal_(self.pos_embed, 0.02, gen)

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        x = self.patch_embed(x)
        b, m, d = x.shape
        if self.pos_embed.shape[1] != m + 1:
            raise ValueError(f"{m} patches; pos_embed holds "
                             f"{self.pos_embed.shape[1] - 1}")
        pos = m // 2
        cls = self.cls_token.expand(b, 1, d).to(x.dtype)
        x = insert_token(x, cls, pos)
        x = x + self.pos_embed.to(x.dtype)
        for layer in self.layers:
            x = layer(x, pos, deterministic)
        return self.norm_f(x)


def arm_cls_index(num_patches: int) -> int:
    return num_patches // 2


def set_scan_backend(module: nn.Module, backend: str) -> None:
    """Set ``scan_backend`` on every MambaMixer under ``module``."""
    if backend not in SCAN_BACKENDS:
        raise ValueError(f"scan_backend {backend!r} not in {SCAN_BACKENDS}")
    for m in module.modules():
        if isinstance(m, MambaMixer):
            m.scan_backend = backend


ARM_CONFIGS = {
    "arm_base_pz16": dict(patch_size=16, embed_dim=768, depth=12),
    "arm_large_pz16": dict(patch_size=16, embed_dim=1024, depth=24),
    "arm_huge_pz16": dict(patch_size=16, embed_dim=1536, depth=24),
}


def build_arm(name: str, **overrides) -> ARM:
    cfg = dict(ARM_CONFIGS[name])
    cfg.update(overrides)
    return ARM(**cfg)
