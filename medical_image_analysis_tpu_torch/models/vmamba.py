"""VMamba in PyTorch: the SS2D mixer, VSSBlock and the four-stage VSSM.

Counterpart of ``medical_image_analysis_tpu/models/vmamba.py``, with the
flax modules' parameter names and layouts (``in_proj``, ``conv2d``,
``x_proj_w (4, R+2N, d_inner)``, ``dt_proj_w (4, d_inner, R)``,
``dt_bias``, ``A_log``, ``D``, ``out_norm``, ``out_proj``; blocks
``stage<s>_block<b>``, ``downsample<s>``), so :mod:`..ckpt.from_jax`
maps one onto the other by name. Channels-last at the public boundary.
Every LayerNorm has flax's eps, 1e-6.

``SS2D.scan_backend`` selects the inner path, as in the JAX package:

- ``"auto"``: d_state=1 through :func:`..ops.scan_n1.scan_n1_sources`,
  d_state>1 through :func:`..ops.mamba_fused.mamba_fused_dirs` without a
  conv; the wrappers launch the CUDA kernels on CUDA tensors and run
  their plain versions on CPU tensors;
- ``"plain"``: the same through the plain versions on any device (the
  comparison path on the card);
- ``"pallas"``: ``cross_scan``, the ``x_dbl`` and ``dt`` einsums, then
  :func:`..ops.selective_scan_pallas.selective_scan_dirs` (the general
  selective-scan kernels at any d_state, JAX ``vmamba.py:145-166``) and
  ``cross_merge``; ``"pallas_plain"`` the same through the scan's plain
  versions on any device (its comparison path on the card);
- ``"ref"``: ``cross_scan`` + per-direction ``selective_scan_ref``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cross_scan import cross_merge, cross_scan
from ..ops.mamba_fused import mamba_fused_dirs
from ..ops.scan_n1 import scan_n1_sources
from ..ops.selective_scan import selective_scan_ref
from ..ops.selective_scan_pallas import selective_scan_dirs
from .common import DropPath, Mlp, layer_norm
from .mamba import SCAN_BACKENDS, init_ssm_params


def _check_backend(backend: str) -> None:
    if backend not in SCAN_BACKENDS:
        raise ValueError(f"scan_backend {backend!r} not in {SCAN_BACKENDS}")


class SS2D(nn.Module):
    """2D selective-scan mixer (forward_type v2/v3; ``disable_z``: noz)."""

    def __init__(
        self,
        d_model: int,
        d_state: int = 16,
        ssm_ratio: float = 2.0,
        dt_rank: int = 0,  # 0 = ceil(d_model / 16)
        d_conv: int = 3,
        conv_bias: bool = True,
        proj_bias: bool = False,
        dropout: float = 0.0,
        dt_min: float = 1e-3,
        dt_max: float = 0.1,
        dt_init_floor: float = 1e-4,
        disable_z: bool = False,
        scan_backend: str = "auto",
        device=None,
    ):
        super().__init__()
        _check_backend(scan_backend)
        d_inner = int(ssm_ratio * d_model)
        rank = dt_rank or math.ceil(d_model / 16)
        self.d_inner, self.rank, self.n = d_inner, rank, d_state
        self.dropout = dropout
        self.disable_z = disable_z
        self.scan_backend = scan_backend
        self.dt_range = (dt_min, dt_max, dt_init_floor)
        self.in_proj = nn.Linear(d_model, d_inner * (1 if disable_z else 2),
                                 bias=proj_bias, device=device)
        self.conv2d = (
            nn.Conv2d(d_inner, d_inner, d_conv, padding="same",
                      groups=d_inner, bias=conv_bias, device=device)
            if d_conv > 1 else None
        )

        def p(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.x_proj_w = p(4, rank + 2 * d_state, d_inner)
        self.dt_proj_w = p(4, d_inner, rank)
        self.dt_bias = p(4, d_inner)
        self.A_log = p(4, d_inner, d_state)
        self.D = p(4, d_inner)
        self.out_norm = layer_norm(d_inner, device=device)
        self.out_proj = nn.Linear(d_inner, d_model, bias=proj_bias,
                                  device=device)

    def init_own_params(self, gen: torch.Generator):
        init_ssm_params(self, gen)

    def _scan(self, xi, a):
        """(B, H, W, d_inner) -> merged y (B, H*W, d_inner)."""
        b, h, w, d = xi.shape
        backend = self.scan_backend
        if backend in ("ref", "pallas", "pallas_plain"):
            xs = cross_scan(xi)
            x_dbl = torch.einsum("bkld,kcd->bklc", xs, self.x_proj_w)
            rank, n = self.rank, self.n
            dt = torch.einsum("bklr,kdr->bkld", x_dbl[..., :rank],
                              self.dt_proj_w)
            bmat, cmat = x_dbl[..., rank : rank + n], x_dbl[..., rank + n :]
            if backend == "ref":
                y_dirs = torch.stack([
                    selective_scan_ref(
                        xs[:, i], dt[:, i], a[i], bmat[:, i], cmat[:, i],
                        self.D[i], self.dt_bias[i], delta_softplus=True,
                    )
                    for i in range(4)
                ], dim=1)
            else:
                y_dirs = selective_scan_dirs(
                    xs, dt, a, bmat, cmat, self.D, self.dt_bias,
                    delta_softplus=True, plain=backend == "pallas_plain")
            return cross_merge(y_dirs, h, w)
        xr = xi.reshape(b, h * w, d)
        xc = xi.transpose(1, 2).reshape(b, h * w, d)
        plain = backend == "plain"
        if self.n == 1:
            # parameters in reference order [row, col, row-rev, col-rev]
            y_row, y_col = scan_n1_sources(
                xr, xc, self.x_proj_w, self.dt_proj_w, self.dt_bias, a,
                self.D, plain=plain,
            )
        else:
            # the fused layer's directions are [row, row-rev, col, col-rev]
            perm = [0, 2, 1, 3]
            y_f = mamba_fused_dirs(
                xr, xc, None, None, self.x_proj_w[perm],
                self.dt_proj_w[perm], self.dt_bias[perm], a[perm],
                self.D[perm], delta_softplus=True, plain=plain,
            )
            y_row, y_col = y_f[:, 0] + y_f[:, 1], y_f[:, 2] + y_f[:, 3]
        # the column source's output back to row-major
        y_col = y_col.reshape(b, w, h, d).transpose(1, 2).reshape(b, h * w, d)
        return y_row + y_col

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        b, h, w, _ = x.shape
        if self.disable_z:
            xi, z = self.in_proj(x), None
        else:
            xi, z = self.in_proj(x).chunk(2, dim=-1)
            z = F.silu(z)
        if self.conv2d is not None:
            xi = self.conv2d(xi.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        xi = F.silu(xi)
        a = -torch.exp(self.A_log.float())
        y = self.out_norm(self._scan(xi, a)).reshape(b, h, w, self.d_inner)
        if z is not None:
            y = y * z
        return F.dropout(self.out_proj(y), self.dropout, not deterministic)


class VSSBlock(nn.Module):
    """SS2D and an MLP, both pre-norm residual."""

    def __init__(
        self,
        dim: int,
        d_state: int = 16,
        ssm_ratio: float = 2.0,
        ssm_conv: int = 3,
        conv_bias: bool = True,
        disable_z: bool = False,
        mlp_ratio: float = 4.0,
        drop_path: float = 0.0,
        scan_backend: str = "auto",
        device=None,
    ):
        super().__init__()
        self.norm = self.op = self.norm2 = self.mlp = None
        if ssm_ratio > 0:
            self.norm = layer_norm(dim, device=device)
            self.op = SS2D(dim, d_state=d_state, ssm_ratio=ssm_ratio,
                           d_conv=ssm_conv, conv_bias=conv_bias,
                           disable_z=disable_z, scan_backend=scan_backend,
                           device=device)
        if mlp_ratio > 0:
            self.norm2 = layer_norm(dim, device=device)
            self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        if self.op is not None:
            x = x + self.drop_path(self.op(self.norm(x), deterministic),
                                   deterministic)
        if self.mlp is not None:
            x = x + self.drop_path(self.mlp(self.norm2(x), deterministic),
                                   deterministic)
        return x


def _conv(c_in, c_out, k, stride, padding, device):
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=padding,
                     device=device)


class VSSM(nn.Module):
    """Hierarchical four-stage VMamba backbone.

    (B, H, W, 3) -> pooled (B, C_last) if ``pool`` else the last stage's
    feature map (B, H/32, W/32, C_last).
    """

    def __init__(
        self,
        depths: Sequence[int] = (2, 2, 5, 2),
        dims: Sequence[int] = (96, 192, 384, 768),
        patch_size: int = 4,
        d_state: int = 16,
        ssm_ratio: float = 2.0,
        conv_bias: bool = True,
        disable_z: bool = False,
        mlp_ratio: float = 4.0,
        drop_path_rate: float = 0.1,
        patch_norm: bool = True,
        patch_embed_version: str = "v1",
        scan_backend: str = "auto",
        device=None,
    ):
        super().__init__()
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.patch_embed_version = patch_embed_version
        norm = (lambda c: layer_norm(c, device=device)) if patch_norm else (
            lambda c: nn.Identity())
        if patch_embed_version == "v2":
            # two 3x3/s2 convs with LN + exact GELU between, LN after
            if patch_size != 4:
                raise ValueError("patch_embed_version v2 needs patch_size 4")
            self.patch_embed = _conv(3, dims[0] // 2, 3, 2, 1, device)
            self.patch_norm = norm(dims[0] // 2)
            self.patch_embed2 = _conv(dims[0] // 2, dims[0], 3, 2, 1, device)
            self.patch_norm2 = norm(dims[0])
        else:
            self.patch_embed = _conv(3, dims[0], patch_size, patch_size, 0,
                                     device)
            self.patch_norm = norm(dims[0])
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        idx = 0
        for stage, depth in enumerate(depths):
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}", VSSBlock(
                    dims[stage], d_state=d_state, ssm_ratio=ssm_ratio,
                    conv_bias=conv_bias, disable_z=disable_z,
                    mlp_ratio=mlp_ratio, drop_path=dpr[idx],
                    scan_backend=scan_backend, device=device,
                ))
                idx += 1
            if stage < len(depths) - 1:
                # 3x3 stride-2 conv with explicit (1, 1) padding + LN
                self.add_module(f"downsample{stage}", _conv(
                    dims[stage], dims[stage + 1], 3, 2, 1, device))
                self.add_module(f"downsample_norm{stage}",
                                layer_norm(dims[stage + 1], device=device))
        self.norm = layer_norm(dims[-1], device=device)

    @staticmethod
    def _nhwc_conv(conv, x):
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, pool: bool = True,
                deterministic: bool = True):
        x = x.to(self.patch_embed.weight.dtype)
        x = self.patch_norm(self._nhwc_conv(self.patch_embed, x))
        if self.patch_embed_version == "v2":
            x = F.gelu(x)
            x = self.patch_norm2(self._nhwc_conv(self.patch_embed2, x))
        for stage, depth in enumerate(self.depths):
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x, deterministic)
            if stage < len(self.depths) - 1:
                x = self._nhwc_conv(getattr(self, f"downsample{stage}"), x)
                x = getattr(self, f"downsample_norm{stage}")(x)
        x = self.norm(x)
        return x.mean(dim=(1, 2)) if pool else x


_V1 = dict(d_state=1, disable_z=True, conv_bias=False,
           patch_embed_version="v2")
VSSM_CONFIGS = {
    "vssm_tiny": dict(depths=(2, 2, 5, 2), dims=(96, 192, 384, 768)),
    "vssm_small": dict(depths=(2, 2, 15, 2), dims=(96, 192, 384, 768)),
    "vssm_base": dict(depths=(2, 2, 15, 2), dims=(128, 256, 512, 1024)),
    # the d_state=1 "nightly" family; vssm1_base is the tower R2GenCSR loads
    "vssm1_tiny": dict(depths=(2, 2, 4, 2), dims=(96, 192, 384, 768), **_V1),
    "vssm1_small": dict(depths=(2, 2, 15, 2), dims=(96, 192, 384, 768),
                        **_V1),
    "vssm1_base": dict(depths=(2, 2, 15, 2), dims=(128, 256, 512, 1024),
                       **_V1),
}


def build_vssm(name: str, **overrides) -> VSSM:
    cfg = dict(VSSM_CONFIGS[name])
    cfg.update(overrides)
    return VSSM(**cfg)
