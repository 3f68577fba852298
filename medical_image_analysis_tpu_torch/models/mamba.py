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
- ``"pallas"``: the JAX package's general selective-scan route
  (``mamba.py:163-227``): the K direction sequences, one ``causal_conv1d``
  over K x d_inner channels, the ``x_dbl`` and ``dt`` einsums in the
  input dtype (the ``ref`` path's precision, not the fused layer's fp32),
  then :func:`..ops.selective_scan_pallas.selective_scan_dirs`, whose
  wrappers launch the CUDA kernels on CUDA tensors and run their plain
  versions on CPU tensors;
- ``"pallas_plain"``: the ``"pallas"`` route through the scan's plain
  versions on any device (its comparison path on the card);
- ``"ref"``: per-direction ``causal_conv1d`` + ``selective_scan_ref``.

No preset picks ``"pallas"``; ``--set model.vision_kwargs={scan_backend:
pallas}`` does, as in the JAX package.

``MambaMixer.step`` and ``MambaBlock.step`` are the one-direction decode
step of ``models/mamba_lm.py`` (conv and SSM states), in plain PyTorch.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.causal_conv import causal_conv1d, causal_conv1d_update
from ..ops.mamba_fused import compute_dtype, mamba_fused_dirs
from ..ops.selective_scan import selective_scan_ref
from ..ops.selective_scan_pallas import selective_scan_dirs
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
SCAN_BACKENDS = ("auto", "plain", "pallas", "pallas_plain", "ref")


def _uniform(t: torch.Tensor, scale: float, gen: torch.Generator) -> None:
    tmp = torch.empty(t.shape, device=t.device)
    t.copy_(tmp.uniform_(-scale, scale, generator=gen))


@torch.no_grad()
def init_ssm_params(m: nn.Module, gen: torch.Generator) -> None:
    """The JAX package's initializers for a mixer's ``x_proj_w``,
    ``dt_proj_w``, ``dt_bias``, ``A_log`` and ``D`` (MambaMixer, SS2D)."""
    _uniform(m.x_proj_w, m.d_inner**-0.5, gen)
    _uniform(m.dt_proj_w, m.rank**-0.5, gen)
    dt_min, dt_max, floor = m.dt_range
    u = torch.empty(m.dt_bias.shape, device=m.dt_bias.device)
    u.uniform_(0.0, 1.0, generator=gen)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min))
                   + math.log(dt_min)).clamp_min(floor)
    # softplus^-1 so that softplus(bias) lands in [dt_min, dt_max]
    m.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
    a = torch.arange(1, m.n + 1, dtype=torch.float32, device=m.A_log.device)
    m.A_log.copy_(torch.log(a).expand_as(m.A_log))
    m.D.fill_(1.0)


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
        _uniform(self.conv_w, self.d_conv**-0.5, gen)
        if self.conv_b is not None:
            _uniform(self.conv_b, self.d_conv**-0.5, gen)
        init_ssm_params(self, gen)

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

    def _pallas_dirs(self, xi, a, cls_pos):
        """Every direction's y (B, K, L, d_inner) in source order, through
        one conv over all directions and ``selective_scan_dirs``."""
        k, rank, n = self.k, self.rank, self.n
        seqs = [xi]
        if k >= 2:
            seqs.append(xi.flip(1))
        if k == 4:
            xc = self._col_major(xi, cls_pos)
            seqs += [xc, xc.flip(1)]
        x_dirs = torch.stack(seqs, dim=1)  # (B, K, L, d_inner)
        b, _, l, d = x_dirs.shape
        # one causal conv over all directions: direction -> channels
        h = causal_conv1d(
            x_dirs.transpose(1, 2).reshape(b, l, k * d),
            self.conv_w.transpose(0, 1).reshape(self.d_conv, k * d),
            None if self.conv_b is None else self.conv_b.reshape(k * d),
            activation="silu",
        ).reshape(b, l, k, d).transpose(1, 2)
        x_dbl = torch.einsum("bkld,kcd->bklc", h, self.x_proj_w)
        dt = torch.einsum("bklr,kdr->bkld", x_dbl[..., :rank],
                          self.dt_proj_w)
        y = selective_scan_dirs(
            h, dt, a, x_dbl[..., rank : rank + n], x_dbl[..., rank + n :],
            self.D, self.dt_bias, delta_softplus=True,
            plain=self.scan_backend == "pallas_plain",
        )
        return torch.stack([y[:, i].flip(1) if i % 2 else y[:, i]
                            for i in range(k)], dim=1)

    def forward(self, x: torch.Tensor, cls_pos: int | None = None):
        xi, z = self.in_proj(x).chunk(2, dim=-1)
        a = -torch.exp(self.A_log.to(compute_dtype(self.A_log.dtype)))
        if self.scan_backend in ("pallas", "pallas_plain"):
            return self._merge(self._pallas_dirs(xi, a, cls_pos), z, cls_pos)
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

    def step(self, x_t: torch.Tensor, conv_state: torch.Tensor,
             ssm_state: torch.Tensor):
        """Single-token decode, one direction only: x_t (B, d_model),
        conv_state (B, d_conv-1, d_inner), ssm_state (B, d_inner, N) fp32
        -> (y_t, conv_state, ssm_state). The softplus, ``exp(dt A)`` and the
        state update run in fp32; ``y`` is cast back before ``silu(z)``.
        Plain PyTorch, as the JAX package computes the step outside any
        Pallas kernel."""
        assert self.k == 1, "decode step is 1-directional"
        rank, n = self.rank, self.n
        xi, z = self.in_proj(x_t).chunk(2, dim=-1)
        h, conv_state = causal_conv1d_update(
            xi, conv_state, self.conv_w[0],
            None if self.conv_b is None else self.conv_b[0], "silu")
        x_dbl = h @ self.x_proj_w[0].T
        dt = x_dbl[:, :rank] @ self.dt_proj_w[0].T
        bmat = x_dbl[:, rank : rank + n].float()
        cmat = x_dbl[:, rank + n :].float()
        dt = F.softplus(dt.float() + self.dt_bias[0][None, :])
        a = -torch.exp(self.A_log[0].float())  # (d_inner, N)
        da = torch.exp(dt[:, :, None] * a[None])
        hf = h.float()
        ssm_state = ssm_state * da + (dt * hf)[:, :, None] * bmat[:, None, :]
        y = (torch.einsum("bdn,bn->bd", ssm_state, cmat)
             + self.D[0][None, :] * hf)
        y = y.to(x_t.dtype) * F.silu(z)
        return self.out_proj(y), conv_state, ssm_state


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
        residual = (x.to(compute_dtype(x.dtype)) if self.residual_in_fp32
                    else x)
        y = self.mixer(self.norm(x), cls_pos)
        y = self.drop_path(y, deterministic)
        out = residual + y.to(residual.dtype)
        return out.to(x.dtype)

    def step(self, x_t, conv_state, ssm_state):
        """Single-token decode through the norm, the mixer's ``step`` and
        the residual."""
        residual = x_t.float() if self.residual_in_fp32 else x_t
        y, conv_state, ssm_state = self.mixer.step(self.norm(x_t), conv_state,
                                                   ssm_state)
        out = (residual + y.to(residual.dtype)).to(x_t.dtype)
        return out, conv_state, ssm_state


class ARM(nn.Module):
    """Vim-style flat Mamba vision encoder with a middle cls token.

    Takes (B, H, W, 3) channels-last images; returns the full token
    sequence (B, num_patches + 1, D) after the final LayerNorm (cls at
    ``num_patches // 2``). ``remat`` checkpoints each block under a
    gradient (flax ``nn.remat(MambaBlock)``): its activations are
    recomputed in the backward instead of kept.
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
        remat: bool = False,
        device=None,
    ):
        super().__init__()
        self.remat = remat
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
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, pos, deterministic,
                               use_reentrant=False)
            else:
                x = layer(x, pos, deterministic)
        return self.norm_f(x)


def arm_cls_index(num_patches: int) -> int:
    return num_patches // 2


def set_scan_backend(module: nn.Module, backend: str) -> None:
    """Set ``scan_backend`` on every mixer under ``module``: the ARM's
    ``MambaMixer`` and VMamba's ``SS2D``."""
    if backend not in SCAN_BACKENDS:
        raise ValueError(f"scan_backend {backend!r} not in {SCAN_BACKENDS}")
    for m in module.modules():
        if hasattr(m, "scan_backend"):
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
