"""R2GenKG's graph heads: the R-GCN knowledge-graph encoder, the multi-scale
fusion, the residual cross-attention blocks and the disease-bank lookup.

Counterpart of ``medical_image_analysis_tpu/models/rgcn.py``
(``rgcn_conv``, ``RGCN``, ``MultiScaleSelfAttentionFusion``,
``ResidualCrossAttentionBlock``, ``CrossAttentionLookup``), with its
parameter names. Graphs have static padded shapes: node row N of (N+1,
D) is a dummy row, and pad edges point at it.

- ``rgcn_conv`` gathers and scatters through one-hot matrices of the
  edges' sources and destinations, products whose sums run in a fixed
  order: the result and its gradient are the same bits in every run on
  the card (``index_add_`` adds by atomics in no fixed order). The graphs
  are small (at most 64 edges over at most 41 nodes a scale).
- The fusion's ``attn<i>`` is flax's ``nn.SelfAttention``: ``query``,
  ``key`` and ``value`` ``DenseGeneral`` kernels (D, H, hd) and ``out``
  (H, hd, D), held here as ``nn.Linear`` (``ckpt/from_jax.py`` reshapes
  them); the query is divided by sqrt(hd) before the scores, as flax does.
  Its LayerNorms take flax's eps (1e-6) and its MLP the tanh GELU.
- The cross blocks' ``ln_1`` and ``ln_2`` have no bias, one ``ln_1``
  normalises both the query and the context, and their MLP takes the erf
  GELU.
- A two-dimensional bank (the disease bank) is shared by the batch: its
  key and value projections are computed once.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import layer_norm, lecun_normal_, trunc_normal_


def rgcn_conv(h: torch.Tensor, edge_index: torch.Tensor,
              edge_type: torch.Tensor, w_rel: torch.Tensor,
              w_self: torch.Tensor) -> torch.Tensor:
    """One R-GCN layer, ``h'_i = W0 h_i + sum_r (1/c_{i,r}) sum_j W_r h_j``:
    h (N+1, D_in), edge_index (2, E) [src, dst], edge_type (E,) in [0, R),
    w_rel (R, D_in, D_out), w_self (D_in, D_out)."""
    n, r = h.shape[0], w_rel.shape[0]
    src = F.one_hot(edge_index[0].long(), n).to(h.dtype)  # (E, N+1)
    dst = F.one_hot(edge_index[1].long(), n).to(h.dtype)
    rel = F.one_hot(edge_type.long(), r).to(h.dtype)  # (E, R)
    msgs = torch.einsum("ed,rdo->ero", src @ h, w_rel) * rel[..., None]
    agg = torch.einsum("en,ero->nro", dst, msgs)
    count = dst.t() @ rel  # (N+1, R)
    agg = agg / count.clamp_min(1.0)[..., None]
    return h @ w_self + agg.sum(dim=1)


class RGCN(nn.Module):
    """Two R-GCN layers with a ReLU between them; ``w1_rel`` (R, in_dim,
    hidden), ``w1_self`` (in_dim, hidden), ``w2_rel``, ``w2_self`` raw
    parameters in that layout (flax ``lecun_normal``)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_relations: int = 3, device=None):
        super().__init__()
        r = num_relations

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.w1_rel = param(r, in_dim, hidden)
        self.w1_self = param(in_dim, hidden)
        self.w2_rel = param(r, hidden, out_dim)
        self.w2_self = param(hidden, out_dim)

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        # flax's fan-in of a (R, in, out) kernel counts R as receptive field
        for w in (self.w1_rel, self.w1_self, self.w2_rel, self.w2_self):
            lecun_normal_(w, math.prod(w.shape[:-1]), gen)

    def forward(self, x, edge_index, edge_type):
        h = torch.relu(rgcn_conv(x, edge_index, edge_type, self.w1_rel,
                                 self.w1_self))
        return rgcn_conv(h, edge_index, edge_type, self.w2_rel, self.w2_self)


class SelfAttention(nn.Module):
    """flax ``nn.SelfAttention`` (no mask, no dropout): ``query``, ``key``,
    ``value`` and ``out`` projections of width ``dim``."""

    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim, device=device)
        self.key = nn.Linear(dim, dim, device=device)
        self.value = nn.Linear(dim, dim, device=device)
        self.out = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        nh = self.num_heads
        hd = d // nh
        q = self.query(x).reshape(b, l, nh, hd) / math.sqrt(hd)
        k = self.key(x).reshape(b, l, nh, hd)
        v = self.value(x).reshape(b, l, nh, hd)
        a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, l, d)
        return self.out(o)


class MultiScaleSelfAttentionFusion(nn.Module):
    """Scale and position embeddings on each scale's nodes, the scales
    concatenated, then ``num_layers`` pre-LN transformer layers."""

    def __init__(self, dim: int, num_scales: int = 5, num_heads: int = 8,
                 num_layers: int = 2, max_nodes: int = 256, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.scale_embed = nn.Parameter(torch.empty(num_scales, dim,
                                                    device=device))
        self.pos_embed = nn.Parameter(torch.empty(max_nodes, dim,
                                                  device=device))
        for i in range(num_layers):
            self.add_module(f"attn{i}", SelfAttention(dim, num_heads, device))
            self.add_module(f"ln{i}", layer_norm(dim, device=device))
            self.add_module(f"ffn{i}_in", nn.Linear(dim, 4 * dim,
                                                    device=device))
            self.add_module(f"ffn{i}_out", nn.Linear(4 * dim, dim,
                                                     device=device))
            self.add_module(f"ln{i}b", layer_norm(dim, device=device))

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        trunc_normal_(self.scale_embed, 0.02, gen)
        trunc_normal_(self.pos_embed, 0.02, gen)

    def forward(self, scale_feats) -> torch.Tensor:
        """scale_feats: a list of (B, N_s, D) -> (B, sum N_s, D)."""
        parts = [f + self.scale_embed[s][None, None]
                 + self.pos_embed[: f.shape[1]][None]
                 for s, f in enumerate(scale_feats)]
        x = torch.cat(parts, dim=1)
        for i in range(self.num_layers):
            x = x + getattr(self, f"attn{i}")(getattr(self, f"ln{i}")(x))
            y = getattr(self, f"ffn{i}_in")(getattr(self, f"ln{i}b")(x))
            x = x + getattr(self, f"ffn{i}_out")(F.gelu(y, approximate="tanh"))
        return x


class ResidualCrossAttentionBlock(nn.Module):
    """query + MHA(ln_1(query), ln_1(context)), then + MLP(ln_2(.)), both
    residual; scale-only LayerNorms at eps 1e-6, the erf GELU."""

    def __init__(self, dim: int, num_heads: int = 8, device=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.ln_1 = nn.LayerNorm(dim, eps=1e-6, bias=False, device=device)
        self.q = nn.Linear(dim, dim, device=device)
        self.k = nn.Linear(dim, dim, device=device)
        self.v = nn.Linear(dim, dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.ln_2 = nn.LayerNorm(dim, eps=1e-6, bias=False, device=device)
        self.mlp_in = nn.Linear(dim, 4 * dim, device=device)
        self.mlp_out = nn.Linear(4 * dim, dim, device=device)

    def forward(self, query: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        b, lq, _ = query.shape
        nh = self.num_heads
        hd = self.dim // nh
        x, ctx = self.ln_1(query), self.ln_1(context)
        q = self.q(x).reshape(b, lq, nh, hd)
        k = self.k(ctx).reshape(b, -1, nh, hd)
        v = self.v(ctx).reshape(b, -1, nh, hd)
        a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * hd**-0.5,
                          dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, lq, self.dim)
        query = query + self.proj(o)
        y = self.mlp_in(self.ln_2(query))
        return query + self.mlp_out(F.gelu(y))


class CrossAttentionLookup(nn.Module):
    """Single-head cross-attention from the queries (B, L, dim) into a
    token bank: (M, bank_dim) shared by the batch, or (B, M, bank_dim) one
    a row. ``bank_dim`` defaults to ``dim``."""

    def __init__(self, dim: int, bank_dim: int | None = None, device=None):
        super().__init__()
        self.dim = dim
        self.q = nn.Linear(dim, dim, device=device)
        self.k = nn.Linear(bank_dim or dim, dim, device=device)
        self.v = nn.Linear(bank_dim or dim, dim, device=device)

    def forward(self, query: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
        bank = bank.to(query.dtype)
        q, k, v = self.q(query), self.k(bank), self.v(bank)
        bank_spec = "bmd" if bank.dim() == 3 else "md"
        a = torch.softmax(
            torch.einsum(f"bld,{bank_spec}->blm", q, k) * self.dim**-0.5,
            dim=-1)
        return torch.einsum(f"blm,{bank_spec}->bld", a, v)
