"""Modern Hopfield layers: associative-memory retrieval as iterated scaled
dot-product attention.

Counterpart of ``medical_image_analysis_tpu/models/hopfield.py``
(``hopfield_retrieve``, ``Hopfield``, ``HopfieldLayer``,
``HopfieldPooling``), with its parameter names (``norm_state``,
``norm_stored``, ``norm_pattern``, ``q_proj``, ``k_proj``, ``v_proj``,
``out_proj`` under ``assoc``; ``lookup_weights``, ``pooling_queries``).
Per head, an association space of ``hidden`` and a value space of
``pattern_dim``; LayerNorms at eps 1e-5 on the state, stored and pattern
inputs; ``beta = scaling or hidden**-0.5`` multiplies the scores; the
retrieval ``q <- softmax(beta q K^T) K`` runs ``update_steps_max`` times
before the value read-out. Retrieval is deterministic (no association
dropout), as in the JAX package.

A stored-pattern bank of two dimensions (AM-MRG's memory banks) is shared
by the batch: its norms and projections are computed once and the
retrieval reads them for every row, which gives the numbers of the JAX
package's broadcast bank.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .common import trunc_normal_

_EPS = 1e-5


def _spec(t: torch.Tensor) -> str:
    """einsum letters of a bank's projection: (B, M, H, D) or one (M, H, D)
    shared by the batch."""
    return "bmhd" if t.dim() == 4 else "mhd"


def hopfield_retrieve(query: torch.Tensor, keys: torch.Tensor,
                      values: torch.Tensor, beta: float,
                      update_steps: int = 0) -> torch.Tensor:
    """The Hopfield update loop per head: query (B, L, H, Dh); keys (B, M,
    H, Dh) and values (B, M, H, Dv), or either without its batch axis
    (shared by the batch). Returns (B, L, H, Dv)."""
    ks, vs = _spec(keys), _spec(values)
    q = query
    for _ in range(update_steps):
        attn = torch.softmax(
            beta * torch.einsum(f"blhd,{ks}->bhlm", q, keys), dim=-1)
        q = torch.einsum(f"bhlm,{ks}->blhd", attn, keys)
    attn = torch.softmax(beta * torch.einsum(f"blhd,{ks}->bhlm", q, keys),
                         dim=-1)
    return torch.einsum(f"bhlm,{vs.replace('d', 'v')}->blhv", attn, values)


class Hopfield(nn.Module):
    """Per-head query, stored-pattern and value projections around
    :func:`hopfield_retrieve`; the values are the stored patterns unless
    ``forward`` is given ``values`` of their own. ``in_dim`` is the query's
    width, ``stored_dim`` the stored patterns' (``in_dim`` when None: the
    JAX ``Dense`` infers it) and ``value_dim`` the values' (``stored_dim``
    when None; ``norm_pattern`` normalizes the values at that width);
    ``hidden`` is the per-head association width, ``pattern_dim`` the
    per-head value width (``hidden`` when None), ``out_dim`` the output's
    (``in_dim`` when None). ``norm_state``, ``norm_stored`` and
    ``norm_pattern`` switch the input LayerNorms and ``use_bias`` the q, k
    and v projections' biases (all on, as in the JAX module and the
    library; a reference checkpoint without a norm is loaded with it
    off)."""

    def __init__(self, in_dim: int, hidden: int, num_heads: int = 1,
                 pattern_dim: int | None = None, out_dim: int | None = None,
                 update_steps_max: int = 0, scaling: float | None = None,
                 stored_dim: int | None = None, norm_stored: bool = True,
                 norm_state: bool = True, norm_pattern: bool = True,
                 use_bias: bool = True, value_dim: int | None = None,
                 device=None):
        super().__init__()
        stored_dim = stored_dim or in_dim
        value_dim = value_dim or stored_dim
        self.hidden, self.num_heads = hidden, num_heads
        self.pattern_dim = pattern_dim or hidden
        self.update_steps_max, self.scaling = update_steps_max, scaling
        nh = num_heads

        def norm(on, dim):
            return nn.LayerNorm(dim, eps=_EPS, device=device) if on \
                else nn.Identity()

        self.norm_state = norm(norm_state, in_dim)
        self.norm_stored = norm(norm_stored, stored_dim)
        self.norm_pattern = norm(norm_pattern, value_dim)
        self.q_proj = nn.Linear(in_dim, nh * hidden, bias=use_bias,
                                device=device)
        self.k_proj = nn.Linear(stored_dim, nh * hidden, bias=use_bias,
                                device=device)
        self.v_proj = nn.Linear(value_dim, nh * self.pattern_dim,
                                bias=use_bias, device=device)
        self.out_proj = nn.Linear(nh * self.pattern_dim, out_dim or in_dim,
                                  device=device)

    def forward(self, query: torch.Tensor, stored: torch.Tensor,
                values: torch.Tensor | None = None) -> torch.Tensor:
        """query (B, L, in_dim); stored (B, M, stored_dim) or (M,
        stored_dim), the stored patterns; values of the same leading shape
        and ``value_dim``, or None (the stored patterns)."""
        values = stored if values is None else values
        nh, hd, pd = self.num_heads, self.hidden, self.pattern_dim
        b, l, _ = query.shape
        q = self.q_proj(self.norm_state(query)).reshape(b, l, nh, hd)
        k = self.k_proj(self.norm_stored(stored)).reshape(
            *stored.shape[:-1], nh, hd)
        v = self.v_proj(self.norm_pattern(values)).reshape(
            *values.shape[:-1], nh, pd)
        beta = self.scaling or hd**-0.5
        out = hopfield_retrieve(q, k, v, beta, self.update_steps_max)
        return self.out_proj(out.reshape(b, l, nh * pd))


class HopfieldLayer(nn.Module):
    """Stored patterns passed at call time (``lookup_weights``, (M,
    bank_dim) or (B, M, bank_dim)), or a learnable bank of
    ``num_patterns`` rows of ``in_dim`` when ``num_patterns`` > 0 (the JAX
    module creates it when called without one). The bank feeds both the
    stored-pattern and the value inputs."""

    def __init__(self, in_dim: int, hidden: int, num_patterns: int = 0,
                 num_heads: int = 1, pattern_dim: int | None = None,
                 out_dim: int | None = None, update_steps_max: int = 0,
                 scaling: float | None = None, bank_dim: int | None = None,
                 device=None):
        super().__init__()
        self.lookup_weights = None
        if num_patterns:
            self.lookup_weights = nn.Parameter(
                torch.empty(num_patterns, in_dim, device=device))
            bank_dim = in_dim
        self.assoc = Hopfield(in_dim, hidden, num_heads, pattern_dim,
                              out_dim, update_steps_max, scaling,
                              stored_dim=bank_dim or in_dim, device=device)

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        if self.lookup_weights is not None:
            trunc_normal_(self.lookup_weights, 0.02, gen)

    def forward(self, x: torch.Tensor,
                lookup_weights: torch.Tensor | None = None) -> torch.Tensor:
        if lookup_weights is None:
            if self.lookup_weights is None:
                raise ValueError("HopfieldLayer: no bank given and none "
                                 "learned (num_patterns=0)")
            lookup_weights = self.lookup_weights
        return self.assoc(x, lookup_weights.to(x.dtype))


class HopfieldPooling(nn.Module):
    """Pool a set (B, M, stored_dim) into ``num_queries`` learned slots of
    ``hidden`` by association; returns (B, num_queries * hidden)."""

    def __init__(self, stored_dim: int, hidden: int, num_queries: int = 1,
                 num_heads: int = 1, update_steps_max: int = 0,
                 device=None):
        super().__init__()
        self.pooling_queries = nn.Parameter(
            torch.empty(1, num_queries, hidden, device=device))
        self.assoc = Hopfield(hidden, hidden, num_heads,
                              update_steps_max=update_steps_max,
                              stored_dim=stored_dim, device=device)

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        trunc_normal_(self.pooling_queries, 0.02, gen)

    def forward(self, stored: torch.Tensor) -> torch.Tensor:
        b = stored.shape[0]
        q = self.pooling_queries.expand(b, -1, -1).to(stored.dtype)
        return self.assoc(q, stored).reshape(b, -1)
