"""Post-LN BERT encoder, with optional query tokens and cross-attention.

Counterpart of ``medical_image_analysis_tpu/models/bert.py``'s
``BertConfig``, ``BertAttention``, ``BertFFN``, ``BertLayer`` and
``BertModel``: an HF ``bert-base``-style tower, the Bio_ClinicalBERT text
tower of CLIP alignment (``task_kwargs.text_tower: bert``). Parameter
names are the flax modules' (``word_embeddings``, ``position_embeddings``,
``token_type_embeddings``, ``embeddings_norm``, ``layer_<i>`` with
``attention``, ``crossattention``, ``ffn``, ``ffn_query``), and
``Blip2QFormer`` (``query_tokens`` beside its ``bert``): the BLIP-2
Q-Former of AM-MRG and R2GenKG, query-only. LayerNorms at ``cfg.eps``, the erf GELU,
padded keys at an additive -1e9.

Flax creates a parameter when a call first reaches it, and its ``Dense``
takes the width of whatever it is given; here the modules are built from
the config and the encoder's width (``enc_dim``, the cross-attention's
key/value input): ``crossattention`` in every ``cross_attention_freq``-th
layer, ``ffn_query`` when ``query_ffn``, the embeddings when
``use_embeddings``, and ``ffn`` unless only query tokens reach it
(``query_ffn`` without embeddings). A JAX ``init`` that reached all of
them loads strictly. A reference checkpoint may hold what a JAX ``init``
of the recipes never reaches: the tanh pooler (JAX ``pool='cls'``; HF
``pooler.dense``) is built with ``pooler=True`` and read by
``forward(pool="cls")``, and the full Q-Former's text FFN beside the query
FFN with ``text_ffn=True`` (read only by text positions, which the
query-only Q-Former has none of).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    intermediate: int = 3072
    max_position: int = 512
    type_vocab: int = 2
    eps: float = 1e-12
    # Q-Former extras (0 / False = plain BERT)
    cross_attention_freq: int = 0
    query_ffn: bool = False  # BLIP-2 intermediate_query/output_query
    use_embeddings: bool = True  # word/pos/type embeddings present


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)


class BertAttention(nn.Module):
    """query/key/value, out and out_norm (post-LN); ``kv_dim`` is the width
    of the key/value input (``dim`` for self-attention)."""

    def __init__(self, dim: int, n_heads: int, eps: float, device=None,
                 kv_dim: int | None = None):
        super().__init__()
        self.dim, self.n_heads = dim, n_heads
        self.query = nn.Linear(dim, dim, device=device)
        self.key = nn.Linear(kv_dim or dim, dim, device=device)
        self.value = nn.Linear(kv_dim or dim, dim, device=device)
        self.out = nn.Linear(dim, dim, device=device)
        self.out_norm = nn.LayerNorm(dim, eps=eps, device=device)

    def forward(self, x, kv, bias):
        nh, hd = self.n_heads, self.dim // self.n_heads
        b, lq, _ = x.shape
        q = self.query(x).reshape(b, lq, nh, hd)
        k = self.key(kv).reshape(b, -1, nh, hd)
        v = self.value(kv).reshape(b, -1, nh, hd)
        a = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd**-0.5
        if bias is not None:
            a = a + bias
        a = torch.softmax(a, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, lq, self.dim)
        return self.out_norm(self.out(o) + x)


class BertFFN(nn.Module):
    def __init__(self, dim: int, intermediate: int, eps: float, device=None):
        super().__init__()
        self.dense_in = nn.Linear(dim, intermediate, device=device)
        self.dense_out = nn.Linear(intermediate, dim, device=device)
        self.norm = nn.LayerNorm(dim, eps=eps, device=device)

    def forward(self, x):
        h = F.gelu(self.dense_in(x))  # erf form (approximate=False)
        return self.norm(self.dense_out(h) + x)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, has_cross: bool, device=None,
                 enc_dim: int | None = None, text_ffn: bool = False):
        super().__init__()
        c = self.cfg = cfg
        self.attention = BertAttention(c.dim, c.n_heads, c.eps, device)
        self.crossattention = (
            BertAttention(c.dim, c.n_heads, c.eps, device, enc_dim)
            if has_cross else None)
        # with query_ffn, the text FFN serves only text positions
        self.ffn = (BertFFN(c.dim, c.intermediate, c.eps, device)
                    if c.use_embeddings or not c.query_ffn or text_ffn
                    else None)
        self.ffn_query = (BertFFN(c.dim, c.intermediate, c.eps, device)
                          if c.query_ffn else None)

    def forward(self, x, self_bias, enc=None, enc_bias=None,
                query_length: int = 0):
        x = self.attention(x, x, self_bias)
        if self.crossattention is not None and enc is not None:
            if query_length and query_length < x.shape[1]:
                # only the query positions cross-attend
                qpart = self.crossattention(x[:, :query_length], enc,
                                            enc_bias)
                x = torch.cat([qpart, x[:, query_length:]], dim=1)
            else:
                x = self.crossattention(x, enc, enc_bias)
        if self.ffn_query is not None:
            ql = query_length if query_length else x.shape[1]
            qout = self.ffn_query(x[:, :ql])
            if ql < x.shape[1]:
                return torch.cat([qout, self.ffn(x[:, ql:])], dim=1)
            return qout
        return self.ffn(x)


class BertModel(nn.Module):
    """Post-LN BERT; optionally with query tokens and cross-attention.
    ``forward`` returns the last hidden state (B, L', D), or with
    ``pool="cls"`` the tanh pooler at position 0 (B, D). ``enc_dim`` is the
    width of ``encoder_hidden_states`` (``cfg.dim`` when None)."""

    def __init__(self, cfg: BertConfig, device=None,
                 enc_dim: int | None = None, pooler: bool = False,
                 text_ffn: bool = False):
        super().__init__()
        c = self.cfg = cfg
        if c.use_embeddings:
            self.word_embeddings = nn.Embedding(c.vocab_size, c.dim,
                                                device=device)
            self.position_embeddings = nn.Parameter(
                torch.empty(c.max_position, c.dim, device=device))
            self.token_type_embeddings = nn.Embedding(c.type_vocab, c.dim,
                                                      device=device)
        self.embeddings_norm = nn.LayerNorm(c.dim, eps=c.eps, device=device)
        for i in range(c.n_layers):
            has_cross = (c.cross_attention_freq > 0
                         and i % c.cross_attention_freq == 0)
            self.add_module(f"layer_{i}",
                            BertLayer(c, has_cross, device, enc_dim, text_ffn))
        self.pooler = (nn.Linear(c.dim, c.dim, device=device) if pooler
                       else None)

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        if self.cfg.use_embeddings:
            tmp = torch.empty(self.position_embeddings.shape,
                              device=self.position_embeddings.device)
            self.position_embeddings.copy_(tmp.normal_(0.0, 0.02,
                                                       generator=gen))

    def forward(self, input_ids=None, attention_mask=None,
                token_type_ids=None, query_embeds=None,
                encoder_hidden_states=None, encoder_attention_mask=None,
                pool: str | None = None):
        c = self.cfg
        parts = []
        if query_embeds is not None:
            parts.append(query_embeds)
        ql = 0 if query_embeds is None else query_embeds.shape[1]
        if input_ids is not None:
            ids = input_ids.long()
            we = self.word_embeddings(ids)
            we = we + self.position_embeddings[None, : ids.shape[1]]
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(ids)
            we = we + self.token_type_embeddings(token_type_ids.long())
            parts.append(we)
        x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        x = self.embeddings_norm(x)

        b, total = x.shape[:2]
        if attention_mask is None:
            attention_mask = torch.ones(b, total - ql, dtype=torch.int32,
                                        device=x.device)
        full_mask = torch.cat([torch.ones(b, ql, dtype=attention_mask.dtype,
                                          device=x.device), attention_mask],
                              dim=1) if ql else attention_mask
        self_bias = _mask_bias(full_mask)
        enc_bias = (_mask_bias(encoder_attention_mask)
                    if encoder_attention_mask is not None else None)
        for i in range(c.n_layers):
            x = getattr(self, f"layer_{i}")(
                x, self_bias, encoder_hidden_states, enc_bias,
                query_length=ql)
        if pool == "cls":
            if self.pooler is None:
                raise ValueError("BertModel: pool='cls' needs pooler=True")
            return torch.tanh(self.pooler(x[:, 0]))
        return x


class Blip2QFormer(nn.Module):
    """BLIP-2 Q-Former in query-only mode: learnable ``query_tokens`` (1, Q,
    dim) over a BERT encoder (``bert``) with the query FFN and
    cross-attention into the image features every ``cross_attention_freq``
    layers, under an all-ones encoder mask. ``enc_dim`` is the image
    features' width. The JAX module's text path (``input_ids``), which no
    recipe calls, is not ported: the encoder has no embeddings, and no text
    FFN unless ``text_ffn`` (to load a full Q-Former checkpoint), as the
    JAX ``init`` of a query-only call has none.

    ``forward(image_embeds (B, L, enc_dim))`` -> (B, num_queries, dim).
    """

    def __init__(self, num_queries: int = 32, dim: int = 768,
                 n_layers: int = 12, n_heads: int = 12,
                 intermediate: int = 3072, cross_attention_freq: int = 2,
                 enc_dim: int | None = None, text_ffn: bool = False,
                 device=None):
        super().__init__()
        cfg = BertConfig(dim=dim, n_layers=n_layers, n_heads=n_heads,
                         intermediate=intermediate,
                         cross_attention_freq=cross_attention_freq,
                         query_ffn=True, use_embeddings=False)
        self.query_tokens = nn.Parameter(
            torch.empty(1, num_queries, dim, device=device))
        self.bert = BertModel(cfg, device, enc_dim, text_ffn=text_ffn)

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        tmp = torch.empty(self.query_tokens.shape,
                          device=self.query_tokens.device)
        self.query_tokens.copy_(tmp.normal_(0.0, 0.02, generator=gen))

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        b = image_embeds.shape[0]
        q = self.query_tokens.expand(b, -1, -1).to(image_embeds.dtype)
        enc_mask = torch.ones(image_embeds.shape[:2], dtype=torch.int32,
                              device=image_embeds.device)
        return self.bert(query_embeds=q, encoder_hidden_states=image_embeds,
                         encoder_attention_mask=enc_mask)
