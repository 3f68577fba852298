"""EMRRG's hybrid gated cross-attention decoder, in PyTorch.

Counterpart of ``medical_image_analysis_tpu/models/hybrid_decoder.py``, with
its parameter names. Every ``cross_every``-th layer of the Llama/Qwen LM
(layers 0, n, 2n, ...) is a ``HybridDecoderLayer``: its self-attention's
queries also attend to vision tokens, whose keys and values come from
``cross_attn_kv_proj``, and the cross-attention's output is blended into
the self-attention's through a gate (``cross_attn_gate_proj`` of the
layer's normed input, through tanh or sigmoid) before ``o_proj``. The
other layers are the port's ``LlamaBlock``.

The cross-attention reads the un-rotated queries (the self-attention reads
them rotated), masks no vision token, and repeats its K/V heads for GQA.
The JAX package has no kernel here; this is plain PyTorch, with the
numerics of ``models/llm.py``. All three cache modes of the LM are kept:
none (training, prefill), the joint ``(k, v, cur)`` cache (greedy) and
the split beam cache ``(kp, vp, kg, vg, cur)``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..parallel.tp import copy_to_model, reduce_from_model
from .llm import LlamaAttention, LlamaBlock, LLMConfig, TransformerLM, _dense


class HybridAttention(LlamaAttention):
    """Self-attention + gated vision cross-attention with shared queries."""

    def __init__(self, cfg: LLMConfig, gate_fn: str = "tanh",
                 text_only_cross: bool = False, device=None):
        super().__init__(cfg, device=device)
        if gate_fn not in ("tanh", "sigmoid"):
            raise ValueError(f"unknown gate_fn {gate_fn!r}")
        self.gate_fn = gate_fn
        self.text_only_cross = text_only_cross
        nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cross_attn_kv_proj = _dense(cfg, cfg.dim, 2 * nkv * hd,
                                         device=device)
        self.cross_attn_gate_proj = _dense(cfg, cfg.dim, nh * hd,
                                           device=device)

    def forward(self, x, positions, mask, layer_cache=None, beam=None,
                vision=None, text_mask=None):
        """As ``LlamaAttention``'s, plus the vision tokens (B, Lv, dim),
        whose rows a beam decode replicates per beam (no reorder), and
        ``text_mask`` (B, L) for ``text_only_cross``."""
        if vision is None:
            raise ValueError("a hybrid decoder layer needs the vision tokens")
        q, self_out, new_cache = self.attend(x, positions, mask, layer_cache,
                                             beam)
        b, l, nh, hd = q.shape
        nkv = self.heads[1]  # this rank's, as nh (parallel.tp)
        rep = nh // nkv
        vision = copy_to_model(vision, self.tp)
        x = copy_to_model(x, self.tp)
        kv = self.cross_attn_kv_proj(vision).reshape(b, -1, 2 * nkv, hd)
        ck, cv = kv.chunk(2, dim=2)
        if rep > 1:
            ck = ck.repeat_interleave(rep, dim=2)
            cv = cv.repeat_interleave(rep, dim=2)
        xattn = torch.einsum("blhd,bshd->bhls", q.float(),
                             ck.float()) * hd**-0.5
        xattn = torch.softmax(xattn, dim=-1)
        cross_out = torch.einsum(
            "bhls,bshd->blhd", xattn.to(cv.dtype), cv
        ).reshape(b, l, nh * hd)
        gate = self.cross_attn_gate_proj(x)
        gate = torch.tanh(gate) if self.gate_fn == "tanh" else torch.sigmoid(
            gate)
        if self.text_only_cross and text_mask is not None:
            gate = gate * text_mask[..., None].to(gate.dtype)
        return reduce_from_model(self.o_proj(self_out + gate * cross_out),
                                 self.tp), new_cache


class HybridDecoderLayer(LlamaBlock):
    """``LlamaBlock`` with ``HybridAttention`` in its attention's place."""

    cross = True  # TransformerLM hands it the vision tokens

    def __init__(self, cfg: LLMConfig, gate_fn: str = "tanh",
                 text_only_cross: bool = False, device=None):
        super().__init__(cfg, device=device, attn=HybridAttention(
            cfg, gate_fn, text_only_cross, device=device))


class HybridTransformerLM(TransformerLM):
    """``TransformerLM`` whose layers ``i % cross_every == 0`` are hybrid.

    The call convention is ``TransformerLM``'s plus the keyword arguments
    ``vision`` (B, Lv, dim) and, for ``text_only_cross``, ``text_mask``
    (B, L): 1 where the gate stays open. ``lm_head`` is an fp32 Dense
    whatever ``tie_embeddings`` says, as in the JAX module.
    """

    def __init__(self, cfg: LLMConfig, cross_every: int = 4,
                 gate_fn: str = "tanh", text_only_cross: bool = False,
                 device=None):
        # plain attributes, read by make_layer during the base __init__
        self.cross_every = cross_every
        self.gate_fn = gate_fn
        self.text_only_cross = text_only_cross
        super().__init__(dataclasses.replace(cfg, tie_embeddings=False),
                         device=device)

    def make_layer(self, i: int, device=None) -> nn.Module:
        if i % self.cross_every == 0:
            return HybridDecoderLayer(self.cfg, self.gate_fn,
                                      self.text_only_cross, device=device)
        return LlamaBlock(self.cfg, device=device)
