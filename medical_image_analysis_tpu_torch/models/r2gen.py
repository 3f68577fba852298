"""R2Gen: a transformer encoder-decoder with a relational memory and
memory-conditioned LayerNorms, in PyTorch.

Counterpart of ``medical_image_analysis_tpu/models/r2gen.py``, with its
parameter names (attributes named as the flax modules: ``enc_attn<i>``,
``enc_ff<i>a``/``b``, ``enc_ln<i>``, ``dec_self<i>``, ``dec_cross<i>``,
``dec_ff<i>a``/``b``, ``dec_cln<i>``, ``rm``, so that ``ckpt.from_jax``
loads a JAX ``init`` strictly; the norms' raw ``gamma`` and ``beta`` keep
their names, and so match none of the no-decay patterns). The JAX package
computes it with einsums outside any Pallas kernel, so plain PyTorch
products are its port; ``R2GenPipeline``'s ViT tower runs the ViT block
kernels (``ops/vit_block.py``).

Generation re-decodes the whole prefix at every step (no KV cache), as
the reference's ``core()`` does: every part of the decoder is causal, so
the prefix up to the step's position gives the logits that the JAX
package reads at that position of its full buffer.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import loss_denominator
from .generation import beam_generate, greedy_generate
from .mrg import VisionEncoder, _encode_views


class RelationalMemory(nn.Module):
    """Gated slot memory updated once a target token."""

    def __init__(self, num_slots: int, d_model: int, num_heads: int = 1,
                 device=None):
        super().__init__()
        self.num_slots, self.d_model, self.num_heads = (num_slots, d_model,
                                                        num_heads)
        for name in ("attn_q", "attn_k", "attn_v", "attn_o", "mlp1", "mlp2"):
            self.add_module(name, nn.Linear(d_model, d_model, device=device))
        self.w_gate = nn.Linear(d_model, 2 * d_model, device=device)
        self.u_gate = nn.Linear(d_model, 2 * d_model, device=device)

    def init_memory(self, batch: int, device=None) -> torch.Tensor:
        """(B, S, D): the identity, padded with zeros to D (or cut)."""
        eye = torch.eye(self.num_slots, device=device)
        if self.d_model > self.num_slots:
            eye = F.pad(eye, (0, self.d_model - self.num_slots))
        else:
            eye = eye[:, : self.d_model]
        return eye[None].expand(batch, self.num_slots, self.d_model)

    def step(self, token_emb: torch.Tensor,
             memory: torch.Tensor) -> torch.Tensor:
        """token_emb (B, D), memory (B, S, D) -> the next memory."""
        nh = self.num_heads
        hd = self.d_model // nh
        b = memory.shape[0]
        kv_in = torch.cat([memory, token_emb[:, None]], dim=1)
        q = self.attn_q(memory).reshape(b, -1, nh, hd)
        k = self.attn_k(kv_in).reshape(b, -1, nh, hd)
        v = self.attn_v(kv_in).reshape(b, -1, nh, hd)
        a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * hd**-0.5,
                          dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, -1,
                                                          self.d_model)
        nxt = memory + self.attn_o(o)
        nxt = nxt + F.relu(self.mlp2(F.relu(self.mlp1(nxt))))
        gates = self.w_gate(token_emb[:, None]) + self.u_gate(
            torch.tanh(memory))
        ig, fg = gates.chunk(2, dim=-1)
        return torch.sigmoid(ig) * torch.tanh(nxt) + torch.sigmoid(fg) * memory

    def forward(self, token_embs: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> the memory after each token, (B, T, S * D)."""
        b, t, _ = token_embs.shape
        mem = self.init_memory(b, token_embs.device)
        outs = []
        for i in range(t):
            mem = self.step(token_embs[:, i], mem)
            outs.append(mem.reshape(b, -1))
        return torch.stack(outs, dim=1)


def _ref_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's LayerNorm core, ``(x - mean) / (std + eps)``, with
    the unbiased std and eps added to the std, not to the variance."""
    mean = x.mean(-1, keepdim=True)
    n = x.shape[-1]
    std = torch.sqrt(x.var(-1, keepdim=True, unbiased=False) * n / (n - 1))
    return (x - mean) / (std + eps)


class RefLayerNorm(nn.Module):
    """gamma/beta LayerNorm in the reference's std form."""

    def __init__(self, d_model: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(d_model, device=device))
        self.beta = nn.Parameter(torch.zeros(d_model, device=device))

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        self.gamma.fill_(1.0)
        self.beta.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gamma * _ref_norm(x) + self.beta


class ConditionalLayerNorm(RefLayerNorm):
    """LayerNorm whose gamma and beta are shifted by deltas predicted from
    the memory (B, T, ``mem_dim`` = slots x d_model) by 2-layer ReLU
    MLPs."""

    def __init__(self, d_model: int, mem_dim: int, device=None):
        super().__init__(d_model, device=device)
        self.delta_gamma = nn.Linear(mem_dim, d_model, device=device)
        self.delta_gamma2 = nn.Linear(d_model, d_model, device=device)
        self.delta_beta = nn.Linear(mem_dim, d_model, device=device)
        self.delta_beta2 = nn.Linear(d_model, d_model, device=device)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        dg = self.delta_gamma2(F.relu(self.delta_gamma(memory)))
        db = self.delta_beta2(F.relu(self.delta_beta(memory)))
        return (self.gamma + dg) * _ref_norm(x) + (self.beta + db)


class _MHA(nn.Module):
    """Multi-head attention with an additive mask and an fp32 softmax."""

    def __init__(self, d_model: int, num_heads: int, device=None):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        for name in ("q", "k", "v", "o"):
            self.add_module(name, nn.Linear(d_model, d_model, device=device))

    def forward(self, q_in, kv_in, mask=None):
        b, lq, _ = q_in.shape
        nh, hd = self.num_heads, self.d_model // self.num_heads
        q = self.q(q_in).reshape(b, lq, nh, hd)
        k = self.k(kv_in).reshape(b, -1, nh, hd)
        v = self.v(kv_in).reshape(b, -1, nh, hd)
        a = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd**-0.5
        if mask is not None:
            a = a + mask
        a = torch.softmax(a.float(), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, lq, self.d_model)
        return self.o(o)


class R2Gen(nn.Module):
    """att_feats (B, L, ``att_dim``) + target ids -> logits / generation."""

    def __init__(self, vocab_size: int, att_dim: int, d_model: int = 512,
                 d_ff: int = 512, num_layers: int = 3, num_heads: int = 8,
                 rm_num_slots: int = 3, rm_num_heads: int = 8, device=None):
        super().__init__()
        self.d_model, self.num_layers = d_model, num_layers
        add = self.add_module
        add("att_embed", nn.Linear(att_dim, d_model, device=device))
        add("embed", nn.Embedding(vocab_size, d_model, device=device))
        add("rm", RelationalMemory(rm_num_slots, d_model, rm_num_heads,
                                   device=device))
        mem_dim = rm_num_slots * d_model
        for i in range(num_layers):
            add(f"enc_attn{i}", _MHA(d_model, num_heads, device=device))
            for side in ("enc", "dec"):
                add(f"{side}_ff{i}a", nn.Linear(d_model, d_ff, device=device))
                add(f"{side}_ff{i}b", nn.Linear(d_ff, d_model, device=device))
            add(f"dec_self{i}", _MHA(d_model, num_heads, device=device))
            add(f"dec_cross{i}", _MHA(d_model, num_heads, device=device))
        for i in range(2 * num_layers):
            add(f"enc_ln{i}", RefLayerNorm(d_model, device=device))
        for i in range(3 * num_layers):
            add(f"dec_cln{i}", ConditionalLayerNorm(d_model, mem_dim,
                                                    device=device))
        add("enc_norm", RefLayerNorm(d_model, device=device))
        add("dec_norm", RefLayerNorm(d_model, device=device))
        add("logit", nn.Linear(d_model, vocab_size, device=device))

    def _sub(self, name: str, i: int) -> nn.Module:
        return getattr(self, f"{name}{i}")

    def encode(self, att_feats: torch.Tensor) -> torch.Tensor:
        x = self.att_embed(att_feats)
        for i in range(self.num_layers):
            h = self._sub("enc_ln", 2 * i)(x)
            x = x + self._sub("enc_attn", i)(h, h)
            h = self._sub("enc_ln", 2 * i + 1)(x)
            x = x + self._sub("enc_ff", f"{i}b")(
                F.relu(self._sub("enc_ff", f"{i}a")(h)))
        return self.enc_norm(x)

    def _positional(self, t: int, device=None) -> torch.Tensor:
        """(t, d_model) sinusoidal positions: sin at even, cos at odd."""
        pos = torch.arange(t, device=device, dtype=torch.float32)[:, None]
        dim = torch.arange(0, self.d_model, 2, device=device,
                           dtype=torch.float32)[None]
        angle = pos / 10000 ** (dim / self.d_model)
        pe = torch.zeros(t, self.d_model, device=device)
        pe[:, 0::2] = torch.sin(angle)
        pe[:, 1::2] = torch.cos(angle)
        return pe

    def decode(self, enc: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
        """seq (B, T) token ids -> logits (B, T, V)."""
        t = seq.shape[1]
        dev = seq.device
        x = (self.embed(seq.long()) * self.d_model**0.5
             + self._positional(t, dev)[None])
        # the memory reads the same scaled embeddings the decoder does
        mems = self.rm(x)  # (B, T, S * D)
        causal = torch.where(
            torch.ones(t, t, dtype=torch.bool, device=dev).tril(), 0.0,
            float("-inf"))[None, None]
        for i in range(self.num_layers):
            h = self._sub("dec_cln", 3 * i)(x, mems)
            x = x + self._sub("dec_self", i)(h, h, causal)
            h = self._sub("dec_cln", 3 * i + 1)(x, mems)
            x = x + self._sub("dec_cross", i)(h, enc)
            h = self._sub("dec_cln", 3 * i + 2)(x, mems)
            x = x + self._sub("dec_ff", f"{i}b")(
                F.relu(self._sub("dec_ff", f"{i}a")(h)))
        return self.logit(self.dec_norm(x))

    def forward(self, att_feats: torch.Tensor,
                seq: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(att_feats), seq)

    @torch.no_grad()
    def generate(self, att_feats: torch.Tensor, max_new_tokens: int = 60,
                 num_beams: int = 3, bos_id: int = 1, eos_id: int = 2):
        """Beam (or greedy, ``num_beams`` 1) decoding that re-runs the
        decoder on the prefix at every step. Returns (B, max_new_tokens)."""
        enc = self.encode(att_feats)
        b = att_feats.shape[0]
        nb = max(num_beams, 1)
        if nb > 1:
            enc = enc.repeat_interleave(nb, dim=0)
        buf0 = torch.full((b * nb, max_new_tokens + 1), eos_id,
                          dtype=torch.int32, device=enc.device)
        buf0[:, 0] = bos_id
        first_logits = self.decode(enc, buf0[:, :1])[:, -1]

        def step(tokens, cache, t):
            # the token chosen at step t - 1 fills slot t (BOS at slot 0);
            # the next token's logits sit at decoder position t
            buf, enc_rows = cache
            buf[:, t] = tokens[:, 0]
            logits = self.decode(enc_rows, buf[:, : t + 1])
            return logits[:, -1], (buf, enc_rows)

        cache = (buf0, enc)
        if nb > 1:
            return beam_generate(
                step, cache, first_logits, batch=b, num_beams=nb,
                max_new_tokens=max_new_tokens, eos_id=eos_id,
                reorder_cache_fn=lambda c, idx: (c[0][idx], c[1][idx]))
        return greedy_generate(step, cache, first_logits,
                               max_new_tokens=max_new_tokens, eos_id=eos_id)


class R2GenPipeline(nn.Module):
    """A visual extractor (``VisionEncoder``: the ViT's patch tokens by
    default) averaged over views, and R2Gen, trained with a masked mean
    cross-entropy over the report tokens.

    Batches follow ``models/mrg.py``: images (B, V, H, W, 3); target_ids
    and target_mask (B, Lt) with EOS and no BOS (the decoder's input is
    BOS-shifted here).
    """

    def __init__(self, vocab_size: int, chosen: str = "vit",
                 vision_kwargs: Any = None, r2gen_kwargs: Any = None,
                 bos_id: int = 1, eos_id: int = 2, device=None):
        super().__init__()
        self.bos_id, self.eos_id = bos_id, eos_id
        self.vision = VisionEncoder(
            chosen, **{f"{chosen}_kwargs": vision_kwargs}, device=device)
        self.r2gen = R2Gen(vocab_size, self.vision.out_dim,
                           **(r2gen_kwargs or {}), device=device)

    def att_feats(self, images, deterministic: bool = True):
        return _encode_views(lambda x: self.vision(x, deterministic), images)

    def forward(self, images, target_ids, target_mask,
                deterministic: bool = True):
        return self.report_loss(self.att_feats(images, deterministic),
                                target_ids, target_mask)

    def report_loss(self, att, target_ids, target_mask):
        """The masked mean cross-entropy of the reports given the
        averaged patch tokens ``att`` (B, L, ``out_dim``)."""
        b = target_ids.shape[0]
        bos = torch.full((b, 1), self.bos_id, dtype=target_ids.dtype,
                         device=target_ids.device)
        seq_in = torch.cat([bos, target_ids[:, :-1]], dim=1)
        lp = torch.log_softmax(self.r2gen(att, seq_in), dim=-1)
        ll = torch.gather(lp, -1, target_ids[..., None].long())[..., 0]
        m = target_mask.float()
        return -torch.sum(ll * m) / loss_denominator(torch.sum(m), 1.0)

    @torch.no_grad()
    def generate(self, images, max_new_tokens: int = 60,
                 num_beams: int = 3):
        return self.r2gen.generate(
            self.att_feats(images, True), max_new_tokens=max_new_tokens,
            num_beams=num_beams, bos_id=self.bos_id, eos_id=self.eos_id)
