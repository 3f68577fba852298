"""Decoder-only transformer LM (Llama/Qwen family) with a KV cache, in PyTorch.

Counterpart of ``medical_image_analysis_tpu/models/llm.py``. The JAX
package has no kernel here; this is plain PyTorch.

Numerics follow the flax modules: dense layers compute in ``cfg.dtype``
(bf16 by default) and store their weights in it, which equals flax's
cast of fp32 weights at every call while a weight is frozen. A tensor
that trains keeps an fp32 master instead (``train.loop.fp32_masters``
converts it), cast to ``cfg.dtype`` at each use as flax casts its fp32
parameters: a bf16-stored weight would round most AdamW updates away.
RMSNorm statistics and outputs are fp32; attention scores and softmax are
fp32 (bf16 q.k products are exact in fp32); ``lm_head`` is fp32.

``LLMConfig.quant_int8`` builds every dense layer as :class:`QuantDense`
(JAX ``QuantDense``, the serving path of ``model.llm_int8``): an int8
``kernel_q`` and an fp32 per-output-column ``scale``, dequantised to the
compute dtype element by element before the product, as the JAX package
computes it (outside any Pallas kernel). A weight whose dequantised or
cast copy would be large (``lm_head``: 151,936 x 2,048, 1.24 GB in fp32)
is expanded in pieces of output columns (:func:`chunked_linear`), so no
step holds that copy whole.

KV caches are lists of per-layer tuples, as in the JAX package:
``(k, v, cur)`` for the joint cache and ``(kp, vp, kg, vg, cur)`` for the
split beam cache, with ``cur`` a Python int. Unlike JAX's functional
updates, the port writes new K/V into the cache tensors in place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.tp import copy_to_model, gather_from_model, reduce_from_model
from .common import RMSNorm


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_bias: bool = False  # Qwen2 q/k/v biases
    quant_int8: bool = False  # int8 weights + per-column scales
    remat: bool = False  # checkpoint each block under a gradient
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


LLM_CONFIGS = {
    "llama2_7b": LLMConfig(32000, 4096, 32, 32, 32, 11008),
    "llama2_13b": LLMConfig(32000, 5120, 40, 40, 40, 13824),
    "qwen1_5_0_5b": LLMConfig(151936, 1024, 24, 16, 16, 2816),
    "qwen1_5_1_8b": LLMConfig(151936, 2048, 24, 16, 16, 5504),
    "tiny_test": LLMConfig(256, 64, 2, 4, 2, 128),
}


def _rope(q, k, positions, theta: float):
    """Rotary embedding, HF Llama convention (rotate_half)."""
    hd = q.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=q.device) / hd
    inv = 1.0 / theta**exps
    freqs = positions[..., None].float() * inv  # (B, L, hd/2)
    cos = torch.cos(freqs)[:, :, None, :]
    sin = torch.sin(freqs)[:, :, None, :]

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.to(x.dtype)

    return rot(q), rot(k)


# Weight elements expanded at once where a layer's weight is dequantised or
# cast for its product (128 MiB of fp32): lm_head's 311 M take 10 pieces.
CHUNK_ELEMS = 1 << 25


def chunked_linear(x, rows, n_out: int, d_in: int, bias=None):
    """``F.linear(x, rows(0, n_out), bias)``, the weight's rows (output
    columns) taken ``CHUNK_ELEMS // d_in`` at a time: ``rows(i, j)`` returns
    rows ``i:j`` in the compute dtype. Each output element is the same dot
    product as in one call."""
    step = max(1, CHUNK_ELEMS // d_in)
    if n_out <= step:
        return F.linear(x, rows(0, n_out), bias)
    return torch.cat([
        F.linear(x, rows(i, min(i + step, n_out)),
                 None if bias is None else bias[i:i + step])
        for i in range(0, n_out, step)], dim=-1)


def transient_bytes(n_out: int, d_in: int, dtype: torch.dtype) -> int:
    """Bytes of the largest weight piece :func:`chunked_linear` expands."""
    step = max(1, CHUNK_ELEMS // d_in)
    return min(step, n_out) * d_in * torch.empty((), dtype=dtype).element_size()


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: the input, weight and bias cast to the
    compute dtype, the dtype the layer was built in (an fp32 master of a
    bf16 layer computes in bf16; a bf16 weight loaded into fp32
    ``lm_head`` computes in fp32, cast a piece at a time)."""

    def __init__(self, *args, dtype=None, **kwargs):
        super().__init__(*args, dtype=dtype, **kwargs)
        self.compute_dtype = self.weight.dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        w = self.weight
        if w.dtype == dt:
            return F.linear(x.to(dt), w, bias)
        return chunked_linear(x.to(dt), lambda i, j: w[i:j].to(dt),
                              self.out_features, self.in_features, bias)


class QuantDense(nn.Module):
    """JAX ``QuantDense``: ``kernel_q`` int8 (out, in), the Linear layout
    of the flax (in, out) kernel; ``scale`` fp32 (out,); ``bias`` fp32. The
    weight is ``kernel_q.to(dtype) * scale.to(dtype)``, rounded to the
    compute dtype element by element, then ``x.to(dtype) @ w.T``. Neither
    ``kernel_q`` nor ``scale`` takes a gradient: int8 is a serving format
    (``train.loop`` refuses LoRA on it)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.in_features, self.out_features = d_in, d_out
        self.compute_dtype = dtype
        self.kernel_q = nn.Parameter(
            torch.zeros(d_out, d_in, dtype=torch.int8, device=device),
            requires_grad=False)
        self.scale = nn.Parameter(torch.ones(d_out, device=device),
                                  requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(d_out, device=device))
                     if bias else None)

    @torch.no_grad()
    def init_own_params(self, gen=None) -> None:
        """flax's initialisers: ``kernel_q`` zeros, ``scale`` ones."""
        self.kernel_q.zero_()
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def dequantized(self, i: int = 0, j: int | None = None) -> torch.Tensor:
        """Rows ``i:j`` of the weight in the compute dtype."""
        dt = self.compute_dtype
        return self.kernel_q[i:j].to(dt) * self.scale[i:j].to(dt)[:, None]

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return chunked_linear(x.to(dt), self.dequantized, self.out_features,
                              self.in_features, bias)


def _dense(cfg: LLMConfig, d_in: int, d_out: int, bias: bool = False,
           device=None):
    if cfg.quant_int8:
        return QuantDense(d_in, d_out, bias, dtype=cfg.dtype, device=device)
    return Dense(d_in, d_out, bias=bias, device=device, dtype=cfg.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.q_proj = _dense(cfg, cfg.dim, nh * hd, cfg.attn_bias, device)
        self.k_proj = _dense(cfg, cfg.dim, nkv * hd, cfg.attn_bias, device)
        self.v_proj = _dense(cfg, cfg.dim, nkv * hd, cfg.attn_bias, device)
        self.o_proj = _dense(cfg, nh * hd, cfg.dim, False, device)
        # this rank's (query, kv) heads and the mesh whose model axis
        # shards them (parallel.tp.shard_llm); all of them and None
        # otherwise
        self.heads = (nh, nkv)
        self.tp = None

    def forward(self, x, positions, mask, layer_cache=None, beam=None):
        _, out, new_cache = self.attend(x, positions, mask, layer_cache, beam)
        return reduce_from_model(self.o_proj(out), self.tp), new_cache

    def attend(self, x, positions, mask, layer_cache=None, beam=None):
        """(the un-rotated queries (B, L, nh, hd), the attention's output
        before ``o_proj`` (B, L, nh * hd), the new layer cache); nh is this
        rank's heads under tensor parallelism."""
        cfg = self.cfg
        b, l, _ = x.shape
        (nh, nkv), hd = self.heads, cfg.head_dim
        rep = nh // nkv
        x = copy_to_model(x, self.tp)
        q = self.q_proj(x).reshape(b, l, nh, hd)
        k = self.k_proj(x).reshape(b, l, nkv, hd)
        v = self.v_proj(x).reshape(b, l, nkv, hd)
        q_rot, k = _rope(q, k, positions, cfg.rope_theta)

        if layer_cache is not None and len(layer_cache) == 5:
            # Split beam cache: group-shared prompt segment + per-beam
            # generated segment (see split_beam_cache). Decode-only.
            kp, vp, kg, vg, cur = layer_cache
            kg[:, cur : cur + l] = k.to(kg.dtype)
            vg[:, cur : cur + l] = v.to(vg.dtype)
            new_cache = (kp, vp, kg, vg, cur + l)
            if rep > 1:
                kp, vp, kg, vg = (
                    t.repeat_interleave(rep, dim=2) for t in (kp, vp, kg, vg)
                )
            mask_p, mask_g = mask
            out = _split_ancestry_decode_attn(
                q_rot, kp, vp, kg, vg, mask_p, mask_g, beam, hd
            )
            return q, out.reshape(b, l, nh * hd), new_cache

        if layer_cache is not None:
            ck, cv, cur = layer_cache  # (B, max_len, nkv, hd) x2, int
            ck[:, cur : cur + l] = k.to(ck.dtype)
            cv[:, cur : cur + l] = v.to(cv.dtype)
            k_all, v_all = ck, cv
            new_cache = (ck, cv, cur + l)
        else:
            k_all, v_all = k, v
            new_cache = None

        if rep > 1:
            k_all = k_all.repeat_interleave(rep, dim=2)
            v_all = v_all.repeat_interleave(rep, dim=2)

        if beam is not None and l == 1:
            out = _ancestry_decode_attn(q_rot, k_all, v_all, mask, beam, hd)
            return q, out.reshape(b, l, nh * hd), new_cache

        attn = torch.einsum("blhd,bshd->bhls", q_rot.float(),
                            k_all.float()) * hd**-0.5
        attn = torch.softmax(attn + mask, dim=-1)
        out = torch.einsum("bhls,bshd->blhd", attn.to(v_all.dtype), v_all)
        return q, out.reshape(b, l, nh * hd), new_cache


def _select(anc, nb):
    """(B, i, j, s) bool: logical beam i reads group row j at slot s."""
    rows = torch.arange(nb, dtype=anc.dtype, device=anc.device)
    return anc[:, :, None, :] == rows[None, None, :, None]


def _ancestry_decode_attn(q, k_all, v_all, mask, beam, hd):
    """Beam decode attention over an append-only cache.

    ``beam`` (B, nb, S): the group-relative cache row holding logical
    beam (b, i)'s token at slot s. Scores against all nb rows of the
    group are computed and the ancestry row is selected with a mask.
    q (R,1,nh,hd); k/v (R,S,nh,hd); mask (R|1,1,1,S) additive; R = B*nb.
    """
    nb = beam.shape[1]
    r, s, nh = k_all.shape[0], k_all.shape[1], k_all.shape[2]
    bb = r // nb
    qg = q[:, 0].reshape(bb, nb, nh, hd)
    kg = k_all.reshape(bb, nb, s, nh, hd)
    sall = torch.einsum("bihd,bjshd->bhijs", qg.float(), kg.float()) * hd**-0.5
    sel = _select(beam, nb)
    scores = torch.where(sel[:, None], sall, 0.0).sum(dim=3)
    mask = mask.expand(r, 1, 1, s)
    scores = scores + mask.reshape(bb, nb, 1, s).transpose(1, 2)
    p = torch.softmax(scores, dim=-1)  # (B, h, i, s) fp32
    vg = v_all.reshape(bb, nb, s, nh, hd)
    pj = torch.where(sel[:, None], p[:, :, :, None, :], 0.0).to(v_all.dtype)
    out = torch.einsum("bhijs,bjshd->bihd", pj, vg)
    return out.reshape(r, 1, nh, hd)


def _split_ancestry_decode_attn(q, kp, vp, kg, vg, mask_p, mask_g, anc, hd):
    """Beam decode attention over the split cache: prompt K/V stored once
    per batch item, generated K/V per beam row resolved by ancestry.
    Softmax runs over the concatenated [prompt | generated] score axis.

    q (R,1,nh,hd); kp/vp (B,Sp,nh,hd); kg/vg (R,Sg,nh,hd);
    mask_p (B,1,1,Sp), mask_g (1,1,1,Sg) additive; anc (B,nb,Sg).
    """
    bb, nb = anc.shape[0], anc.shape[1]
    sp, sg = kp.shape[1], kg.shape[1]
    nh = q.shape[2]
    qg = q[:, 0].reshape(bb, nb, nh, hd).float()
    sc_p = torch.einsum("bihd,bshd->bhis", qg, kp.float()) * hd**-0.5
    sc_p = sc_p + mask_p.reshape(bb, 1, 1, sp)
    kgg = kg.reshape(bb, nb, sg, nh, hd)
    sall = torch.einsum("bihd,bjshd->bhijs", qg, kgg.float()) * hd**-0.5
    sel = _select(anc, nb)
    sc_g = torch.where(sel[:, None], sall, 0.0).sum(dim=3)
    sc_g = sc_g + mask_g.reshape(1, 1, 1, sg)
    p = torch.softmax(torch.cat([sc_p, sc_g], dim=-1), dim=-1)
    pp, pg = p[..., :sp], p[..., sp:]
    # bf16 operands with fp32 sums, as JAX's preferred_element_type=f32
    out_p = torch.einsum("bhis,bshd->bihd", pp.to(vp.dtype).float(),
                         vp.float())
    vgg = vg.reshape(bb, nb, sg, nh, hd)
    pj = torch.where(sel[:, None], pg[:, :, :, None, :], 0.0).to(vg.dtype)
    out_g = torch.einsum("bhijs,bjshd->bihd", pj.float(), vgg.float())
    return (out_p + out_g).to(q.dtype).reshape(bb * nb, 1, nh, hd)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        self.gate_proj = _dense(cfg, cfg.dim, cfg.hidden_dim, device=device)
        self.up_proj = _dense(cfg, cfg.dim, cfg.hidden_dim, device=device)
        self.down_proj = _dense(cfg, cfg.hidden_dim, cfg.dim, device=device)
        self.tp = None  # the mesh whose model axis shards hidden_dim

    def forward(self, x):
        x = copy_to_model(x, self.tp)
        y = self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        return reduce_from_model(y, self.tp)


class LlamaBlock(nn.Module):
    """Pre-norm decoder block. ``attn`` replaces ``LlamaAttention``
    (EMRRG's hybrid layers); ``forward``'s extra keyword arguments go to
    it."""

    def __init__(self, cfg: LLMConfig, device=None, attn=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.dim, cfg.norm_eps, device=device)
        self.self_attn = (attn if attn is not None
                          else LlamaAttention(cfg, device=device))
        self.post_attention_layernorm = RMSNorm(cfg.dim, cfg.norm_eps,
                                                device=device)
        self.mlp = LlamaMLP(cfg, device=device)

    def forward(self, x, positions, mask, layer_cache=None, beam=None,
                **cross):
        h = self.input_layernorm(x)
        attn_out, new_cache = self.self_attn(h, positions, mask, layer_cache,
                                             beam, **cross)
        x = x + attn_out
        h = self.post_attention_layernorm(x)
        return x + self.mlp(h), new_cache


def _neg_inf_where_not(ok):
    return torch.where(ok, 0.0, float("-inf"))


class TransformerLM(nn.Module):
    """Decoder-only LM. Accepts token ids or ``inputs_embeds``.

    ``make_layer(i)`` builds layer ``i`` (a ``LlamaBlock``); a subclass
    may build others, and ``forward`` hands its extra keyword arguments to
    the layers whose ``cross`` is true (``models/hybrid_decoder.py``)."""

    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim,
                                         device=device, dtype=cfg.dtype)
        self.layers = nn.ModuleList(
            self.make_layer(i, device) for i in range(cfg.n_layers)
        )
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, device=device)
        if cfg.tie_embeddings:
            self.lm_head = None
        elif cfg.quant_int8:  # fp32 compute, as JAX (:322-325)
            self.lm_head = QuantDense(cfg.dim, cfg.vocab_size,
                                      dtype=torch.float32, device=device)
        else:
            self.lm_head = Dense(cfg.dim, cfg.vocab_size, bias=False,
                                 device=device, dtype=torch.float32)

        # meshes whose model axis shards the embedding's features and
        # lm_head's vocabulary (parallel.tp.shard_llm)
        self.embed_tp = None
        self.head_tp = None

    def make_layer(self, i: int, device=None) -> nn.Module:
        return LlamaBlock(self.cfg, device=device)

    @property
    def kv_heads(self) -> int:
        """The KV heads this rank's cache holds."""
        return self.layers[0].self_attn.heads[1]

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.embed_tokens(input_ids).to(self.cfg.dtype)
        return gather_from_model(x, self.embed_tp)

    def forward(
        self,
        input_ids=None,
        inputs_embeds=None,
        attention_mask=None,  # (B, L) 1=keep (no cache)
        positions=None,  # (B, L)
        cache: list | None = None,
        cache_mask=None,  # (B, max_len) 1=valid slot
        beam=None,  # (B, nb, max_len) int ancestry
        **cross,  # the hybrid layers' inputs (vision, text_mask)
    ):
        cfg = self.cfg
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        x = inputs_embeds.to(cfg.dtype)
        b, l, _ = x.shape
        dev = x.device
        if positions is None:
            positions = torch.arange(l, device=dev).expand(b, l)

        if cache is not None and len(cache[0]) == 5:
            # Split beam cache: (mask_p, mask_g) — prompt segment valid
            # modulo cache_mask, generated segment causal over gen slots.
            if l != 1 or beam is None:
                raise ValueError("the split beam cache is decode-only (l=1, "
                                 "beam ancestry given)")
            kp0, _, kg0, _, cur = cache[0]
            sp, sg = kp0.shape[1], kg0.shape[1]
            if cache_mask is not None:
                mask_p = _neg_inf_where_not(cache_mask[:, None, None, :sp] > 0)
            else:
                mask_p = torch.zeros(kp0.shape[0], 1, 1, sp, device=dev)
            mask_g = _neg_inf_where_not(
                torch.arange(sg, device=dev)[None, None, None, :] <= cur
            )
            mask = (mask_p, mask_g)
        elif cache is not None:
            cur = cache[0][2]
            s = cache[0][0].shape[1]
            kpos = torch.arange(s, device=dev)[None, None, :]
            # token i of this call sits at slot cur+i, attends slots <= it
            slot_ok = kpos <= (cur + torch.arange(l, device=dev)[None, :, None])
            mask = _neg_inf_where_not(slot_ok)
            if cache_mask is not None:
                mask = mask + _neg_inf_where_not(cache_mask[:, None, :] > 0)
            mask = mask[:, None]  # (B|1, 1, L, S)
        else:
            causal = torch.ones(l, l, dtype=torch.bool, device=dev).tril()
            mask = _neg_inf_where_not(causal)[None, None]
            if attention_mask is not None:
                mask = mask + _neg_inf_where_not(
                    attention_mask[:, None, None, :] > 0
                )

        new_cache = [] if cache is not None else None
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            layer_cache = cache[i] if cache is not None else None
            kw = cross if getattr(layer, "cross", False) else {}
            if remat:  # flax nn.remat(LlamaBlock)
                x, lc = checkpoint(layer, x, positions, mask, None, None,
                                   **kw, use_reentrant=False)
            else:
                x, lc = layer(x, positions, mask, layer_cache, beam, **kw)
            if new_cache is not None:
                new_cache.append(lc)

        x = self.norm(x)
        if cfg.tie_embeddings:
            table = self.embed_tokens.weight.to(cfg.dtype)
            x = x.to(cfg.dtype)
            if self.embed_tp is not None:  # the rank's features' share
                w, i = table.shape[1], self.embed_tp.index("model")
                x = copy_to_model(x, self.embed_tp)[..., i * w : (i + 1) * w]
                logits = reduce_from_model(x @ table.T, self.embed_tp)
            else:
                logits = x @ table.T
        else:
            logits = gather_from_model(
                self.lm_head(copy_to_model(x.float(), self.head_tp)),
                self.head_tp)
        logits = logits.float()
        if cache is not None:
            return logits, new_cache
        return logits


def init_cache(cfg: LLMConfig, batch: int, max_len: int, dtype=None,
               device=None, n_kv_heads: int | None = None):
    """Empty KV cache: list of (k, v, cur_index) per layer, of
    ``n_kv_heads`` (this rank's, ``TransformerLM.kv_heads``; all of them
    by default)."""
    dtype = dtype or cfg.dtype
    shape = (batch, max_len, n_kv_heads or cfg.n_kv_heads, cfg.head_dim)
    return [
        (torch.zeros(shape, dtype=dtype, device=device),
         torch.zeros(shape, dtype=dtype, device=device), 0)
        for _ in range(cfg.n_layers)
    ]


def reorder_cache(cache, beam_idx: torch.Tensor):
    """Gather cache rows along batch for beam search."""
    return [(k[beam_idx], v[beam_idx], cur) for k, v, cur in cache]


def split_beam_cache(prompt_cache, num_beams: int, gen_slots: int):
    """Promote a B-row prefill cache to the split beam layout: the prompt
    K/V stay one row per batch item, shared read-only by the beam group,
    and an empty per-beam generated segment of ``gen_slots`` is attached.
    """
    out = []
    for ck, cv, _cur in prompt_cache:
        b, _sp, h, d = ck.shape
        kg = torch.zeros(b * num_beams, gen_slots, h, d, dtype=ck.dtype,
                         device=ck.device)
        out.append((ck, cv, kg, torch.zeros_like(kg), 0))
    return out
