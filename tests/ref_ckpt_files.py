"""State dicts in the layouts of the reference's released PyTorch checkpoints,
for the tests and ``chip_smoke.py``: numpy arrays drawn from a seeded
``numpy.random.Generator`` under each source's own names and shapes.

- ``arm_sd``: MambaXray-VL's ARM (bimamba v3, ``mamba_simple.py``): the
  four-direction ``''``, ``_b``, ``_c``, ``_c_b`` twins, or one direction
  (a stage-1 file) with ``dirs=1``;
- ``vssm_sd``: VMamba's ``VSSM`` (the v1 or v2 patch embedding, SS2D's
  stacked ``x_proj_weight``, ``dt_projs_*``, ``A_logs``, ``Ds``);
- ``swin_hf_sd``: HF ``SwinModel`` (microsoft/swin-base-patch4-window7-224);
- ``vit_timm_sd``: timm ``vit_base_patch16_224`` (the MAE/DP ViT);
- ``bert_hf_sd`` and ``chexbert_sd``: HF ``BertModel`` (pooler included) and
  CheXbert's ``module.bert.*`` + ``module.linear_heads.{i}.*``;
- ``qformer_lavis_sd``: BLIP-2's Q-Former in LAVIS names
  (``Qformer.bert.*``, ``query_tokens``), text FFN included;
- ``hopfield_sd``: hflayers' ``HopfieldLayer`` (association core, the
  three input norms);
- ``cross_block_sd``: R2GenKG's ``ResidualCrossAttentionBlock``;
- ``r2gen_sd``: R2Gen's Transformer, relational memory and ``logit``.

``save_pth`` writes one as a released file does (``torch.save`` of tensors,
optionally inside a wrapper with the non-tensor entries such files carry).
It imports neither pytest nor the JAX package, on the pattern of
``tests/dicom_files.py``.
"""

import argparse
import math

import numpy as np
import torch


def _w(rng, *shape, scale=0.02):
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)


def _ones(rng, n):
    return 1.0 + _w(rng, n)


def _lin(sd, rng, name, n_out, n_in, bias=True):
    sd[name + ".weight"] = _w(rng, n_out, n_in)
    if bias:
        sd[name + ".bias"] = _w(rng, n_out)


def _ln(sd, rng, name, n):
    sd[name + ".weight"] = _ones(rng, n)
    sd[name + ".bias"] = _w(rng, n)


def arm_sd(rng, depth=12, dim=768, d_state=16, patch=16, img=224, dirs=4):
    """The reference ARM at ``expand=1`` (d_inner = dim), ``dt_rank =
    ceil(dim / 16)``, conv width 4, RMS layer norms, a LayerNorm ``norm_f``."""
    din, rank = dim, math.ceil(dim / 16)
    sd = {"patch_embed.proj.weight": _w(rng, dim, 3, patch, patch),
          "patch_embed.proj.bias": _w(rng, dim),
          "cls_token": _w(rng, 1, 1, dim),
          "pos_embed": _w(rng, 1, (img // patch) ** 2 + 1, dim)}
    _ln(sd, rng, "norm_f", dim)
    for i in range(depth):
        sd[f"layers.{i}.norm.weight"] = _ones(rng, dim)
        p = f"layers.{i}.mixer"
        sd[f"{p}.in_proj.weight"] = _w(rng, 2 * din, dim)
        sd[f"{p}.out_proj.weight"] = _w(rng, dim, din)
        for s in ("", "_b", "_c", "_c_b")[:dirs]:
            sd[f"{p}.conv1d{s}.weight"] = _w(rng, din, 1, 4, scale=0.2)
            sd[f"{p}.conv1d{s}.bias"] = _w(rng, din)
            sd[f"{p}.x_proj{s}.weight"] = _w(rng, rank + 2 * d_state, din)
            _lin(sd, rng, f"{p}.dt_proj{s}", din, rank)
            sd[f"{p}.A{s}_log"] = np.log(np.tile(np.arange(
                1, d_state + 1, dtype=np.float32), (din, 1))) + _w(
                rng, din, d_state)
            sd[f"{p}.D{s}"] = _ones(rng, din)
    return sd


def vssm_sd(rng, depths=(2, 2, 15, 2), dims=(128, 256, 512, 1024),
            d_state=1, ssm_ratio=2.0, mlp_ratio=4.0, conv_bias=False,
            disable_z=True, patch_v2=True):
    """VMamba's ``VSSM`` (the defaults: ``vssm1_base``, d_state 1, no z
    branch, no conv bias, the v2 patch embedding); ``dt_rank = ceil(dim /
    16)``, four directions."""
    sd = {}
    if patch_v2:
        half = dims[0] // 2
        sd["patch_embed.0.weight"] = _w(rng, half, 3, 3, 3)
        sd["patch_embed.0.bias"] = _w(rng, half)
        _ln(sd, rng, "patch_embed.2", half)
        sd["patch_embed.5.weight"] = _w(rng, dims[0], half, 3, 3)
        sd["patch_embed.5.bias"] = _w(rng, dims[0])
        _ln(sd, rng, "patch_embed.7", dims[0])
    else:
        sd["patch_embed.0.weight"] = _w(rng, dims[0], 3, 4, 4)
        sd["patch_embed.0.bias"] = _w(rng, dims[0])
        _ln(sd, rng, "patch_embed.2", dims[0])
    _ln(sd, rng, "classifier.norm", dims[-1])
    k = 4
    for s, depth in enumerate(depths):
        dim = dims[s]
        din, rank = int(ssm_ratio * dim), math.ceil(dim / 16)
        hidden = int(dim * mlp_ratio)
        for b in range(depth):
            p = f"layers.{s}.blocks.{b}."
            op = p + "op."
            _ln(sd, rng, p + "norm", dim)
            sd[op + "in_proj.weight"] = _w(rng, din if disable_z else 2 * din,
                                           dim)
            sd[op + "conv2d.weight"] = _w(rng, din, 1, 3, 3, scale=0.2)
            if conv_bias:
                sd[op + "conv2d.bias"] = _w(rng, din)
            sd[op + "x_proj_weight"] = _w(rng, k, rank + 2 * d_state, din)
            sd[op + "dt_projs_weight"] = _w(rng, k, din, rank)
            sd[op + "dt_projs_bias"] = _w(rng, k, din)
            sd[op + "A_logs"] = _w(rng, k * din, d_state)
            sd[op + "Ds"] = _ones(rng, k * din)
            _ln(sd, rng, op + "out_norm", din)
            sd[op + "out_proj.weight"] = _w(rng, dim, din)
            _ln(sd, rng, p + "norm2", dim)
            _lin(sd, rng, p + "mlp.fc1", hidden, dim)
            _lin(sd, rng, p + "mlp.fc2", dim, hidden)
        if s < len(depths) - 1:
            d = f"layers.{s}.downsample."
            sd[d + "1.weight"] = _w(rng, dims[s + 1], dim, 3, 3)
            sd[d + "1.bias"] = _w(rng, dims[s + 1])
            _ln(sd, rng, d + "3", dims[s + 1])
    return sd


def swin_hf_sd(rng, embed_dim=128, depths=(2, 2, 18, 2),
               num_heads=(4, 8, 16, 32), window=7, mlp_ratio=4.0, patch=4):
    """HF ``SwinModel`` (the defaults: Swin-B, window 7); the buffers
    (``relative_position_index``) left out, as the map reads none."""
    sd = {"embeddings.patch_embeddings.projection.weight":
          _w(rng, embed_dim, 3, patch, patch),
          "embeddings.patch_embeddings.projection.bias": _w(rng, embed_dim)}
    _ln(sd, rng, "embeddings.norm", embed_dim)
    for s, depth in enumerate(depths):
        dim = embed_dim * 2 ** s
        hidden = int(dim * mlp_ratio)
        for b in range(depth):
            p = f"encoder.layers.{s}.blocks.{b}."
            _ln(sd, rng, p + "layernorm_before", dim)
            for n in ("query", "key", "value"):
                _lin(sd, rng, p + "attention.self." + n, dim, dim)
            sd[p + "attention.self.relative_position_bias_table"] = _w(
                rng, (2 * window - 1) ** 2, num_heads[s])
            _lin(sd, rng, p + "attention.output.dense", dim, dim)
            _ln(sd, rng, p + "layernorm_after", dim)
            _lin(sd, rng, p + "intermediate.dense", hidden, dim)
            _lin(sd, rng, p + "output.dense", dim, hidden)
        if s < len(depths) - 1:
            p = f"encoder.layers.{s}.downsample."
            _ln(sd, rng, p + "norm", 4 * dim)
            sd[p + "reduction.weight"] = _w(rng, 2 * dim, 4 * dim)
    _ln(sd, rng, "layernorm", embed_dim * 2 ** (len(depths) - 1))
    return sd


def vit_timm_sd(rng, depth=12, dim=768, patch=16, img=224, mlp_ratio=4.0):
    """timm ``vit_base_patch16_224`` (the defaults)."""
    hidden = int(dim * mlp_ratio)
    sd = {"patch_embed.proj.weight": _w(rng, dim, 3, patch, patch),
          "patch_embed.proj.bias": _w(rng, dim),
          "cls_token": _w(rng, 1, 1, dim),
          "pos_embed": _w(rng, 1, (img // patch) ** 2 + 1, dim)}
    for i in range(depth):
        p = f"blocks.{i}."
        _ln(sd, rng, p + "norm1", dim)
        _lin(sd, rng, p + "attn.qkv", 3 * dim, dim)
        _lin(sd, rng, p + "attn.proj", dim, dim)
        _ln(sd, rng, p + "norm2", dim)
        _lin(sd, rng, p + "mlp.fc1", hidden, dim)
        _lin(sd, rng, p + "mlp.fc2", dim, hidden)
    _ln(sd, rng, "norm", dim)
    return sd


def _bert_attention(sd, rng, p, dim, kv_dim):
    _lin(sd, rng, p + "self.query", dim, dim)
    _lin(sd, rng, p + "self.key", dim, kv_dim)
    _lin(sd, rng, p + "self.value", dim, kv_dim)
    _lin(sd, rng, p + "output.dense", dim, dim)
    _ln(sd, rng, p + "output.LayerNorm", dim)


def _bert_ffn(sd, rng, inter, out, dim, hidden):
    _lin(sd, rng, inter + ".dense", hidden, dim)
    _lin(sd, rng, out + ".dense", dim, hidden)
    _ln(sd, rng, out + ".LayerNorm", dim)


def bert_hf_sd(rng, n_layers=12, dim=768, intermediate=3072, vocab=30522,
               max_position=512, type_vocab=2, pooler=True):
    """HF ``BertModel`` (the defaults: bert-base, with its pooler)."""
    sd = {"embeddings.word_embeddings.weight": _w(rng, vocab, dim),
          "embeddings.position_embeddings.weight": _w(rng, max_position, dim),
          "embeddings.token_type_embeddings.weight": _w(rng, type_vocab, dim)}
    _ln(sd, rng, "embeddings.LayerNorm", dim)
    for i in range(n_layers):
        p = f"encoder.layer.{i}."
        _bert_attention(sd, rng, p + "attention.", dim, dim)
        _bert_ffn(sd, rng, p + "intermediate", p + "output", dim,
                  intermediate)
    if pooler:
        _lin(sd, rng, "pooler.dense", dim, dim)
    return sd


def chexbert_sd(rng, **bert):
    """CheXbert's released state dict: ``module.bert.*`` (a ``BertModel``,
    pooler included) and ``module.linear_heads.{0..13}`` (13 of 4 classes,
    one of 2)."""
    sd = {"module.bert." + k: v for k, v in bert_hf_sd(rng, **bert).items()}
    dim = sd["module.bert.embeddings.LayerNorm.weight"].shape[0]
    for i in range(14):
        _lin(sd, rng, f"module.linear_heads.{i}", 4 if i < 13 else 2, dim)
    return sd


def qformer_lavis_sd(rng, n_layers=12, dim=768, intermediate=3072,
                     enc_dim=1408, num_queries=32, cross_freq=2):
    """BLIP-2's Q-Former as LAVIS names it (``blip2_pretrained*.pth``):
    ``Qformer.bert.embeddings.LayerNorm``, the layers' self-attention,
    cross-attention every ``cross_freq`` layers (keys and values from
    ``enc_dim``), the text and query FFNs; ``query_tokens``."""
    sd = {"query_tokens": _w(rng, 1, num_queries, dim)}
    pre = "Qformer.bert."
    _ln(sd, rng, pre + "embeddings.LayerNorm", dim)
    for i in range(n_layers):
        p = f"{pre}encoder.layer.{i}."
        _bert_attention(sd, rng, p + "attention.", dim, dim)
        if i % cross_freq == 0:
            _bert_attention(sd, rng, p + "crossattention.", dim, enc_dim)
        _bert_ffn(sd, rng, p + "intermediate", p + "output", dim,
                  intermediate)
        _bert_ffn(sd, rng, p + "intermediate_query", p + "output_query", dim,
                  intermediate)
    return sd


def hopfield_sd(rng, in_dim=768, hidden=1024, num_heads=6, pattern_dim=768,
                stored_dim=768, out_dim=768, prefix="hopfield.",
                norms=("norm_stored_pattern", "norm_state_pattern",
                       "norm_pattern_projection")):
    """hflayers' ``HopfieldLayer`` (the defaults: AM-MRG's memories, 6 heads
    of 1,024 association and 768 value width): separate q/k/v projection
    weights, one ``in_proj_bias``, ``out_proj``, the named input norms."""
    core = prefix + "association_core."
    nh, nv = num_heads * hidden, num_heads * pattern_dim
    sd = {core + "q_proj_weight": _w(rng, nh, in_dim),
          core + "k_proj_weight": _w(rng, nh, stored_dim),
          core + "v_proj_weight": _w(rng, nv, stored_dim),
          core + "in_proj_bias": _w(rng, 2 * nh + nv)}
    _lin(sd, rng, core + "out_proj", out_dim, nv)
    widths = {"norm_stored_pattern": stored_dim,
              "norm_state_pattern": in_dim,
              "norm_pattern_projection": stored_dim}
    for n in norms:
        _ln(sd, rng, prefix + n, widths[n])
    return sd


def cross_block_sd(rng, dim=768):
    """R2GenKG's ``ResidualCrossAttentionBlock`` (``cross.py``): a fused
    ``in_proj``, ``out_proj``, the MLP's ``c_fc``/``c_proj``, gamma-only
    norms (their zero ``beta`` buffers beside them)."""
    sd = {"attn.in_proj_weight": _w(rng, 3 * dim, dim),
          "attn.in_proj_bias": _w(rng, 3 * dim),
          "ln_1.gamma": _ones(rng, dim), "ln_1.beta": np.zeros(dim, np.float32),
          "ln_2.gamma": _ones(rng, dim), "ln_2.beta": np.zeros(dim, np.float32)}
    _lin(sd, rng, "attn.out_proj", dim, dim)
    _lin(sd, rng, "mlp.c_fc", 4 * dim, dim)
    _lin(sd, rng, "mlp.c_proj", dim, 4 * dim)
    return sd


def r2gen_sd(rng, vocab=761, att_dim=768, d_model=512, d_ff=512,
             num_layers=3, rm_num_slots=3):
    """R2Gen's ``Transformer`` (``encoder_decoder.py``: the encoder and
    decoder stacks, conditional layer norms, the relational memory) and
    ``logit``, with an ``att_embed`` Linear (the defaults: 512 x 3, the
    ViT-B tower's 768 features)."""
    sd = {"tgt_embed.0.lut.weight": _w(rng, vocab, d_model)}
    _lin(sd, rng, "logit", vocab, d_model)
    _lin(sd, rng, "att_embed", d_model, att_dim)

    def ref_ln(name):
        sd[name + ".gamma"] = _ones(rng, d_model)
        sd[name + ".beta"] = _w(rng, d_model)

    def mha(prefix):
        for i in range(4):
            _lin(sd, rng, f"{prefix}.linears.{i}", d_model, d_model)

    ref_ln("encoder.norm")
    ref_ln("decoder.norm")
    mha("rm.attn")
    _lin(sd, rng, "rm.mlp.0", d_model, d_model)
    _lin(sd, rng, "rm.mlp.2", d_model, d_model)
    _lin(sd, rng, "rm.W", 2 * d_model, d_model)
    _lin(sd, rng, "rm.U", 2 * d_model, d_model)
    mem = rm_num_slots * d_model
    for i in range(num_layers):
        e = f"encoder.layers.{i}"
        mha(f"{e}.self_attn")
        _lin(sd, rng, f"{e}.feed_forward.w_1", d_ff, d_model)
        _lin(sd, rng, f"{e}.feed_forward.w_2", d_model, d_ff)
        ref_ln(f"{e}.sublayer.0.norm")
        ref_ln(f"{e}.sublayer.1.norm")
        d = f"decoder.layers.{i}"
        mha(f"{d}.self_attn")
        mha(f"{d}.src_attn")
        _lin(sd, rng, f"{d}.feed_forward.w_1", d_ff, d_model)
        _lin(sd, rng, f"{d}.feed_forward.w_2", d_model, d_ff)
        for k in range(3):
            c = f"{d}.sublayer.{k}.norm"
            ref_ln(c)
            for g in ("gamma", "beta"):
                _lin(sd, rng, f"{c}.mlp_{g}.0", d_model, mem)
                _lin(sd, rng, f"{c}.mlp_{g}.2", d_model, d_model)
    return sd


def save_pth(path, sd: dict, wrap: str | None = None) -> int:
    """``torch.save`` ``sd`` as tensors, bare or under ``wrap`` beside the
    non-tensor entries of a released file (an ``argparse.Namespace`` of
    ``args``, an epoch, an optimizer's state); returns the tensor bytes."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in sd.items()}
    obj = tensors if wrap is None else {
        wrap: tensors, "epoch": 3,
        "args": argparse.Namespace(model="ref", lr=1e-4, input_size=224),
        "optimizer": {"state": {}, "param_groups": [
            {"lr": 1e-4, "betas": (0.9, 0.999), "params": [0, 1]}]}}
    torch.save(obj, path)
    return sum(t.numel() * t.element_size() for t in tensors.values())
