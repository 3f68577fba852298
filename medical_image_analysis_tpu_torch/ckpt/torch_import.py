"""The reference's PyTorch and HF checkpoints, mapped onto the port's towers
and heads.

Counterpart of ``medical_image_analysis_tpu/ckpt/torch_import.py``: the same
functions, names and signatures, in numpy. Each map takes a state dict of
numpy arrays in its source's layout and returns ``{"params": tree}``, a
flax-layout tree of numpy arrays equal, leaf for leaf, to the JAX map's;
``ckpt/from_jax.py:load_jax_params`` loads it strictly into the port's
module, which puts each leaf in the port's layout. The reference's four
surgeries: prefix stripping (:func:`strip_prefix`), one-direction ->
four-direction Mamba weights (:func:`replicate_dir_weights`), position
embeddings resized (:func:`interpolate_pos_embed`), and the key maps.

The Llama/Qwen map is ``ckpt/hf_load.py:llm_key_map``, not repeated here.
"""

from __future__ import annotations

import argparse
from typing import Mapping

import numpy as np
import torch

# The non-tensor entries that the reference's released files carry beside
# their weights: MAE's ``args`` (an ``argparse.Namespace``). Optimizer and
# scaler blobs are dicts, lists and numbers, which ``weights_only`` allows.
SAFE_GLOBALS = (argparse.Namespace,)

# The keys that wrap a state dict in a released file: MAE's ``model``,
# Lightning's ``state_dict``, DeepSpeed's ``module`` and CheXbert's
# ``model_state_dict`` (the last one the JAX function does not unwrap).
_WRAPPERS = ("model", "state_dict", "module", "model_state_dict")


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return v


def load_torch_state_dict(path: str) -> dict:
    """The state dict of a ``torch.save`` file, tensors as numpy arrays.
    The file is read with ``weights_only=True``, allowing only
    :data:`SAFE_GLOBALS` beside tensors and containers; a file that holds
    anything else is refused by ``torch.load``."""
    with torch.serialization.safe_globals(list(SAFE_GLOBALS)):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in _WRAPPERS:
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    return {k: _np(v) for k, v in obj.items()}


def strip_prefix(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    """Only the keys under ``prefix``, without it."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel at a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize(..., "bicubic")`` along
    one axis: half-pixel centres, the kernel widened by the scale when it
    shrinks (antialiasing), each column renormalised to sum to 1, and
    columns whose sample falls outside the input zeroed."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv = np.float32(1.0) / scale
    kernel_scale = max(inv, np.float32(1.0))
    sample = ((np.arange(n_out, dtype=np.float32) + 0.5) * inv - 0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = _keys_cubic(x / kernel_scale).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def interpolate_pos_embed(pos: np.ndarray, new_len: int,
                          num_extra: int = 1) -> np.ndarray:
    """Resize a (1, num_extra + L_old, D) position embedding to ``new_len``
    grid tokens, the extra (cls) tokens kept as they are. The grid is
    resized as ``jax.image.resize(..., "bicubic")`` does it (Keys' kernel
    at a = -0.5, renormalised at the edges, antialiased when it shrinks),
    which ``F.interpolate(mode="bicubic")`` (a = -0.75, clamped edges)
    does not reproduce: separable weight matrices in numpy."""
    pos = np.asarray(pos)
    extra = pos[:, :num_extra]
    grid_old = int(round((pos.shape[1] - num_extra) ** 0.5))
    grid_new = int(round(new_len ** 0.5))
    body = pos[:, num_extra:].reshape(grid_old, grid_old, -1)
    w = _resize_weights(grid_old, grid_new).astype(pos.dtype)
    body = np.einsum("hwd,hi,wj->ijd", body, w, w)
    return np.concatenate(
        [extra, body.reshape(1, grid_new * grid_new, -1)], axis=1)


def _t(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).T)


def _conv(a) -> np.ndarray:
    """torch OIHW -> flax HWIO."""
    return np.ascontiguousarray(np.asarray(a).transpose(2, 3, 1, 0))


def vit_torch_to_flax(sd: Mapping[str, np.ndarray], depth: int,
                      final_norm: bool = False) -> dict:
    """A timm-layout ViT (``patch_embed.proj``, ``cls_token``,
    ``pos_embed``, ``blocks.N.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
    mlp.fc2}``, ``norm``) -> the ``ViT``'s tree, its first ``depth``
    blocks. A missing qkv bias maps to zeros."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    d = sd["cls_token"].shape[-1]
    out: dict = {
        "patch_embed": {"proj": {"kernel": _conv(sd["patch_embed.proj.weight"]),
                                 "bias": sd["patch_embed.proj.bias"]}},
        "cls_token": sd["cls_token"],
        "pos_embed": sd["pos_embed"],
    }
    for i in range(depth):
        p = f"blocks.{i}."
        out[f"block{i}"] = {
            "ln1_scale": sd[p + "norm1.weight"],
            "ln1_bias": sd[p + "norm1.bias"],
            "qkv_kernel": sd[p + "attn.qkv.weight"].T,
            "qkv_bias": sd.get(p + "attn.qkv.bias",
                               np.zeros(3 * d, np.float32)),
            "proj_kernel": sd[p + "attn.proj.weight"].T,
            "proj_bias": sd[p + "attn.proj.bias"],
            "ln2_scale": sd[p + "norm2.weight"],
            "ln2_bias": sd[p + "norm2.bias"],
            "fc1_kernel": sd[p + "mlp.fc1.weight"].T,
            "fc1_bias": sd[p + "mlp.fc1.bias"],
            "fc2_kernel": sd[p + "mlp.fc2.weight"].T,
            "fc2_bias": sd[p + "mlp.fc2.bias"],
        }
    if final_norm:
        out["norm"] = {"scale": sd["norm.weight"], "bias": sd["norm.bias"]}
    return {"params": _arrays(out)}


_DIR_STEMS = ("conv1d", "x_proj", "dt_proj", "A_log", "D")


def replicate_dir_weights(sd: Mapping[str, np.ndarray]) -> dict:
    """Stage 1 -> stage 2: each one-direction Mamba tensor (``conv1d.*``,
    ``x_proj.*``, ``dt_proj.*``, ``A_log``, ``D``) copied into its ``_b``,
    ``_c`` and ``_c_b`` twins (``A_b_log``, ... for ``A_log``) where they
    are absent."""
    out = dict(sd)
    for k, v in sd.items():
        parts = k.split(".")
        for i, p in enumerate(parts):
            if p in _DIR_STEMS:
                for suffix in ("_b", "_c", "_c_b"):
                    twin = f"A{suffix}_log" if p == "A_log" else p + suffix
                    out.setdefault(".".join(parts[:i] + [twin]
                                            + parts[i + 1:]), v)
                break
    return out


def swin_hf_to_flax(sd: Mapping[str, np.ndarray], depths: list[int]) -> dict:
    """An HF ``SwinModel`` (microsoft/swin-base-patch4-window7-224, the
    frozen tower of R2GenCSR and R2GenKG) -> the ``SwinTransformer``'s
    tree: q, k and v joined into ``qkv``, and each patch merge's 4C inputs
    reordered from HF's (0,0), (1,0), (0,1), (1,1) neighbours to the
    port's (0,0), (0,1), (1,0), (1,1)."""
    params = {
        "patch_embed": {
            "kernel": _conv(sd["embeddings.patch_embeddings.projection.weight"]),
            "bias": sd["embeddings.patch_embeddings.projection.bias"],
        },
        "patch_embed_norm": _norm(sd, "embeddings.norm"),
        "norm": _norm(sd, "layernorm"),
    }
    for s, depth in enumerate(depths):
        for blk in range(depth):
            p = f"encoder.layers.{s}.blocks.{blk}."
            a = p + "attention.self."
            params[f"stage{s}_block{blk}"] = {
                "norm1": _norm(sd, p + "layernorm_before"),
                "attn": {
                    "qkv": {
                        "kernel": np.concatenate(
                            [_t(sd[a + n + ".weight"])
                             for n in ("query", "key", "value")], axis=1),
                        "bias": np.concatenate(
                            [sd[a + n + ".bias"]
                             for n in ("query", "key", "value")]),
                    },
                    "relative_position_bias_table":
                        sd[a + "relative_position_bias_table"],
                    "proj": _dense(sd, p + "attention.output.dense"),
                },
                "norm2": _norm(sd, p + "layernorm_after"),
                "mlp": {"fc1": _dense(sd, p + "intermediate.dense"),
                        "fc2": _dense(sd, p + "output.dense")},
            }
        if s < len(depths) - 1:
            p = f"encoder.layers.{s}.downsample."
            c = sd[p + "norm.weight"].shape[0] // 4
            perm = np.concatenate([np.arange(c), 2 * c + np.arange(c),
                                   c + np.arange(c), 3 * c + np.arange(c)])
            params[f"merge{s}"] = {
                "norm": {"scale": sd[p + "norm.weight"][perm],
                         "bias": sd[p + "norm.bias"][perm]},
                "reduction": {"kernel": _t(sd[p + "reduction.weight"])[perm]},
            }
    return {"params": _arrays(params)}


_DIR_SUFFIXES = ("", "_b", "_c", "_c_b")


def arm_torch_to_flax(sd: Mapping[str, np.ndarray], depth: int) -> dict:
    """The reference ARM (bimamba v3: ``conv1d``, ``x_proj``, ``dt_proj``,
    ``A_log``, ``D`` with ``''``, ``_b``, ``_c``, ``_c_b`` twins) -> the
    ``ARM``'s tree, the four directions stacked on a leading axis. A
    stage-1 file goes through :func:`replicate_dir_weights` first."""

    def stack(prefix, fmt, transform):
        return np.stack([transform(sd[f"{prefix}.{fmt.format(s=s)}"])
                         for s in _DIR_SUFFIXES])

    params = {
        "patch_embed": {"proj": {"kernel": _conv(sd["patch_embed.proj.weight"]),
                                 "bias": sd["patch_embed.proj.bias"]}},
        "cls_token": sd["cls_token"],
        "pos_embed": sd["pos_embed"],
        "norm_f": _norm(sd, "norm_f"),
    }
    for i in range(depth):
        p = f"layers.{i}.mixer"
        layer = {
            "norm": {"scale": sd[f"layers.{i}.norm.weight"]},
            "mixer": {
                "in_proj": {"kernel": _t(sd[f"{p}.in_proj.weight"])},
                "out_proj": {"kernel": _t(sd[f"{p}.out_proj.weight"])},
                # torch conv1d (d_inner, 1, K) -> (K, d_inner) a direction
                "conv_w": stack(p, "conv1d{s}.weight",
                                lambda w: np.asarray(w)[:, 0, :].T),
                "conv_b": stack(p, "conv1d{s}.bias", np.asarray),
                "x_proj_w": stack(p, "x_proj{s}.weight", np.asarray),
                "dt_proj_w": stack(p, "dt_proj{s}.weight", np.asarray),
                "dt_bias": stack(p, "dt_proj{s}.bias", np.asarray),
                "A_log": stack(p, "A{s}_log", np.asarray),
                "D": stack(p, "D{s}", np.asarray),
            },
        }
        if f"layers.{i}.norm.bias" in sd:  # the LayerNorm variant
            layer["norm"]["bias"] = sd[f"layers.{i}.norm.bias"]
        params[f"layers_{i}"] = layer
    return {"params": _arrays(params)}


def vssm_torch_to_flax(sd: Mapping[str, np.ndarray], depths: list[int],
                       mlp: bool = True) -> dict:
    """The reference VMamba ``VSSM`` (the v1 or v2 patch embedding, the v3
    downsample, SS2D's stacked ``x_proj_weight``, ``dt_projs_*``,
    ``A_logs``, ``Ds``) -> the ``VSSM``'s tree."""
    params = {
        "patch_embed": {"kernel": _conv(sd["patch_embed.0.weight"]),
                        "bias": sd["patch_embed.0.bias"]},
        "patch_norm": _norm(sd, "patch_embed.2"),
        "norm": _norm(sd, "classifier.norm"),
    }
    if "patch_embed.5.weight" in sd:
        # the v2 embedding: [conv, Permute, norm, Permute, GELU, conv,
        # Permute, norm]
        params["patch_embed2"] = {"kernel": _conv(sd["patch_embed.5.weight"]),
                                  "bias": sd["patch_embed.5.bias"]}
        params["patch_norm2"] = _norm(sd, "patch_embed.7")
    for s, depth in enumerate(depths):
        for b in range(depth):
            p = f"layers.{s}.blocks.{b}."
            op = p + "op."
            k_din, n = sd[op + "A_logs"].shape
            k = sd[op + "x_proj_weight"].shape[0]
            din = k_din // k
            conv = {"kernel": _conv(sd[op + "conv2d.weight"])}
            if op + "conv2d.bias" in sd:
                conv["bias"] = sd[op + "conv2d.bias"]
            block = {
                "norm": _norm(sd, p + "norm"),
                "op": {
                    "in_proj": {"kernel": _t(sd[op + "in_proj.weight"])},
                    "conv2d": conv,
                    "x_proj_w": sd[op + "x_proj_weight"],
                    "dt_proj_w": sd[op + "dt_projs_weight"],
                    "dt_bias": sd[op + "dt_projs_bias"],
                    "A_log": sd[op + "A_logs"].reshape(k, din, n),
                    "D": sd[op + "Ds"].reshape(k, din),
                    "out_norm": _norm(sd, op + "out_norm"),
                    "out_proj": {"kernel": _t(sd[op + "out_proj.weight"])},
                },
            }
            if mlp and p + "norm2.weight" in sd:
                block["norm2"] = _norm(sd, p + "norm2")
                block["mlp"] = {"fc1": _dense(sd, p + "mlp.fc1"),
                                "fc2": _dense(sd, p + "mlp.fc2")}
            params[f"stage{s}_block{b}"] = block
        if s < len(depths) - 1:
            d = f"layers.{s}.downsample."
            params[f"downsample{s}"] = {"kernel": _conv(sd[d + "1.weight"]),
                                        "bias": sd[d + "1.bias"]}
            params[f"downsample_norm{s}"] = _norm(sd, d + "3")
    return {"params": _arrays(params)}


def _dense(sd, name):
    return {"kernel": _t(sd[name + ".weight"]), "bias": sd[name + ".bias"]}


def _norm(sd, name):
    return {"scale": sd[name + ".weight"], "bias": sd[name + ".bias"]}


def _bert_attention(sd, p):
    return {
        "query": _dense(sd, p + "self.query"),
        "key": _dense(sd, p + "self.key"),
        "value": _dense(sd, p + "self.value"),
        "out": _dense(sd, p + "output.dense"),
        "out_norm": _norm(sd, p + "output.LayerNorm"),
    }


def bert_hf_to_flax(sd: Mapping[str, np.ndarray], n_layers: int) -> dict:
    """An HF ``BertModel`` (Bio_ClinicalBERT, any bert-base) -> the
    ``BertModel``'s tree; ``pooler`` where the file has one (build the
    module with ``pooler=True`` to load it)."""
    params = {
        "word_embeddings": {
            "embedding": sd["embeddings.word_embeddings.weight"]},
        "position_embeddings": sd["embeddings.position_embeddings.weight"],
        "token_type_embeddings": {
            "embedding": sd["embeddings.token_type_embeddings.weight"]},
        "embeddings_norm": _norm(sd, "embeddings.LayerNorm"),
    }
    if "pooler.dense.weight" in sd:
        params["pooler"] = _dense(sd, "pooler.dense")
    for i in range(n_layers):
        p = f"encoder.layer.{i}."
        params[f"layer_{i}"] = {
            "attention": _bert_attention(sd, p + "attention."),
            "ffn": {"dense_in": _dense(sd, p + "intermediate.dense"),
                    "dense_out": _dense(sd, p + "output.dense"),
                    "norm": _norm(sd, p + "output.LayerNorm")},
        }
    return {"params": _arrays(params)}


def blip2_qformer_to_flax(sd: Mapping[str, np.ndarray], n_layers: int,
                          cross_attention_freq: int = 2) -> dict:
    """BLIP-2 Q-Former weights, HF ``Blip2QFormerModel`` names or the
    LAVIS ones of the reference's ``blip2_pretrained_flant5xxl.pth``
    (``Qformer.bert.encoder.layer.i.attention.self.query``,
    ``bert.embeddings.LayerNorm``) -> the ``BertModel``'s tree under a
    ``Blip2QFormer`` (``bert``); ``query_tokens`` is the caller's. A
    layer's text FFN maps where the file has it (build the module with
    ``text_ffn=True`` to load it)."""
    norm = {}
    for k, v in sd.items():
        for pre in ("Qformer.bert.", "bert.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
        k = k.replace(".attention.attention.", ".attention.self.")
        k = k.replace(".crossattention.attention.", ".crossattention.self.")
        norm[k.replace("embeddings.LayerNorm", "layernorm")] = v
    sd = norm
    params = {"embeddings_norm": _norm(sd, "layernorm")}
    for i in range(n_layers):
        p = f"encoder.layer.{i}."
        layer = {
            "attention": _bert_attention(sd, p + "attention."),
            "ffn_query": {
                "dense_in": _dense(sd, p + "intermediate_query.dense"),
                "dense_out": _dense(sd, p + "output_query.dense"),
                "norm": _norm(sd, p + "output_query.LayerNorm"),
            },
        }
        if p + "crossattention.self.query.weight" in sd:
            layer["crossattention"] = _bert_attention(sd, p + "crossattention.")
        if p + "intermediate.dense.weight" in sd:
            layer["ffn"] = {"dense_in": _dense(sd, p + "intermediate.dense"),
                            "dense_out": _dense(sd, p + "output.dense"),
                            "norm": _norm(sd, p + "output.LayerNorm")}
        params[f"layer_{i}"] = layer
    return {"params": _arrays(params)}


def _arrays(tree):
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    return np.asarray(tree)


def r2gen_torch_to_flax(sd: Mapping[str, np.ndarray], num_layers: int) -> dict:
    """The reference R2Gen Transformer and ``logit`` (``encoder.*``,
    ``decoder.*``, ``tgt_embed.0.lut.weight``, ``rm.*``, ``logit.*``;
    ``RG_english/modules/encoder_decoder.py``) -> the ``R2Gen``'s tree, fp32.
    ``att_embed`` maps where the file has it, else the identity."""

    def f32(name):
        return np.asarray(sd[name], np.float32)

    def lin(name):
        return {"kernel": _t(f32(name + ".weight")), "bias": f32(name + ".bias")}

    def mha(prefix):
        return {n: lin(f"{prefix}.linears.{i}")
                for i, n in enumerate(("q", "k", "v", "o"))}

    def ref_ln(prefix):
        return {"gamma": f32(prefix + ".gamma"), "beta": f32(prefix + ".beta")}

    d_model = np.asarray(sd["tgt_embed.0.lut.weight"]).shape[1]
    params: dict = {
        "embed": {"embedding": f32("tgt_embed.0.lut.weight")},
        "logit": lin("logit"),
        "enc_norm": ref_ln("encoder.norm"),
        "dec_norm": ref_ln("decoder.norm"),
        "rm": {
            "attn_q": lin("rm.attn.linears.0"),
            "attn_k": lin("rm.attn.linears.1"),
            "attn_v": lin("rm.attn.linears.2"),
            "attn_o": lin("rm.attn.linears.3"),
            "mlp1": lin("rm.mlp.0"),
            "mlp2": lin("rm.mlp.2"),
            "w_gate": lin("rm.W"),
            "u_gate": lin("rm.U"),
        },
        "att_embed": (lin("att_embed") if "att_embed.weight" in sd else
                      {"kernel": np.eye(d_model, dtype=np.float32),
                       "bias": np.zeros(d_model, np.float32)}),
    }
    for i in range(num_layers):
        e = f"encoder.layers.{i}"
        params[f"enc_attn{i}"] = mha(f"{e}.self_attn")
        params[f"enc_ff{i}a"] = lin(f"{e}.feed_forward.w_1")
        params[f"enc_ff{i}b"] = lin(f"{e}.feed_forward.w_2")
        params[f"enc_ln{2 * i}"] = ref_ln(f"{e}.sublayer.0.norm")
        params[f"enc_ln{2 * i + 1}"] = ref_ln(f"{e}.sublayer.1.norm")
        d = f"decoder.layers.{i}"
        params[f"dec_self{i}"] = mha(f"{d}.self_attn")
        params[f"dec_cross{i}"] = mha(f"{d}.src_attn")
        params[f"dec_ff{i}a"] = lin(f"{d}.feed_forward.w_1")
        params[f"dec_ff{i}b"] = lin(f"{d}.feed_forward.w_2")
        for k in range(3):
            c = f"{d}.sublayer.{k}.norm"
            params[f"dec_cln{3 * i + k}"] = {
                **ref_ln(c),
                "delta_gamma": lin(f"{c}.mlp_gamma.0"),
                "delta_gamma2": lin(f"{c}.mlp_gamma.2"),
                "delta_beta": lin(f"{c}.mlp_beta.0"),
                "delta_beta2": lin(f"{c}.mlp_beta.2"),
            }
    return {"params": _arrays(params)}


_HOPFIELD_NORMS = (("norm_stored_pattern", "norm_stored"),
                   ("norm_state_pattern", "norm_state"),
                   ("norm_pattern_projection", "norm_pattern"))


def hopfield_torch_to_flax(sd: Mapping[str, np.ndarray],
                           prefix: str = "hopfield.") -> dict:
    """An hflayers ``Hopfield``/``HopfieldLayer`` (AM-MRG's vendored
    library: the association core's separate q/k/v projections, one
    ``in_proj_bias``, the input LayerNorms) -> the ``Hopfield``'s tree.
    The norms map where the file has them: build the module with the
    matching ``norm_*`` switches."""

    def f32(name):
        return np.asarray(sd[name], np.float32)

    core = prefix + "association_core."
    qw, kw, vw = (_t(f32(core + n + "_proj_weight")) for n in ("q", "k", "v"))
    nhd = qw.shape[1]  # heads x head width
    bias = f32(core + "in_proj_bias")
    params = {
        "q_proj": {"kernel": qw, "bias": bias[:nhd]},
        "k_proj": {"kernel": kw, "bias": bias[nhd:2 * nhd]},
        "v_proj": {"kernel": vw, "bias": bias[2 * nhd:]},
        "out_proj": {"kernel": _t(f32(core + "out_proj.weight")),
                     "bias": f32(core + "out_proj.bias")},
    }
    for theirs, ours in _HOPFIELD_NORMS:
        if prefix + theirs + ".weight" in sd:
            params[ours] = {"scale": f32(prefix + theirs + ".weight"),
                            "bias": f32(prefix + theirs + ".bias")}
    return {"params": _arrays(params)}


def cross_block_torch_to_flax(sd: Mapping[str, np.ndarray]) -> dict:
    """R2GenKG's ``ResidualCrossAttentionBlock`` (``cross.py``: an
    ``nn.MultiheadAttention`` with a fused ``in_proj``, a CLIP-style MLP,
    gamma-only norms) -> the ``ResidualCrossAttentionBlock``'s tree."""

    def f32(name):
        return np.asarray(sd[name], np.float32)

    w, b = f32("attn.in_proj_weight"), f32("attn.in_proj_bias")
    d = w.shape[0] // 3
    params = {n: {"kernel": _t(w[i * d:(i + 1) * d]), "bias": b[i * d:(i + 1) * d]}
              for i, n in enumerate(("q", "k", "v"))}
    params["proj"] = {"kernel": _t(f32("attn.out_proj.weight")),
                      "bias": f32("attn.out_proj.bias")}
    params["mlp_in"] = {"kernel": _t(f32("mlp.c_fc.weight")),
                        "bias": f32("mlp.c_fc.bias")}
    params["mlp_out"] = {"kernel": _t(f32("mlp.c_proj.weight")),
                         "bias": f32("mlp.c_proj.bias")}
    params["ln_1"] = {"scale": f32("ln_1.gamma")}
    params["ln_2"] = {"scale": f32("ln_2.gamma")}
    return {"params": _arrays(params)}
