"""HF Llama/Qwen2 checkpoints (safetensors) into the port's LLM, bf16 or int8.

Counterpart of ``medical_image_analysis_tpu/ckpt/hf_load.py``:

- :func:`read_hf_config`: HF ``config.json`` -> :class:`LLMConfig` (Llama
  and Qwen2, with Qwen's q/k/v biases and tied embeddings);
- :func:`_quantize`: per-output-column symmetric int8, ``w ~ q * scale``,
  bit for bit what the JAX package computes in numpy, on any device;
- :func:`load_llm_params`: streams the tensors one at a time out of the
  shards (``ckpt/safetensors.py``, the port's own reader) into a built
  ``TransformerLM``'s own parameters, on the model's device, in place: no
  second copy of the LLM and no state dict in host RAM. The key map is
  :func:`llm_key_map`, the JAX loader's (the JAX package's
  ``ckpt.torch_import.llama_hf_to_flax`` plus Qwen2's biases; ``lm_head``
  only when untied and present in the files).

The stored dtypes are the JAX loader's: kernels and the embedding in the
model dtype (``lm_head`` too: a bf16 weight in the fp32 head, cast a piece
at a time where it is used, ``models.llm.chunked_linear``), norm scales
fp32, biases fp32 under int8 and the model dtype otherwise; under int8
every Dense kernel, ``lm_head`` included, becomes ``kernel_q`` (int8) and
``scale`` (fp32). The port's kernels are in the Linear layout (out, in),
which is the HF layout; the flax kernel is its transpose.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from ..models.llm import LLMConfig
from .safetensors import SafetensorsIndex


def read_hf_config(model_dir: str, **overrides) -> LLMConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        hc = json.load(f)
    arch = (hc.get("architectures") or ["LlamaForCausalLM"])[0].lower()
    kw: dict[str, Any] = dict(
        vocab_size=hc["vocab_size"],
        dim=hc["hidden_size"],
        n_layers=hc["num_hidden_layers"],
        n_heads=hc["num_attention_heads"],
        n_kv_heads=hc.get("num_key_value_heads", hc["num_attention_heads"]),
        hidden_dim=hc["intermediate_size"],
        rope_theta=hc.get("rope_theta", 10000.0),
        norm_eps=hc.get("rms_norm_eps", 1e-5),
        tie_embeddings=hc.get("tie_word_embeddings", False),
        attn_bias="qwen2" in arch or hc.get("attention_bias", False),
    )
    kw.update(overrides)
    return LLMConfig(**kw)


def _quantize(w) -> dict:
    """Per-output-column symmetric int8 of a flax (in, out) kernel ``w``
    (a torch tensor, on any device): ``{"kernel_q": int8 (in, out),
    "scale": fp32 (out,)}``, equal bit for bit to the JAX package's numpy
    (fp32 division and round-half-to-even on both sides)."""
    w32 = torch.as_tensor(w).float()
    # a device tensor, not a Python number: CUDA divides by a host scalar
    # as a product with its reciprocal, one bit off numpy's quotient
    denom = torch.tensor(127.0, device=w32.device)
    scale = w32.abs().amax(dim=0).clamp_min(1e-8) / denom
    q = torch.round(w32 / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return {"kernel_q": q, "scale": scale}


def llm_key_map(cfg: LLMConfig, names) -> dict[str, tuple[str, str]]:
    """flax path under the LLM (Dense kernels without their leaf) -> (HF
    tensor name, kind): ``kernel``, ``embedding``, ``scale`` (a norm) or
    ``bias``. ``names`` are the checkpoint's tensor names."""
    out = {"embed_tokens/embedding": ("model.embed_tokens.weight",
                                      "embedding"),
           "norm/scale": ("model.norm.weight", "scale")}
    if not cfg.tie_embeddings and "lm_head.weight" in names:
        out["lm_head"] = ("lm_head.weight", "kernel")
    for i in range(cfg.n_layers):
        p, f = f"model.layers.{i}.", f"layers_{i}/"
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[f"{f}self_attn/{proj}"] = (f"{p}self_attn.{proj}.weight",
                                           "kernel")
        if cfg.attn_bias:
            for proj in ("q_proj", "k_proj", "v_proj"):
                name = f"{p}self_attn.{proj}.bias"
                if name in names:
                    out[f"{f}self_attn/{proj}/bias"] = (name, "bias")
        for proj in ("gate_proj", "up_proj", "down_proj"):
            out[f"{f}mlp/{proj}"] = (f"{p}mlp.{proj}.weight", "kernel")
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[f"{f}{norm}/scale"] = (f"{p}{norm}.weight", "scale")
    return out


@torch.no_grad()
def _put(named: dict, name: str, value: torch.Tensor, dtype) -> None:
    """Copy ``value`` into the parameter ``name``, stored in ``dtype`` (its
    storage replaced where its dtype differs)."""
    if name not in named:
        raise KeyError(f"{name} not in the target model")
    p = named[name]
    if tuple(p.shape) != tuple(value.shape):
        raise ValueError(f"{name}: shape {tuple(value.shape)} does not match "
                         f"target {tuple(p.shape)}")
    if p.dtype != dtype:
        p.data = torch.empty(p.shape, dtype=dtype, device=p.device)
    p.copy_(value)


def load_llm_params(model_dir: str, lm, mesh=None,
                    strict: bool = True) -> list[str]:
    """Stream an HF Llama/Qwen2 checkpoint into ``lm`` (a ``TransformerLM``
    or EMRRG's hybrid one) in place; returns the flax names written.

    ``lm.cfg.quant_int8`` quantises every Dense kernel into the model's
    ``QuantDense`` layers; ``lm.cfg.dtype`` is the stored dtype of the
    kernels, the embedding and (without int8) the biases. ``strict``: every tensor of ``lm`` must
    be written (the JAX splice replaces the whole LLM subtree); EMRRG's
    graft passes False and its hybrid-only tensors keep their values.
    """
    if mesh is not None:
        raise NotImplementedError(
            "load_llm_params(mesh=...): tensor-parallel placement is not "
            "ported yet (ROADMAP.md, queue 1, item 18)")
    from .from_jax import flax_named_parameters

    cfg = lm.cfg
    int8, dtype = cfg.quant_int8, cfg.dtype
    named = flax_named_parameters(lm)
    device = next(iter(named.values())).device
    sd = SafetensorsIndex(model_dir)
    written = []
    try:
        for path, (hf, kind) in llm_key_map(cfg, sd).items():
            t = sd.tensor(hf, device)
            if kind == "kernel" and int8:
                qs = _quantize(t.T)
                _put(named, f"{path}/kernel_q", qs["kernel_q"].T, torch.int8)
                _put(named, f"{path}/scale", qs["scale"], torch.float32)
                written += [f"{path}/kernel_q", f"{path}/scale"]
                continue
            if kind == "kernel":
                path, to = f"{path}/kernel", dtype
            elif kind == "bias":
                to = torch.float32 if int8 else dtype
            else:
                to = dtype if kind == "embedding" else torch.float32
            _put(named, path, t, to)
            written.append(path)
            del t
    finally:
        sd.close()
    missing = sorted(set(named) - set(written))
    if strict and missing:
        raise KeyError(f"the checkpoint at {model_dir} has no tensor for "
                       f"{missing[:5]} ({len(missing)} in all)")
    return written
