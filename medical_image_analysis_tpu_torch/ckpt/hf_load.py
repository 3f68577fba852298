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
  only when untied and present in the files). With ``mesh``, the LLM is
  cut for tensor parallelism first (``parallel.tp.shard_llm``) and each
  rank reads only its slices of the files: the column-parallel kernels'
  rows (their biases, and under int8 their ``kernel_q`` rows and
  ``scale``, quantised from those rows alone: a row's scale needs only the
  row), the row-parallel kernels' columns, the embedding's feature
  columns. A row-parallel int8 kernel is read whole: its per-output
  ``scale`` takes the maximum over every input column; the rank then keeps
  its columns of ``kernel_q``.

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
from ..parallel.tp import shard_llm, tp_slice
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
    or EMRRG's hybrid one) in place; returns the flax names written. With
    ``mesh`` (a (data, model) grid), ``lm`` is cut over the model axis
    (where :func:`..parallel.tp.shard_llm` has not cut it yet) and this
    rank reads its slices alone; ``lm.bytes_read`` is the bytes read.

    ``lm.cfg.quant_int8`` quantises every Dense kernel into the model's
    ``QuantDense`` layers; ``lm.cfg.dtype`` is the stored dtype of the
    kernels, the embedding and (without int8) the biases. ``strict``: every tensor of ``lm`` must
    be written (the JAX splice replaces the whole LLM subtree); EMRRG's
    graft passes False and its hybrid-only tensors keep their values.
    """
    from .from_jax import flax_named_parameters

    cut = {}
    if mesh is not None:
        cut = getattr(lm, "tp_cut", None)
        if cut is None:
            cut = shard_llm(lm, mesh)
    m = 1 if mesh is None else mesh.size("model")
    i = 0 if mesh is None else mesh.index("model")

    def part(name):
        how = cut.get(name)
        return None if how is None else (how[0], m, i, how[1])

    cfg = lm.cfg
    int8, dtype = cfg.quant_int8, cfg.dtype
    named = flax_named_parameters(lm)
    device = next(iter(named.values())).device
    sd = SafetensorsIndex(model_dir)
    written = []
    try:
        for path, (hf, kind) in llm_key_map(cfg, sd).items():
            if kind == "kernel" and int8:
                how = part(f"{path}/kernel_q")
                row_cut = how is not None and how[0] == 1
                # a row-parallel layer's scale needs every input column
                t = sd.tensor(hf, device, None if row_cut else how)
                qs = _quantize(t.T)
                q = qs["kernel_q"].T
                if row_cut:
                    q = tp_slice(q, *how)
                _put(named, f"{path}/kernel_q", q, torch.int8)
                _put(named, f"{path}/scale", qs["scale"], torch.float32)
                written += [f"{path}/kernel_q", f"{path}/scale"]
                continue
            if kind == "kernel":
                path, to = f"{path}/kernel", dtype
            elif kind == "bias":
                to = torch.float32 if int8 else dtype
            else:
                to = dtype if kind == "embedding" else torch.float32
            _put(named, path, sd.tensor(hf, device, part(path)), to)
            written.append(path)
    finally:
        lm.bytes_read = sd.bytes_read
        sd.close()
    missing = sorted(set(named) - set(written))
    if strict and missing:
        raise KeyError(f"the checkpoint at {model_dir} has no tensor for "
                       f"{missing[:5]} ({len(missing)} in all)")
    return written
