"""Carry the JAX package's parameters into the port.

The port's modules use the flax modules' names, so the mapping is by
name, with these conversions:

- ``layers_<i>`` (flax lists) -> ``layers.<i>`` (``nn.ModuleList``);
- Dense ``kernel (in, out)`` -> Linear ``weight (out, in)``;
- Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW (the SS2D depthwise
  conv: (3, 3, 1, D) -> (D, 1, 3, 3));
- flax ``DenseGeneral`` kernels of ``nn.SelfAttention`` (R2GenKG's
  fusion) -> Linear ``weight``: ``query``/``key``/``value`` (D, H, hd)
  with biases (H, hd) flattened over the heads, ``out`` (H, hd, D);
- norm ``scale`` and Embed ``embedding`` -> ``weight``;
- ``QuantDense`` (``LLMConfig.quant_int8``): ``kernel_q`` (in, out) int8 ->
  ``kernel_q`` (out, in), transposed like a Dense kernel; its ``scale``
  keeps its name and layout;
- ``A_log``, ``D``, ``dt_bias``, ``conv_w``, ``conv_b``, ``x_proj_w``,
  ``dt_proj_w``, ``cls_token``, ``pos_embed``, ``pos_marker``,
  ``neg_marker``, and the heads' raw parameters (``query_tokens``,
  ``lookup_weights``, ``pooling_queries``, the R-GCN's ``w1_rel``,
  ``w1_self``, ``w2_rel``, ``w2_self``, the fusion's ``scale_embed``)
  keep their layout.

The MAE needs no rule of its own: its blocks are modules named as the
flax ones (``block<i>``, ``dec_block<i>``) whose parameters are raw
``self.param``s in flax's layout (``qkv_kernel`` (d, 3d), ``ln1_scale``,
...), copied as they are; ``decoder_embed`` and ``decoder_pred`` are
Dense, ``patch_embed/proj`` a conv, ``encoder_norm`` and ``decoder_norm``
LayerNorms, ``cls_token`` and ``mask_token`` plain parameters.

The Swin modules need none either: ``WindowAttention``'s ``qkv`` and
``proj`` (flax ``_DenseParams``) are ``nn.Linear`` and ``norm1``
(``_LNParams``) an ``nn.LayerNorm``, so the Dense and norm rules carry
them; ``relative_position_bias_table`` keeps its ((2ws-1)^2, heads)
layout, and ``patch_embed`` is a conv. ``SwinCheX``'s heads
(``head<i>_fc<j>``, ``head<i>_out``), the classifiers' ``head`` and the
ViT's ``block<i>`` are Dense or raw parameters likewise, and so are the
ViT ``Attention``'s ``qkv`` and ``proj`` (Dense, transposed). The tests
load each of them strictly from a JAX ``init``. A mixer's parameters
(``MambaMixer``, ``SS2D``) do not depend on its ``scan_backend``.

One function serves ``ARM``, ``VSSM`` (and its ``SS2D`` and ``VSSBlock``),
``SwinTransformer``, ``SwinCheX``, ``VSSMClassifier``, ``DPClassifier``,
``ViT``, ``TransformerLM``, ``R2GenGPT``, ``R2GenCSR``, ``AMMRG``,
``R2GenKG`` and ``MAE``: pass the
``params`` subtree whose root matches the port module's root.
:func:`flax_named_parameters` names the port's parameters the other way
round, :func:`lora_from_jax` carries a JAX LoRA tree and
:func:`mamba_peft_from_jax` a JAX MambaPEFT adapter tree.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn

from ..models.common import RMSNorm
from ..peft.lora import flax_path


_QKV = ("query", "key", "value")  # DenseGeneral kernels (D, H, hd)


def _key(path: list[str]) -> str:
    return ".".join(re.sub(r"^layers_(\d+)$", r"layers.\1", p) for p in path)


def to_port_layout(path: list[str], t: torch.Tensor) -> torch.Tensor:
    """A flax leaf at ``path`` in the port's layout (a view where it can
    be): Dense kernels (and ``QuantDense``'s ``kernel_q``) transposed, conv
    kernels HWIO -> OIHW, DenseGeneral kernels and biases flattened over
    the heads; every other leaf as it is."""
    leaf = path[-1]
    if leaf in ("kernel", "kernel_q"):
        if t.dim() == 2:
            return t.T
        if t.dim() == 4:
            return t.permute(3, 2, 0, 1)
        if t.dim() == 3 and path[-2] in _QKV:
            return t.reshape(t.shape[0], -1).T
        if t.dim() == 3 and path[-2] == "out":
            return t.reshape(-1, t.shape[-1]).T
        raise ValueError(f"unexpected kernel rank at {path}")
    if leaf == "bias" and t.dim() == 2 and path[-2] in _QKV:
        return t.reshape(-1)
    return t


def state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """flax ``params`` (nested mapping of arrays) -> port state dict."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node, path, quant=False):
        if hasattr(node, "items"):
            for name, child in node.items():
                walk(child, path + [name], "kernel_q" in node)
            return
        arr = torch.from_numpy(np.array(node, dtype=np.float32))  # a copy
        leaf = path[-1]
        if leaf == "kernel" or (leaf in ("scale", "embedding") and not quant):
            leaf = "weight"  # QuantDense keeps kernel_q and scale
        out[_key(path[:-1] + [leaf])] = to_port_layout(path, arr).contiguous()

    walk(params, [])
    return out


def load_jax_params(module: nn.Module, params) -> nn.Module:
    """Load flax ``params`` into ``module`` (strict: every name must match).

    Values are copied into the module's own parameters, on its device and
    in its dtypes.
    """
    module.load_state_dict(state_dict_from_jax(params), strict=True)
    return module


_PARAMETRIZED = ".parametrizations.weight"


def flax_named_parameters(module: nn.Module) -> dict[str, nn.Parameter]:
    """Every parameter of ``module`` under its flax path: the inverse of
    :func:`state_dict_from_jax`'s naming (``layers.<i>`` -> ``layers_<i>``;
    Linear and Conv2d ``weight`` -> ``kernel``, norm ``weight`` ->
    ``scale``, Embedding ``weight`` -> ``embedding``). A weight with a
    LoRA parametrization is named by its frozen original."""
    owners = dict(module.named_modules())
    out = {}
    for name, p in module.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        if mod_name.endswith(_PARAMETRIZED) and leaf == "original":
            mod_name, leaf = mod_name[: -len(_PARAMETRIZED)], "weight"
        owner = owners[mod_name] if mod_name else module
        if leaf == "weight":
            if isinstance(owner, (nn.Linear, nn.Conv2d)):
                leaf = "kernel"
            elif isinstance(owner, (nn.LayerNorm, RMSNorm)):
                leaf = "scale"
            elif isinstance(owner, nn.Embedding):
                leaf = "embedding"
        path = flax_path(mod_name)
        out[f"{path}/{leaf}" if path else leaf] = p
    return out


def lora_from_jax(lora, device=None) -> dict[str, dict[str, torch.Tensor]]:
    """A LoRA tree of the JAX package's ``init_lora``,
    ``{"params/<path>/kernel": {"a", "b"}}``, as the port's adapters
    (``peft.lora``): the same layouts (``a (d_in, r)``, ``b (r, d_out)``),
    keys without the leading ``params/``, fp32 tensors that require grad.
    """
    out = {}
    for key, ab in lora.items():
        key = key[len("params/"):] if key.startswith("params/") else key
        out[key] = {
            name: torch.tensor(np.array(ab[name], dtype=np.float32),
                               device=device).requires_grad_()
            for name in ("a", "b")
        }
    return out


def mamba_peft_from_jax(peft, device=None) -> dict:
    """A MambaPEFT adapter tree of the JAX package's ``init_mamba_peft``
    (numpy or JAX leaves), ``{"params/<path>|<adapter>": leaf or {name:
    leaf}}``, as the port's (``peft.mamba_peft``): the same keys without
    the leading ``params/``, the same layouts, fp32 tensors that require
    grad."""

    def leaf(x):
        return torch.tensor(np.array(x, dtype=np.float32),
                            device=device).requires_grad_()

    out = {}
    for key, val in peft.items():
        key = key[len("params/"):] if key.startswith("params/") else key
        out[key] = ({name: leaf(x) for name, x in val.items()}
                    if hasattr(val, "items") else leaf(val))
    return out
