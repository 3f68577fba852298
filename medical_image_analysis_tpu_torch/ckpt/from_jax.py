"""Carry the JAX package's parameters into the port.

The port's modules use the flax modules' names, so the mapping is by
name, with these conversions:

- ``layers_<i>`` (flax lists) -> ``layers.<i>`` (``nn.ModuleList``);
- Dense ``kernel (in, out)`` -> Linear ``weight (out, in)``;
- Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW (the SS2D depthwise
  conv: (3, 3, 1, D) -> (D, 1, 3, 3));
- norm ``scale`` and Embed ``embedding`` -> ``weight``;
- ``A_log``, ``D``, ``dt_bias``, ``conv_w``, ``conv_b``, ``x_proj_w``,
  ``dt_proj_w``, ``cls_token``, ``pos_embed``, ``pos_marker`` and
  ``neg_marker`` keep their layout.

The MAE needs no rule of its own: its blocks are modules named as the
flax ones (``block<i>``, ``dec_block<i>``) whose parameters are raw
``self.param``s in flax's layout (``qkv_kernel`` (d, 3d), ``ln1_scale``,
...), copied as they are; ``decoder_embed`` and ``decoder_pred`` are
Dense, ``patch_embed/proj`` a conv, ``encoder_norm`` and ``decoder_norm``
LayerNorms, ``cls_token`` and ``mask_token`` plain parameters.

One function serves ``ARM``, ``VSSM`` (and its ``SS2D`` and ``VSSBlock``),
``TransformerLM``, ``R2GenGPT``, ``R2GenCSR`` and ``MAE``: pass the
``params`` subtree whose root matches the port module's root.
:func:`flax_named_parameters` names the port's parameters the other way
round, and :func:`lora_from_jax` carries a JAX LoRA tree.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn

from ..models.common import RMSNorm
from ..peft.lora import flax_path


def _key(path: list[str]) -> str:
    return ".".join(re.sub(r"^layers_(\d+)$", r"layers.\1", p) for p in path)


def state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """flax ``params`` (nested mapping of arrays) -> port state dict."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if hasattr(node, "items"):
            for name, child in node.items():
                walk(child, path + [name])
            return
        arr = np.array(node, dtype=np.float32)  # a writable copy
        leaf = path[-1]
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"unexpected kernel rank at {path}")
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        out[_key(path[:-1] + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr)
        )

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
