"""Carry the JAX package's parameters into the port.

The port's modules use the flax modules' names, so the mapping is by
name, with these conversions:

- ``layers_<i>`` (flax lists) -> ``layers.<i>`` (``nn.ModuleList``);
- Dense ``kernel (in, out)`` -> Linear ``weight (out, in)``;
- Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW;
- norm ``scale`` and Embed ``embedding`` -> ``weight``;
- ``A_log``, ``D``, ``dt_bias``, ``conv_w``, ``conv_b``, ``x_proj_w``,
  ``dt_proj_w``, ``cls_token`` and ``pos_embed`` keep their layout.

One function serves ``ARM``, ``TransformerLM`` and ``R2GenGPT``: pass the
``params`` subtree whose root matches the port module's root.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn


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
