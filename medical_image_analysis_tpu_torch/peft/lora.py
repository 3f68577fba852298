"""LoRA on ``nn.Linear`` weights, merged into the weight at every use.

Counterpart of ``medical_image_analysis_tpu/peft/lora.py``. The JAX
package merges ``kernel + (alpha/r) * (a @ b).astype(kernel.dtype)`` inside
the loss; here :func:`apply_lora` registers a parametrization on each
matched ``weight`` that computes the same merge, in the same order and
dtype, whenever the weight is read. So the frozen weight keeps its dtype
(bf16 in the LLM), the adapters stay fp32, a checkpointed block recomputes
the merge with the block, and ``torch.nn.utils.parametrize.cached()``
merges once for a whole generation.

Adapters keep the JAX layouts, ``a (d_in, r)`` and ``b (r, d_out)`` (a
Linear weight is ``(d_out, d_in)``, so the merge adds ``delta.T``), and
the JAX keys: the matched kernel's flax path, ``"llm/layers_0/self_attn/
q_proj/kernel"``, with ``@<rule index>`` for a second adapter on one
kernel. Rules match flax paths, as :func:`flax_path` spells them.
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

from ..parallel.tp import tp_slice


@dataclasses.dataclass(frozen=True)
class LoRARule:
    pattern: str  # regex over 'a/b/c' flax paths (matched on kernels)
    rank: int = 8
    alpha: float = 16.0
    out_slice: tuple[int, int] | None = None  # column range of the delta
    # Fractional column range, resolved against each kernel's width.
    out_frac: tuple[float, float] | None = None


def flax_path(module_name: str) -> str:
    """Torch module name -> flax path: ``llm.layers.0.q_proj`` ->
    ``llm/layers_0/q_proj``."""
    return re.sub(r"(^|/)layers/(\d+)(?=/|$)", r"\1layers_\2",
                  module_name.replace(".", "/"))


def _cols(rule: LoRARule, d_out: int) -> tuple[int, int] | None:
    if rule.out_slice:
        return rule.out_slice
    if rule.out_frac:
        return int(rule.out_frac[0] * d_out), int(rule.out_frac[1] * d_out)
    return None


def _targets(model: nn.Module, rules: list[LoRARule]):
    """(key, linear, rule) for every adapter the rules put on ``model``,
    in module order; keys as the JAX package's ``init_lora`` makes them."""
    out = []
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.Linear):
            continue
        path = flax_path(name) + "/kernel"
        hits = [(i, r) for i, r in enumerate(rules)
                if re.search(r.pattern, path)]
        for j, (ri, rule) in enumerate(hits):
            out.append((path if j == 0 else f"{path}@{ri}", mod, rule))
    return out


def init_lora(model: nn.Module, rules: list[LoRARule],
              generator: torch.Generator) -> dict[str, dict]:
    """Adapters for every kernel the rules match: ``a`` ~ N(0, 0.01^2),
    ``b`` = 0, fp32, on the kernel's device, requiring grad. The JAX
    package draws ``a`` from ``jax.random``; the same seed gives other
    numbers here (``ckpt.from_jax.lora_from_jax`` carries a JAX tree)."""
    out = {}
    for key, lin, rule in _targets(model, rules):
        sl = _cols(rule, lin.out_features)
        cols = sl[1] - sl[0] if sl else lin.out_features
        dev = lin.weight.device
        a = torch.empty(lin.in_features, rule.rank, device=dev)
        a.normal_(0.0, 1.0, generator=generator).mul_(0.01)
        b = torch.zeros(rule.rank, cols, device=dev)
        out[key] = {"a": a.requires_grad_(), "b": b.requires_grad_()}
    return out


class _LoRADelta(nn.Module):
    """weight -> weight + (alpha/r) * (a @ b).to(weight.dtype), transposed
    into the Linear layout, optionally into a row range of the weight."""

    def __init__(self, a, b, scale: float, rows: tuple[int, int] | None,
                 full_out: int = 0):
        super().__init__()
        # A tuple keeps the adapters out of the module's parameters: the
        # trainer owns them, as the JAX package keeps them in their own tree.
        self.ab = (a, b)
        self.scale = scale
        self.rows = rows
        self.full_out = full_out
        # (axis, size, index, parts) of a tensor-parallel weight's slice
        # (parallel.tp.shard_llm): the merge adds that slice of the delta
        self.local = None

    def forward(self, weight):
        a, b = self.ab
        delta = self.scale * (a @ b).to(weight.dtype)
        if self.local is not None:
            d = delta.T
            if self.rows is not None:
                r0, r1 = self.rows
                d = torch.nn.functional.pad(d, (0, 0, r0, self.full_out - r1))
            return weight + tp_slice(d, *self.local)
        if self.rows is None:
            return weight + delta.T
        r0, r1 = self.rows
        return torch.cat([weight[:r0], weight[r0:r1] + delta.T, weight[r1:]])


def apply_lora(model: nn.Module, lora: dict, rules: list[LoRARule]) -> None:
    """Register each adapter of ``lora`` on its weight (in place).

    Kernels without an entry in ``lora`` are left alone, as the JAX
    package's ``apply_lora`` skips them. Several adapters on one weight
    apply in rule order.
    """
    for key, lin, rule in _targets(model, rules):
        if key not in lora:
            continue
        parametrize.register_parametrization(
            lin, "weight", _LoRADelta(
                lora[key]["a"], lora[key]["b"], rule.alpha / rule.rank,
                _cols(rule, lin.out_features), lin.out_features,
            ),
        )


# Reference presets -------------------------------------------------------

def llama_qv_rules(rank: int = 16, alpha: float = 16.0) -> list[LoRARule]:
    """HF-peft default: LoRA on q_proj/v_proj."""
    return [LoRARule(r"self_attn/(q_proj|v_proj)/kernel", rank, alpha)]


def vision_qv_rules(rank: int = 16, alpha: float = 16.0) -> list[LoRARule]:
    """``vis_use_lora``: the q and v thirds of a fused qkv kernel, and the
    X half of a Mamba mixer's joint ``in_proj``; each pattern is inert on
    the other tower family."""
    return [
        LoRARule(r"vision/.*qkv/kernel", rank, alpha, out_frac=(0, 1 / 3)),
        LoRARule(r"vision/.*qkv/kernel", rank, alpha,
                 out_frac=(2 / 3, 1.0)),
        LoRARule(r"vision/.*mixer/in_proj/kernel", rank, alpha,
                 out_frac=(0, 0.5)),
    ]


def mamba_partial_x_rules(d_inner: int, rank: int = 8,
                          alpha: float = 16.0) -> list[LoRARule]:
    """EMRRG's partial LoRA on the X half of a mixer's joint ``in_proj``:
    its first ``d_inner`` output columns (the gate Z is the second half)."""
    return [LoRARule(r"mixer/in_proj/kernel", rank, alpha,
                     out_slice=(0, d_inner))]
