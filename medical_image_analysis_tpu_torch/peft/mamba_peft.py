"""The MambaPEFT adapter family's configuration.

Counterpart of the config part of ``medical_image_analysis_tpu/peft/
mamba_peft.py`` (``MambaPEFTConfig``, ``effective_d_state``). The port's
``models/mamba_lm.py`` reads its activation-space adapters: AdaptFormer,
prompt tuning and prefix tuning. The weight-space family (the per-tensor
LoRAs, the learnable-delta variants, ``additional_scan``; the JAX
package's ``init_mamba_peft``, ``merge_mamba_peft`` and
``mamba_peft_trainable_mask``) is not ported yet (ROADMAP.md, queue 1,
item 15b): :func:`weight_space_fields` names the fields that would need
it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MambaPEFTConfig:
    """The JAX package's ``MambaPEFTConfig``, field for field."""

    # AdaptFormer (parallel bottleneck adapter; activation-space)
    adaptformer: bool = False
    dim_adaptf: int = 32
    s_adaptf: float = 1.0
    # LoRA on out_proj
    lora_out_proj: bool = False
    dim: int = 32
    s: float = 1.0
    # LoRA on in_proj (full / X half / Z half)
    lora_in_proj: bool = False
    dim_in_proj: int = 32
    s_in_proj: float = 1.0
    lora_X: bool = False
    dim_X: int = 32
    s_X: float = 1.0
    lora_Z: bool = False
    dim_Z: int = 32
    s_Z: float = 1.0
    # LoRA on x_proj (all rows / dt rows / B rows / C rows)
    lora_x_proj: bool = False
    dim_x_proj: int = 4
    s_x_proj: float = 1.0
    lora_d: bool = False
    dim_d: int = 4
    s_d: float = 1.0
    lora_B: bool = False
    dim_B: int = 4
    s_B: float = 1.0
    lora_C: bool = False
    dim_C: int = 4
    s_C: float = 1.0
    # LoRA on dt_proj
    lora_dt: bool = False
    dim_dt: int = 4
    s_dt: float = 1.0
    # LoRA on conv1d (factorized over (d_inner, taps))
    lora_conv1d: bool = False
    dim_conv1d: int = 32
    s_conv1d: float = 1.0
    # LoRA on patch_embed conv
    lora_patch_embed: bool = False
    dim_patch_embed: int = 32
    s_patch_embed: float = 1.0
    # prefix / prompt tuning (activation-space)
    prefix_tuning: bool = False
    num_virtual_tokens: int = 1
    prompt_tuning: bool = False
    prompt_num_tokens: int = 2
    # additional_scan: extra d_state columns
    additional_scan: bool = False
    scan_addition_num: int = 1
    scan_addition_pos: str = "suffix"  # suffix | prefix
    scan_A_constant: float | None = None
    scan_A_copy_from_last: bool = False
    zero_init_x_proj: bool = False
    # learnable-Δ "bias tuning" (v2 = additive delta params; v1 = just
    # unfreeze the base tensor via trainable-mask)
    learnable_A: bool = False
    learnable_A_v2: bool = False
    learnable_D: bool = False
    learnable_D_v2: bool = False
    learnable_conv1d: bool = False
    learnable_conv1d_v2: bool = False
    learnable_cls_token: bool = False
    learnable_cls_token_v2: bool = False
    learnable_pos_embed: bool = False
    learnable_pos_embed_v2: bool = False
    learnable_bias: bool = False  # dt bias
    learnable_bias_v2: bool = False


def effective_d_state(cfg: MambaPEFTConfig, d_state: int) -> int:
    """d_state of the *merged* model (additional_scan widens N)."""
    return d_state + (cfg.scan_addition_num if cfg.additional_scan else 0)



# The activation-space fields, which MambaLM reads; every other field
# configures the weight-space family.
ACTIVATION_FIELDS = (
    "adaptformer", "dim_adaptf", "s_adaptf", "prefix_tuning",
    "num_virtual_tokens", "prompt_tuning", "prompt_num_tokens",
)


def weight_space_fields(cfg: MambaPEFTConfig) -> list[str]:
    """The fields of ``cfg`` that differ from their defaults and configure
    the weight-space family."""
    return [f.name for f in dataclasses.fields(cfg)
            if f.name not in ACTIVATION_FIELDS
            and getattr(cfg, f.name) != f.default]
