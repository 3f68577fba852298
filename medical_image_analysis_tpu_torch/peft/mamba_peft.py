"""The MambaPEFT adapter family: its configuration and its weight-space
adapters.

Counterpart of ``medical_image_analysis_tpu/peft/mamba_peft.py``
(``MambaPEFTConfig``, ``effective_d_state``, ``init_mamba_peft``,
``merge_mamba_peft``, ``mamba_peft_trainable_mask``). The port's
``models/mamba_lm.py`` reads the activation-space adapters (AdaptFormer,
prompt and prefix tuning). The weight-space family works on a flat
``{flax name: tensor}`` mapping of a module's parameters in the port's
layouts (``ckpt.from_jax.flax_named_parameters``): the per-tensor LoRAs,
the learnable-delta (v2) variants and ``additional_scan`` live in an
adapter tree keyed ``'<path>|<adapter>'`` as the JAX package's (without
its leading ``params/``; ``ckpt.from_jax.mamba_peft_from_jax`` carries a
JAX tree across), with each adapter's own layout the JAX package's (a
LoRA's ``a (..., d_in, r)`` and ``b (..., r, d_out)`` over the flax
kernel's ``(d_in, d_out)``). ``merge_mamba_peft`` is a pure function of
tensors, differentiable in the adapter tree; :func:`apply_merged` runs a
module on the merged mapping through ``torch.func.functional_call``. With
``additional_scan`` the merged ``A_log`` and ``x_proj_w`` are wider than
the base: the module is built at :func:`effective_d_state`, and the fused
kernels run that width (17 at the default 16 + 1).
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch


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


def _lora_pair(gen, d_in, d_out, rank, like, lead=()):
    """``a`` N(0, 0.01^2) (..., d_in, rank), ``b`` zeros (..., rank,
    d_out), on ``like``'s device, trainable."""
    a = torch.empty(*lead, d_in, rank, device=like.device)
    a.normal_(0.0, 0.01, generator=gen)
    b = torch.zeros(*lead, rank, d_out, device=like.device)
    return {"a": a.requires_grad_(), "b": b.requires_grad_()}


def _delta(p):
    return torch.einsum("...ir,...ro->...io", p["a"], p["b"])


def _zeros(t):
    return torch.zeros(t.shape, device=t.device).requires_grad_()


def init_mamba_peft(gen: torch.Generator, params: dict,
                    cfg: MambaPEFTConfig) -> dict:
    """The adapter tree of ``cfg`` for the flat ``{flax name: tensor}``
    ``params`` (a module's ``flax_named_parameters``), keyed
    ``'<mixer path>|<adapter>'`` and ``'<path>|<adapter>'``: fp32 tensors
    (or ``{"a", "b"}`` / ``{"A_log_addi", "x_proj_addi"}`` pairs) that
    require grad, drawn from ``gen`` (the JAX package draws other numbers
    from its key). Mixers are found by their ``x_proj_w``, with one adapter
    per direction (K of them); ``cls_token``, ``pos_embed`` and a 4-D
    ``patch_embed`` kernel get theirs."""
    out: dict = {}
    for path, leaf in params.items():
        if path.endswith("x_proj_w"):
            mixer = path[: -len("x_proj_w")]
            k, c, d_inner = leaf.shape
            rank_dt = params[mixer + "dt_proj_w"].shape[2]
            n = (c - rank_dt) // 2
            # the port's Linear weight is the flax kernel transposed
            d_model = params[mixer + "in_proj/kernel"].shape[1]
            for name, on, d_in, d_out, rank, lead in (
                ("lora_out_proj", cfg.lora_out_proj, d_inner, d_model,
                 cfg.dim, ()),
                ("lora_in_proj", cfg.lora_in_proj, d_model, 2 * d_inner,
                 cfg.dim_in_proj, ()),
                ("lora_X", cfg.lora_X, d_model, d_inner, cfg.dim_X, ()),
                ("lora_Z", cfg.lora_Z, d_model, d_inner, cfg.dim_Z, ()),
                ("lora_x_proj", cfg.lora_x_proj, c, d_inner, cfg.dim_x_proj,
                 (k,)),
                ("lora_d", cfg.lora_d, rank_dt, d_inner, cfg.dim_d, (k,)),
                ("lora_B", cfg.lora_B, n, d_inner, cfg.dim_B, (k,)),
                ("lora_C", cfg.lora_C, n, d_inner, cfg.dim_C, (k,)),
                ("lora_dt", cfg.lora_dt, d_inner, rank_dt, cfg.dim_dt, (k,)),
                ("lora_conv1d", cfg.lora_conv1d,
                 params[mixer + "conv_w"].shape[1], d_inner, cfg.dim_conv1d,
                 (k,)),
            ):
                if on:
                    out[f"{mixer}|{name}"] = _lora_pair(gen, d_in, d_out,
                                                        rank, leaf, lead)
            a_log = params[mixer + "A_log"]
            if cfg.additional_scan:
                out[mixer + "|scan_addi"] = _scan_addi(gen, cfg, a_log, k,
                                                       d_inner)
            for name, on, base in (
                ("learnable_A", cfg.learnable_A_v2, "A_log"),
                ("learnable_D", cfg.learnable_D_v2, "D"),
                ("learnable_conv1d", cfg.learnable_conv1d_v2, "conv_w"),
                ("learnable_bias", cfg.learnable_bias_v2, "dt_bias"),
            ):
                if on:
                    out[f"{mixer}|{name}"] = _zeros(params[mixer + base])
        elif path.endswith("cls_token") and cfg.learnable_cls_token_v2:
            out[path + "|learnable"] = _zeros(leaf)
        elif path.endswith("pos_embed") and cfg.learnable_pos_embed_v2:
            out[path + "|learnable"] = _zeros(leaf)
        elif (re.search(r"patch_embed.*/kernel$", path)
              and cfg.lora_patch_embed and leaf.ndim == 4):
            cout, cin, kh, kw = leaf.shape  # OIHW; flax's kernel is HWIO
            out[path + "|lora_patch_embed"] = _lora_pair(
                gen, kh * kw * cin, cout, cfg.dim_patch_embed, leaf)
    return out


def _scan_addi(gen, cfg, a_log, k, d_inner):
    """``additional_scan``'s extra states: their ``A_log`` (a constant,
    the last state's, or log 1 .. log a_num) and their B and C rows of
    ``x_proj_w`` (zeros, or N(0, 1 / d_inner))."""
    a_num = cfg.scan_addition_num
    dev = a_log.device
    if cfg.scan_A_constant is not None:
        a_init = torch.full((k, d_inner, a_num),
                            math.log(cfg.scan_A_constant), device=dev)
    elif cfg.scan_A_copy_from_last:
        a_init = a_log.detach()[..., -1:].repeat(1, 1, a_num).float()
    else:
        a_init = torch.log(torch.arange(1, a_num + 1, dtype=torch.float32,
                                        device=dev)).expand(k, d_inner, a_num)
    xp = torch.zeros(k, 2 * a_num, d_inner, device=dev)
    if not cfg.zero_init_x_proj:
        xp.normal_(0.0, d_inner**-0.5, generator=gen)
    return {"A_log_addi": a_init.clone().requires_grad_(),
            "x_proj_addi": xp.requires_grad_()}


def _merge_mixer(out: dict, prefix: str, peft: dict, cfg) -> None:
    """One mixer's merge, in the JAX package's order of additions, on the
    port's layouts (a Linear's weight is the flax kernel transposed)."""

    def get(name):
        return peft.get(f"{prefix}|{name}")

    a_log = out[prefix + "A_log"]
    xp = out[prefix + "x_proj_w"]
    n = a_log.shape[-1]
    r = xp.shape[1] - 2 * n
    d_inner = xp.shape[2]
    key = prefix + "in_proj/kernel"
    if key in out:
        w = out[key]  # (2 d_inner, d_model)
        if get("lora_in_proj") is not None:
            w = w + cfg.s_in_proj * _delta(get("lora_in_proj")).T
        if get("lora_X") is not None:
            w = torch.cat([w[:d_inner] + cfg.s_X * _delta(get("lora_X")).T,
                           w[d_inner:]])
        if get("lora_Z") is not None:
            w = torch.cat([w[:d_inner],
                           w[d_inner:] + cfg.s_Z * _delta(get("lora_Z")).T])
        out[key] = w
    key = prefix + "out_proj/kernel"
    if key in out and get("lora_out_proj") is not None:
        out[key] = out[key] + cfg.s * _delta(get("lora_out_proj")).T

    if get("lora_x_proj") is not None:
        xp = xp + cfg.s_x_proj * _delta(get("lora_x_proj"))
    for name, scale, lo, hi in (("lora_d", cfg.s_d, 0, r),
                                ("lora_B", cfg.s_B, r, r + n),
                                ("lora_C", cfg.s_C, r + n, r + 2 * n)):
        if get(name) is not None:
            xp = torch.cat([xp[:, :lo], xp[:, lo:hi] + scale * _delta(
                get(name)), xp[:, hi:]], dim=1)
    if get("learnable_A") is not None:
        a_log = a_log + get("learnable_A")
    addi = get("scan_addi")
    if addi is not None:
        a_num = addi["x_proj_addi"].shape[1] // 2
        b_add = addi["x_proj_addi"][:, :a_num]
        c_add = addi["x_proj_addi"][:, a_num:]
        if cfg.scan_addition_pos == "suffix":
            xp = torch.cat([xp[:, : r + n], b_add, xp[:, r + n :], c_add],
                           dim=1)
            a_log = torch.cat([a_log, addi["A_log_addi"]], dim=-1)
        else:
            xp = torch.cat([xp[:, :r], b_add, xp[:, r : r + n], c_add,
                            xp[:, r + n :]], dim=1)
            a_log = torch.cat([addi["A_log_addi"], a_log], dim=-1)
    out[prefix + "x_proj_w"] = xp
    out[prefix + "A_log"] = a_log
    if get("lora_dt") is not None:
        out[prefix + "dt_proj_w"] = (out[prefix + "dt_proj_w"]
                                     + cfg.s_dt * _delta(get("lora_dt")))
    cw = out[prefix + "conv_w"]
    if get("lora_conv1d") is not None:
        cw = cw + cfg.s_conv1d * _delta(get("lora_conv1d"))
    if get("learnable_conv1d") is not None:
        cw = cw + get("learnable_conv1d")
    out[prefix + "conv_w"] = cw
    for base, name in (("D", "learnable_D"), ("dt_bias", "learnable_bias")):
        if get(name) is not None:
            out[prefix + base] = out[prefix + base] + get(name)


def merge_mamba_peft(params: dict, peft: dict, cfg: MambaPEFTConfig) -> dict:
    """Base parameters + adapter deltas -> the effective parameters, a new
    flat ``{flax name: tensor}`` mapping (``params`` is not changed). Pure
    and differentiable in ``peft``. Mixers (names with both ``x_proj_w``
    and ``A_log``) merge with full shape information; outside them a
    leaf's ``'|learnable'`` delta is added and a ``patch_embed`` kernel's
    LoRA (reshaped to the flax kernel's HWIO, then to the port's OIHW).
    With ``additional_scan`` the merged ``A_log`` and ``x_proj_w`` are
    WIDER than the base: apply them to a module built at
    :func:`effective_d_state`."""
    out = dict(params)
    mixers = [name[: -len("x_proj_w")] for name in params
              if name.endswith("x_proj_w")
              and name[: -len("x_proj_w")] + "A_log" in params]
    for prefix in mixers:
        _merge_mixer(out, prefix, peft, cfg)
    for name in params:
        if any(name.startswith(m) for m in mixers):
            continue
        learn = peft.get(name + "|learnable")
        if learn is not None:
            out[name] = out[name] + learn
        lpe = peft.get(name + "|lora_patch_embed")
        if lpe is not None:
            cout, cin, kh, kw = out[name].shape
            delta = _delta(lpe).reshape(kh, kw, cin, cout)
            out[name] = out[name] + cfg.s_patch_embed * delta.permute(
                3, 2, 0, 1)
    return out


def mamba_peft_trainable_mask(params: dict, cfg: MambaPEFTConfig
                              ) -> dict[str, bool]:
    """The v1 ``learnable_*`` variants: ``{flax name: bool}``, True where
    the base tensor itself trains (``A_log``, ``D``, the conv's
    ``conv_w``/``conv_b``, ``cls_token``, ``pos_embed``, ``dt_bias``,
    each unless its v2 delta is on; and anything under a ``head``),
    False for the rest (the adapters train as a separate tree)."""

    def trainable(p: str) -> bool:
        return (
            (cfg.learnable_A and not cfg.learnable_A_v2
             and p.endswith("A_log"))
            or (cfg.learnable_D and not cfg.learnable_D_v2
                and p.endswith("/D"))
            or (cfg.learnable_conv1d and not cfg.learnable_conv1d_v2
                and (p.endswith("conv_w") or p.endswith("conv_b")))
            or (cfg.learnable_cls_token and not cfg.learnable_cls_token_v2
                and p.endswith("cls_token"))
            or (cfg.learnable_pos_embed and not cfg.learnable_pos_embed_v2
                and p.endswith("pos_embed"))
            or (cfg.learnable_bias and not cfg.learnable_bias_v2
                and p.endswith("dt_bias"))
            or "head" in p)

    return {name: trainable(name) for name in params}


def _port_names(module: torch.nn.Module) -> dict[str, str]:
    """``{flax name: the module's parameter name}``."""
    from ..ckpt.from_jax import flax_named_parameters

    by_id = {id(p): name for name, p in module.named_parameters()}
    return {flax: by_id[id(p)]
            for flax, p in flax_named_parameters(module).items()}


def apply_merged(module: torch.nn.Module, merged: dict, *args, **kwargs):
    """``module(*args, **kwargs)`` with its parameters replaced by the
    merged mapping (every one of them, by flax name; a KeyError names a
    missing one) through ``torch.func.functional_call``: gradients flow
    to the adapter tree. With ``additional_scan`` ``module`` is built at
    :func:`effective_d_state` (its own parameters may be on the meta
    device: none of them is read)."""
    names = _port_names(module)
    missing = set(names) - set(merged)
    if missing or set(merged) - set(names):
        raise KeyError(f"apply_merged: names missing {sorted(missing)[:4]}, "
                       f"unknown {sorted(set(merged) - set(names))[:4]}")
    return torch.func.functional_call(
        module, {names[k]: v for k, v in merged.items()}, args, kwargs)


@torch.no_grad()
def load_merged(module: torch.nn.Module, merged: dict) -> torch.nn.Module:
    """Copy the merged mapping into ``module``'s own parameters (strict:
    every name and shape must match), e.g. a model built at
    :func:`effective_d_state` for decoding with ``MambaLM.step``."""
    from ..ckpt.from_jax import flax_named_parameters

    own = flax_named_parameters(module)
    if set(own) != set(merged):
        raise KeyError(f"load_merged: names differ: "
                       f"{sorted(set(own) ^ set(merged))[:4]}")
    for name, p in own.items():
        if p.shape != merged[name].shape:
            raise ValueError(f"load_merged: {name} {tuple(p.shape)} != "
                             f"{tuple(merged[name].shape)}")
        p.copy_(merged[name])
    return module
