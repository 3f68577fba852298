"""Typed configuration with YAML presets and dotted overrides.

Counterpart of ``medical_image_analysis_tpu/configs/config.py``, with the
same dataclasses and the same YAML keys, so that the JAX package's
presets load unchanged. The port keeps its own copy because the JAX file
imports flax (through ``models/mrg.py``). The presets are data files read
by path from :data:`PRESET_DIR`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import yaml

from ..models.mrg import GenerateConfig

PRESET_DIR = (
    Path(__file__).resolve().parents[2]
    / "medical_image_analysis_tpu" / "configs" / "presets"
)


@dataclasses.dataclass
class DataConfig:
    # iu_xray | mimic_cxr | chexpert_plus | chinese | synthetic |
    # synthetic_learnable
    dataset: str = "iu_xray"
    annotation_path: str = ""
    synthetic_train_size: int = 0
    synthetic_holdout: int = 0
    base_dir: str = ""
    batch_size: int = 6
    val_batch_size: int = 0
    input_size: int = 224
    max_len: int = 100
    num_views: int = 2
    n_context: int = 0
    context_retrieval_mode: str = "keyword"
    context_keyword: Any = "effusion"
    chexbert_csv: str = ""
    tokenizer_dir: str = ""
    use_feature_mean: bool = True
    drop_unclear_report: bool = False
    num_workers: int = 8
    vocab_min_freq: int = 3
    prompt: str = "human : generate a comprehensive and detailed diagnosis report for this chest xray image ."
    prompt_after: str = "assistant :"


@dataclasses.dataclass
class ModelConfig:
    task: str = "r2gengpt"
    vision: str = "swin"  # swin | vssm | arm | vit
    vision_size: str = "base"  # tiny | base | large
    llm: str = "qwen1_5_0_5b"  # key into models.llm.LLM_CONFIGS
    llm_weights_dir: str = ""
    llm_int8: bool = False
    vision_init: str = ""
    vision_kwargs: dict = dataclasses.field(default_factory=dict)
    llm_kwargs: dict = dataclasses.field(default_factory=dict)
    task_kwargs: dict = dataclasses.field(default_factory=dict)
    side_inputs: dict = dataclasses.field(default_factory=dict)
    lm_kwargs: dict = dataclasses.field(default_factory=dict)
    mask_type: str = "random"
    mask_ratio: float = 0.75
    mask_ratio_inner: float = 0.75


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 3
    lr: float = 1e-4
    blr: float = 0.0
    weight_decay: float = 0.05
    warmup_steps: int = 100
    grad_clip: float = 1.0
    freeze_llm: bool = True
    freeze_vision: bool = False
    lora_llm: bool = False
    lora_rank: int = 16
    lora_vision: bool = False
    lora_vision_rank: int = 16
    accum_steps: int = 1
    remat: bool = False
    zero_opt: bool = True
    mixup: float = 0.0
    cutmix: float = 0.0
    ema_decay: float = 0.0
    seed: int = 42
    log_every: int = 10
    val_every_epochs: int = 1
    val_max_batches: int = 50
    save_dir: str = "save"
    scorer_types: list = dataclasses.field(
        default_factory=lambda: ["Bleu_4", "CIDEr"]
    )
    scorer_weights: list = dataclasses.field(
        default_factory=lambda: [0.5, 0.5]
    )
    resume: str = ""
    eval_only: bool = False
    eval_split: str = "test"
    init_delta: str = ""
    max_epochs_this_run: int = 0
    save_state_every_epochs: int = 1
    keep_states: int = 2
    debug_nans: bool = False
    mesh_data: int = -1
    mesh_model: int = 1


@dataclasses.dataclass
class RunConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    generate: GenerateConfig = dataclasses.field(
        default_factory=GenerateConfig
    )


_SECTIONS = {
    "data": DataConfig, "model": ModelConfig,
    "train": TrainConfig, "generate": GenerateConfig,
}


def _from_dict(cls, d: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown config key: {cls.__name__}.{k}")
        sub = _SECTIONS.get(k)
        kwargs[k] = _from_dict(sub, v) if sub and isinstance(v, dict) else v
    return cls(**kwargs)


def load_config(path: str, overrides: list[str] | None = None) -> RunConfig:
    with open(path) as f:
        d = yaml.safe_load(f) or {}
    return make_config(d, overrides)


def make_config(d: dict | None = None, overrides: list[str] | None = None
                ) -> RunConfig:
    d = dict(d or {})
    for ov in overrides or []:  # "train.lr=3e-4" dotted overrides
        key, _, val = ov.partition("=")
        parts = key.split(".")
        node = d
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        loaded = yaml.safe_load(val)
        if isinstance(loaded, str):
            # YAML 1.1 parses "1e-3" (no dot) as a string; recover the
            # numeric intent
            try:
                loaded = float(loaded)
            except ValueError:
                pass
        node[parts[-1]] = loaded
    return _from_dict(RunConfig, d)

