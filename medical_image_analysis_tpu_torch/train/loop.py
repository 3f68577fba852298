"""Model construction from a RunConfig.

Counterpart of ``vision_preset`` and ``build_mrg_model`` in
``medical_image_analysis_tpu/train/loop.py``; the training recipes are not
ported yet (ROADMAP.md, queue 1). ``train.remat`` (activation
checkpointing) only matters under a gradient, so it is not read here.
"""

from __future__ import annotations

import dataclasses

from ..configs.config import RunConfig
from ..models.llm import LLM_CONFIGS
from ..models.mamba import ARM_CONFIGS
from ..models.mrg import R2GenGPT


def vision_preset(family: str, size: str, extra: dict | None = None) -> dict:
    if family != "arm":
        raise NotImplementedError(
            f"vision tower {family!r} is not ported yet (ROADMAP.md, queue 1)"
        )
    base = dict(ARM_CONFIGS[f"arm_{size}_pz16"])
    base.update(extra or {})
    return base


def build_mrg_model(cfg: RunConfig, vocab_size: int, device=None) -> R2GenGPT:
    """R2GenGPT with an ARM tower and a ``cfg.model.llm`` decoder.

    Parameters are allocated on ``device`` and left uninitialised by
    this function: call ``models.common.init_params`` with a seeded
    generator, or load weights (``ckpt.from_jax``).
    """
    m = cfg.model
    if m.llm_weights_dir or m.vision_init:
        raise NotImplementedError(
            "loading checkpoints (model.llm_weights_dir, model.vision_init) "
            "is not ported yet (ROADMAP.md, queue 1, slice 1 item 10)"
        )
    if m.task != "r2gengpt" or m.vision != "arm":
        raise NotImplementedError(
            f"task={m.task!r} with vision={m.vision!r} is not ported yet; "
            "the port builds task=r2gengpt with vision=arm (ROADMAP.md, "
            "queue 1)"
        )
    llm_cfg = dataclasses.replace(
        LLM_CONFIGS[m.llm], vocab_size=vocab_size, **(m.llm_kwargs or {})
    )
    vk = vision_preset(m.vision, m.vision_size, m.vision_kwargs)
    vk.setdefault("img_size", cfg.data.input_size)
    return R2GenGPT(llm_cfg=llm_cfg, chosen=m.vision, vision_kwargs=vk,
                    device=device, **(m.task_kwargs or {}))
