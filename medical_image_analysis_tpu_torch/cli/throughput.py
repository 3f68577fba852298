"""``--throughput``: timed forward passes of a vision tower.

Counterpart of ``medical_image_analysis_tpu/cli/throughput.py``
(``run_throughput``; SwinCheX ``main.py:361-430``, VMamba ``main.py:338-353``).
The tower of ``model.vision`` / ``vision_size`` / ``vision_kwargs`` is
built, initialised from seed 0 and cast to bf16 with a seeded input of
``data.batch_size`` x ``data.input_size``^2 x 3 (numpy's
``default_rng(0)``), and its forward passes are timed under bf16 autocast
(``utils/profiling.py:throughput``: CUDA events on the card).

As in the JAX function, every ``vision`` other than ``swin`` and ``vssm``
builds an ARM: ``vit`` (``dp_finetune``, ``r2gen_iu``) times ARM-B, not the
ViT (a fault of the reference, ROADMAP.md, queue 3, item 10).
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.config import RunConfig
from ..models.common import init_params
from ..train.loop import vision_preset
from ..utils.profiling import throughput


def build_tower(cfg: RunConfig, device) -> torch.nn.Module:
    """The tower that ``run_throughput`` times, in bf16 on ``device``:
    ``SwinTransformer``, ``VSSM``, else ``ARM``."""
    m = cfg.model
    if m.vision == "swin":
        from ..models.swin import SwinTransformer as cls
        family = "swin"
    elif m.vision == "vssm":
        from ..models.vmamba import VSSM as cls
        family = "vssm"
    else:
        from ..models.mamba import ARM as cls
        family = "arm"
    kwargs = vision_preset(family, m.vision_size, m.vision_kwargs)
    if family != "vssm":  # flax sizes these towers from the input
        kwargs.setdefault("img_size", cfg.data.input_size)
    model = cls(**kwargs, device=device).eval()
    init_params(model, torch.Generator(device).manual_seed(0))
    return model.to(torch.bfloat16)


def run_throughput(cfg: RunConfig, device="cuda") -> dict:
    """``{"vision", "batch", "input", "ms_per_iter", "items_per_sec"}``."""
    device = torch.device(device)
    b, size = cfg.data.batch_size, cfg.data.input_size
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (b, size, size, 3)).astype(np.float32)).to(device, torch.bfloat16)
    model = build_tower(cfg, device)

    def forward(images):
        # flax promotes a bf16 kernel and an fp32 activation (the ARM's RMS
        # norms compute in fp32) where torch's Linear refuses the pair
        with torch.autocast(device.type, dtype=torch.bfloat16):
            return model(images)

    stats = throughput(forward, (x,), batch_size=b)
    return {"vision": cfg.model.vision, "batch": b, "input": size, **stats}
