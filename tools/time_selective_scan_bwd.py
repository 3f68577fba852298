#!/usr/bin/env python3
"""Device time of the general selective scan's backward kernel, and of the
device work of a ``vssm_classify`` training step on ``scan_backend:
pallas``, on one NVIDIA GPU.

    python3 tools/time_selective_scan_bwd.py

Times the checkout this script sits in:

- ``selective_scan_bwd`` at ``chip_smoke.py``'s ``kernels_ss_bwd`` cases
  (ARM-B at B=6 in fp32 and bf16, vssm_tiny's four stages at B=128 in
  fp32, stage 0 also in bf16): CUDA events over 20 calls at ARM-B and 5
  elsewhere (``chip_smoke.device_ms``), with the kernel's resident blocks
  an SM where the checkout reports them;
- ``vssm_classify``'s model (vssm_tiny and 14 heads at 224^2, the preset's
  batch of 128, random weights and random images and labels on the card,
  so that data loading, mixup and AdamW are left out): forward, loss and
  backward through the scan kernels, CUDA events over 3 calls, then one
  call under ``torch.profiler`` for the backward kernel's share of it.

It reads only ``chip_smoke``'s ``_ss_cases``, ``_ss_case``, ``device_ms``
and ``_dtype_name``, the scan's wrapper and ``build_classifier``, which
older checkouts of the port have too, so that two versions can be
compared on one card: unpack the other into a git-ignored directory and
run the script of each checkout in one call, in turns: A, B, B, A. Random
weights and inputs from seed 0; TF32 off. Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PRESET = (ROOT / "medical_image_analysis_tpu_torch" / "configs" / "presets"
          / "vssm_classify.yaml")
PALLAS = "model.vision_kwargs={scan_backend: pallas}"
KERNEL = "selective_scan_bwd_kernel"


def kernel_ms(fn, name: str) -> tuple[float, float]:
    """Device ms of the kernels whose name holds ``name`` in one call of
    ``fn``, and of all its kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in events if name in e.key)
            / 1e3, sum(e.self_device_time_total for e in events) / 1e3)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_selective_scan_bwd: needs a CUDA card")
    import chip_smoke as cs
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.ops import selective_scan_pallas as ssp
    from medical_image_analysis_tpu_torch.train.loop import build_classifier

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ssp.build()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for case, b, k, l, d, n, dtype in cs._ss_cases("bwd"):
        args = cs._ss_case(dev, gen, b, k, l, d, n, dtype)
        dy = torch.randn(b * k, l, d, device=dev, generator=gen).to(dtype)
        ms = cs.device_ms(lambda: ssp.selective_scan_bwd(*args, dy, True),
                          20 if case == "arm_b" else 5)
        blocks = (ssp.bwd_occupancy(n, dtype)[0]
                  if hasattr(ssp, "bwd_occupancy") else "not reported")
        print(f"selective_scan_bwd case={case} B={b} L={l} D={d} N={n} "
              f"{cs._dtype_name(dtype)} ms={ms:.4f} blocks_per_sm={blocks}",
              flush=True)
        del args, dy
        torch.cuda.empty_cache()

    cfg = load_config(str(PRESET), [PALLAS])
    model, loss_head, _ = build_classifier(cfg, dev)
    init_params(model, gen)
    bs, size = cfg.data.batch_size, cfg.data.input_size
    imgs = torch.randn(bs, size, size, 3, device=dev, generator=gen)
    labels = torch.rand(bs, 14, device=dev, generator=gen)
    params = [p for p in model.parameters() if p.requires_grad]

    def step():
        loss = loss_head(model(imgs), labels)
        return torch.autograd.grad(loss, params)

    ms = cs.device_ms(step, 3)
    bwd_ms, all_ms = kernel_ms(step, KERNEL)
    print(f"vssm_classify fwd+loss+bwd B={bs} {size}^2 ms={ms:.2f} "
          f"profiled_device_ms={all_ms:.2f} {KERNEL}_ms={bwd_ms:.2f} "
          f"peak_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}",
          flush=True)


if __name__ == "__main__":
    main()
