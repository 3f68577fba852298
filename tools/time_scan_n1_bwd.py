#!/usr/bin/env python3
"""Device time of the d_state=1 scan's backward (``scan_n1_bwd``), and of
the vssm1_base tower's forward and backward, on one NVIDIA GPU.

    python3 tools/time_scan_n1_bwd.py

Times the checkout this script sits in:

- ``scan_n1_bwd`` at ``chip_smoke.py``'s ``_n1_cases()`` (vssm1_base's
  four stages at B=12 in fp32, stage 2 in bf16, stage 0 at B=1): CUDA
  events over 10 calls (``chip_smoke.device_ms``), then 5 calls under
  ``torch.profiler`` for each kernel's share by name; the grid's blocks and
  each kernel's resident blocks an SM and shared memory a block, where the
  checkout reports them;
- the vssm1_base tower of ``r2gencsr_iu`` (``R2GenCSR.encode_img``: the
  tower and the projector, 21 SS2D blocks) forward and backward at the
  training step's 6 studies x 2 views of 224^2, random weights and random
  images and cotangents on the card: CUDA events over 3 calls, then one
  call under ``torch.profiler`` for the scan kernels' share of it.

It reads only ``chip_smoke``'s ``_n1_cases``, ``_n1_case``, ``N1_STAGES``,
``device_ms``, ``_dtype_name``, ``CSR_PRESET`` and ``VSSM1_OVERRIDES``, the
scan's wrapper and ``build_mrg_model``, which older checkouts of the port
have too, so that two versions can be compared on one card: unpack the
other into a git-ignored directory and run the script of each checkout in
one call, in turns: A, B, B, A. Random inputs from seed 0; TF32 off. Needs
a CUDA card.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# The prefix of every backward kernel's name in csrc/scan_n1.cu, and of
# the forward's.
KERNELS = ("scan_n1_bwd", "scan_n1_fwd")
SPIN = 50_000_000  # cycles of the spin kernel around a profiled call


def kernel_ms(fn, calls: int, prefixes=KERNELS) -> dict:
    """Device ms a call of ``fn`` by kernel name, for the kernels whose
    name holds one of ``prefixes``, and ``"all"`` for every kernel: one
    profile of ``calls`` calls, a spin kernel queued on each side (the
    profiler may lose a call's first kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(SPIN)
        torch.cuda.synchronize()
    out = {"all": 0.0}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0 or "spin_kernel" in e.key:
            continue
        ms = e.self_device_time_total / 1e3 / calls
        out["all"] += ms
        name = re.search(rf"\b((?:{'|'.join(prefixes)})\w*)", e.key)
        if name:
            out[name[1]] = out.get(name[1], 0.0) + ms
    return out


def _fmt(parts: dict) -> str:
    return json.dumps({k: round(v, 4) for k, v in parts.items()},
                      separators=(",", ":"))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_scan_n1_bwd: needs a CUDA card")
    import chip_smoke as cs
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.ops import scan_n1 as sn
    from medical_image_analysis_tpu_torch.train.loop import build_mrg_model

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sn.build()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for stage, b, dtype in cs._n1_cases():
        hw, dim = cs.N1_STAGES[stage]
        args, d_in, rank = cs._n1_case(dev, gen, hw, dim, b, dtype)
        dy = torch.randn(2, b, hw * hw, d_in, device=dev,
                         generator=gen).to(dtype)
        ms = cs.device_ms(lambda: sn.scan_n1_bwd(*args, dy), 10)
        parts = kernel_ms(lambda: sn.scan_n1_bwd(*args, dy), 5, KERNELS[:1])
        extra = {}
        if hasattr(sn, "bwd_grid_blocks"):
            occupancy = sn.bwd_occupancy(rank, dtype)
            extra["grid_blocks"] = _fmt(sn.bwd_grid_blocks(b, hw * hw, d_in))
            extra["blocks_per_sm"] = _fmt(
                {k: v[0] for k, v in occupancy.items()})
            extra["smem_bytes"] = _fmt({k: v[1] for k, v in occupancy.items()})
        print(f"scan_n1_bwd stage={stage} B={b} L={hw * hw} D={d_in} "
              f"R={rank} {cs._dtype_name(dtype)} ms={ms:.4f} "
              f"profiled={_fmt(parts)} "
              + " ".join(f"{k}={v}" for k, v in extra.items()), flush=True)
        del args, dy
        torch.cuda.empty_cache()

    cfg = load_config(str(cs.CSR_PRESET),
                      [*cs.VSSM1_OVERRIDES, "model.llm_kwargs={n_layers: 1}"])
    model = build_mrg_model(cfg, 1000, device=dev)
    init_params(model, gen)
    studies, size = cfg.data.batch_size, cfg.data.input_size
    images = torch.randn(studies, cfg.data.num_views, size, size, 3,
                         device=dev, generator=gen)
    params = [p for n, p in model.named_parameters()
              if n.startswith(("vision.", "proj"))]
    cots = [torch.randn(o.shape, device=dev, generator=gen)
            for o in model.encode_img(images)]

    def step():
        return torch.autograd.grad(model.encode_img(images), params, cots)

    torch.cuda.reset_peak_memory_stats()
    ms = cs.device_ms(step, 3)
    parts = kernel_ms(step, 1)
    print(f"vssm1_base tower fwd+bwd images={studies * cfg.data.num_views} "
          f"{size}^2 blocks={sum(model.vision.vssm.depths)} ms={ms:.2f} "
          f"profiled={_fmt(parts)} "
          f"peak_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}",
          flush=True)


if __name__ == "__main__":
    main()
