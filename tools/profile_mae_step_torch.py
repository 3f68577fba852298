#!/usr/bin/env python3
"""Where a training step of the port's mae_hd_1280 spends its time, on one
NVIDIA GPU.

    python3 tools/profile_mae_step_torch.py [--batch 16] [--warmup 2]

Builds the preset as ``train.loop.fit_mae`` does (random weights from seed
0; random images on the card, so that data loading is left out), runs
``--warmup`` training steps, then times one step by CUDA events per part
(encoder forward, decoder forward + loss, decoder backward, encoder
backward, AdamW) and profiles one more with ``torch.profiler``: the
device time of each kernel family, and the device's busy share of the
step's wall time. Prints the card, one line per part and a JSON line.
Needs a CUDA card; TF32 stays off, as in training.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PRESET = ROOT / "medical_image_analysis_tpu" / "configs" / "presets" / "mae_hd_1280.yaml"
# kernel families by name; the rest are PyTorch's own kernels
FAMILIES = (("vit gemm", "gemm_kernel"), ("vit attention fwd", "attn_fwd_kernel"),
            ("vit attention dK/dV", "attn_dkv_kernel"),
            ("vit attention dQ", "attn_dq_kernel"),
            ("vit LN and sums", ("ln_stats_kernel", "ln_bwd_kernel",
                                 "colsum_kernel")))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_mae_step_torch: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.train.loop import (
        build_mae_model,
        mae_mask_noise,
    )
    from medical_image_analysis_tpu_torch.train.optim import (
        make_adamw,
        scaled_lr,
        warmup_cosine,
    )

    dev = torch.device("cuda")
    cfg = load_config(str(PRESET))
    m, size = cfg.model, cfg.data.input_size
    model = build_mae_model(cfg, dev)
    gen = torch.Generator(dev).manual_seed(0)
    init_params(model, gen)
    named = flax_named_parameters(model)
    names, tensors = list(named), list(named.values())
    tx = make_adamw(named, warmup_cosine(scaled_lr(cfg.train.blr, args.batch),
                                         1, 100))
    imgs = torch.randn(args.batch, size, size, 3, device=dev, generator=gen)
    l = model.num_patches(imgs)

    def step(i, events=None):
        noise = mae_mask_noise(0, i, args.batch, l, dev)
        mark = (lambda k: events[k].record()) if events else (lambda k: None)
        mark(0)
        latent, mask, ids = model.encode(imgs, noise, m.mask_type,
                                         m.mask_ratio, m.mask_ratio_inner,
                                         deterministic=False)
        mark(1)
        if events:
            latent.register_hook(lambda g: mark(3))
        pred = model.decode(latent, ids, deterministic=False)
        loss = model.loss(imgs, pred, mask)
        mark(2)
        grads = torch.autograd.grad(loss, tensors)
        mark(4)
        tx.step(dict(zip(names, grads)))
        mark(5)
        return loss

    for i in range(args.warmup):
        step(i)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    t0 = time.perf_counter()
    loss = step(args.warmup, events).item()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    parts = {"encoder forward": (0, 1), "decoder forward + loss": (1, 2),
             "decoder backward": (2, 3), "encoder backward": (3, 4),
             "AdamW": (4, 5)}
    times = {k: events[a].elapsed_time(events[b]) for k, (a, b) in parts.items()}

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(args.warmup + 1)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    families = {name: 0.0 for name, _ in FAMILIES}
    families["other (PyTorch kernels, copies)"] = 0.0
    launches = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0:
            continue
        launches += e.count
        for name, keys in FAMILIES:
            if any(k in e.key for k in ((keys,) if isinstance(keys, str)
                                        else keys)):
                families[name] += us / 1e3
                break
        else:
            families["other (PyTorch kernels, copies)"] += us / 1e3
    busy = sum(families.values())
    for k, v in times.items():
        print(f"part: {k} ms={v:.3f}")
    for k, v in families.items():
        print(f"kernels: {k} ms={v:.3f}")
    print(f"step: batch={args.batch} loss={loss:.4f} wall_ms={wall_ms:.1f} "
          f"profiled_wall_ms={prof_wall_ms:.1f} device_busy_ms={busy:.1f} "
          f"busy_share={busy / prof_wall_ms:.4f} launches={launches} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}")
    print(json.dumps({"parts_ms": times, "kernels_ms": families,
                      "wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
                      "device_busy_ms": busy, "launches": launches}))


if __name__ == "__main__":
    main()
