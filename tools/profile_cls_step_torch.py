#!/usr/bin/env python3
"""Where a training step and a validation batch of the port's swinchex
preset spend their time, on one NVIDIA GPU.

    python3 tools/profile_cls_step_torch.py [--batch 64] [--warmup 2]

Builds SwinCheX as ``train.loop.fit_classify`` does (swin_large, 14
two-way heads, 224^2, random weights from seed 0; random images and soft
labels on the card, so that data loading and mixup are left out), runs
``--warmup`` training steps, then times one step by CUDA events per part
(forward + loss, backward, AdamW) and one validation batch (no gradient:
every block through the Swin kernel), and profiles one more of each with
``torch.profiler``: the device time of each kernel family, and the
device's busy share of the wall time. Prints the card, one line per part
and family, and a JSON line. Needs a CUDA card; TF32 stays off, as in
training.
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

PRESET = (ROOT / "medical_image_analysis_tpu_torch" / "configs" / "presets"
          / "swinchex.yaml")
# Kernel families by a substring of the name, the first that matches: the
# port's own first (every __global__ of csrc/swin_block.cu and the
# csrc/vit_block.cu kernels that swin_attn_fwd launches), then PyTorch's.
# The Swin GEMM stays ahead of cuBLAS's, whose bare "gemm" would take
# gemm_tc_kernel too.
FAMILIES = (
    ("swin window core", ("swin_attn_core_kernel",)),
    ("swin sub-layer GEMM (vit_block.cu)", ("gemm_tc_kernel",)),
    ("swin LayerNorm (vit_block.cu)", ("ln_stats_kernel", "ln_apply_kernel")),
    ("cuBLAS GEMM", ("gemm", "Kernel2")),
    ("cuDNN convolution", ("conv", "wgrad", "dgrad")),
    ("softmax", ("softmax",)),
    ("layer norm", ("layer_norm",)),
    ("reductions", ("reduce",)),
    ("elementwise and copies", ("elementwise", "copy", "Memcpy", "Memset",
                                "cat", "roll", "index")),
)
OTHER = "other"


def family(kernel: str) -> str:
    """The family of a kernel, by its (demangled) name: the first of
    ``FAMILIES`` with a key inside it, else ``OTHER``."""
    for name, keys in FAMILIES:
        if any(k in kernel for k in keys):
            return name
    return OTHER


def _families(prof) -> tuple[dict, int]:
    out = {name: 0.0 for name, _ in FAMILIES}
    out[OTHER] = 0.0
    launches = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0:
            continue
        launches += e.count
        out[family(e.key)] += us / 1e3
    return out, launches


def _profiled(fn) -> tuple[dict, float, int]:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families, launches = _families(prof)
    return families, wall_ms, launches


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_cls_step_torch: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.ops import swin_block as sb
    from medical_image_analysis_tpu_torch.train.loop import build_classifier
    from medical_image_analysis_tpu_torch.train.optim import (
        make_adamw,
        warmup_cosine,
    )

    dev = torch.device("cuda")
    cfg = load_config(str(PRESET))
    t = cfg.train
    model, loss_head, _ = build_classifier(cfg, dev)
    gen = torch.Generator(dev).manual_seed(0)
    init_params(model, gen)
    named = flax_named_parameters(model)
    names, tensors = list(named), list(named.values())
    tx = make_adamw(named, warmup_cosine(t.lr, 1, 100),
                    weight_decay=t.weight_decay, grad_clip=t.grad_clip)
    size = cfg.data.input_size
    imgs = torch.randn(args.batch, size, size, 3, device=dev, generator=gen)
    labels = torch.rand(args.batch, 14, device=dev, generator=gen)

    def step(events=None):
        mark = (lambda k: events[k].record()) if events else (lambda k: None)
        mark(0)
        loss = loss_head(model(imgs), labels)
        mark(1)
        grads = torch.autograd.grad(loss, tensors)
        mark(2)
        tx.step(dict(zip(names, grads)))
        mark(3)
        return loss

    def validate():
        with torch.no_grad():
            return model(imgs)

    for _ in range(args.warmup):
        step()
        validate()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    t0 = time.perf_counter()
    loss = step(events).item()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    parts = {"forward + loss": (0, 1), "backward": (1, 2), "AdamW": (2, 3)}
    times = {k: events[a].elapsed_time(events[b]) for k, (a, b) in
             parts.items()}
    v0, v1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    sb.reset_launches()
    v0.record()
    validate()
    v1.record()
    torch.cuda.synchronize()
    times["validation batch"] = v0.elapsed_time(v1)
    val_launches = sb.launches["swin_attn_fwd"]

    report = {}
    for name, fn in (("train step", step), ("validation batch", validate)):
        families, prof_ms, launches = _profiled(fn)
        busy = sum(families.values())
        report[name] = {"kernels_ms": families, "profiled_wall_ms": prof_ms,
                        "device_busy_ms": busy, "launches": launches}
        for k, v in families.items():
            print(f"kernels: {name}: {k} ms={v:.3f}")
        print(f"profiled: {name} wall_ms={prof_ms:.1f} device_busy_ms="
              f"{busy:.1f} busy_share={busy / prof_ms:.4f} "
              f"launches={launches}")
    for k, v in times.items():
        print(f"part: {k} ms={v:.3f}")
    print(f"step: batch={args.batch} loss={loss:.4f} wall_ms={wall_ms:.1f} "
          f"swin_kernel_launches_per_val_batch={val_launches} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}")
    print(json.dumps({"parts_ms": times, "wall_ms": wall_ms, **report}))


if __name__ == "__main__":
    main()
