#!/usr/bin/env python3
"""Device time of the fused Mamba layer's backward (``scan_bwd``), and of
the two towers that train through it, on one NVIDIA GPU.

    python3 tools/time_mamba_scan_bwd.py [--kernels-only]

Times the checkout this script sits in (``--kernels-only``: the first
part alone):

- ``scan_bwd`` at the main paths' shapes: an ARM-B layer of
  ``r2gengpt_mimic`` at the training micro-batch (B=6, L=197, D=768, N=16,
  R=48) in fp32 and bf16, and vssm_tiny's four stages at
  ``vssm_classify``'s B=128 in fp32 (K=4, no conv, N=16; L, D, R = 3,136,
  192, 6 / 784, 384, 12 / 196, 768, 24 / 49, 1,536, 48): CUDA events over
  10 calls (``chip_smoke.device_ms``), then 5 calls under ``torch.profiler``
  for each kernel's share by name; the grids' blocks and each kernel's
  resident blocks an SM and shared memory a block, where the checkout
  reports them;
- the vssm_tiny backbone (11 SS2D blocks on the fused route) forward and
  backward at ``vssm_classify``'s 128 images of 224^2, and the ARM-B tower
  of ``r2gengpt_mimic`` (``encode_img``: 12 layers, remat, and the
  projector) at its micro-batch of 3 samples x 2 views: random weights,
  images and cotangents on the card; CUDA events over 3 calls, then one
  call under ``torch.profiler`` for the device time (the spin kernels
  left out) and the fused layer's kernels' share of it.

It reads only ``chip_smoke``'s ``PRESET``, ``preset_layer``,
``_layer_weights``, ``device_ms``, ``vssm_bwd_case``, ``SS_VSSM_STAGES``
and ``SS_VSSM_BATCH``, the fused layer's wrappers, ``build_vssm`` and
``build_mrg_model``, which the port's checkouts since this script have
too, so that two versions can be compared on one card: unpack the other
into a git-ignored directory, copy this script into its ``tools/``, and
run the script of each checkout in one call, in turns: A, B, B, A. Random
inputs from seed 0; TF32 off. Needs a CUDA card.
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

# The prefix of every backward kernel's name in csrc/mamba_fused.cu.
KERNELS = ("mamba_scan_bwd",)
# The fused layer's kernels in a tower's profile: the backward's, then the
# forward's (``mamba_scan`` would also match the backward's names).
TOWER_KERNELS = ("mamba_scan_bwd", "mamba_scan_kernel", "mamba_scan_sums",
                 "mamba_scan_carry", "mamba_xdbl")
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
        raise SystemExit("time_mamba_scan_bwd: needs a CUDA card")
    import chip_smoke as cs
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.vmamba import build_vssm
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
    from medical_image_analysis_tpu_torch.train.loop import build_mrg_model

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mf.build()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    cfg = load_config(str(cs.PRESET))
    mixer, seq_len, cls_pos = cs.preset_layer(cfg, dev, gen)
    w = cs._layer_weights(mixer)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(6, seq_len, mixer.d_inner, device=dev,
                        generator=gen).to(dtype)
        xc = mixer._col_major(x, cls_pos).contiguous()
        x_dbl = mf.xdbl_plain(x, xc, w["conv_w"], w["conv_b"], w["x_proj_w"])
        dy = torch.randn(6, mixer.k, seq_len, mixer.d_inner, device=dev,
                         generator=gen).to(dtype)
        cases.append(("arm-b", 6, (x, xc, x_dbl, w["conv_w"], w["conv_b"],
                                   w["dt_proj_w"], w["dt_bias"], w["A"],
                                   w["D"], dy), mixer.rank))
    for stage in range(len(cs.SS_VSSM_STAGES)):
        cases.append((f"vssm_tiny_s{stage}", cs.SS_VSSM_BATCH,
                      *cs.vssm_bwd_case(dev, gen, stage, cs.SS_VSSM_BATCH)))
    for name, b, args, rank in cases:
        xr, dtype = args[0], args[0].dtype
        d_in, n = args[7].shape[1], args[7].shape[2]
        ms = cs.device_ms(lambda: mf.scan_bwd(*args), 10)
        parts = kernel_ms(lambda: mf.scan_bwd(*args), 5)
        extra = {}
        if hasattr(mf, "bwd_grid_blocks"):
            occupancy = mf.bwd_occupancy(n, rank, dtype)
            extra["grid_blocks"] = _fmt(mf.bwd_grid_blocks(
                b, 4, xr.shape[1], d_in, n))
            extra["blocks_per_sm"] = _fmt(
                {k: v[0] for k, v in occupancy.items()})
            extra["smem_bytes"] = _fmt({k: v[1] for k, v in occupancy.items()})
        print(f"mamba_scan_bwd case={name} B={b} L={xr.shape[1]} D={d_in} "
              f"N={n} R={rank} "
              f"{'fp32' if dtype == torch.float32 else 'bf16'} ms={ms:.4f} "
              f"profiled={_fmt(parts)} "
              + " ".join(f"{k}={v}" for k, v in extra.items()), flush=True)
    del cases, args
    torch.cuda.empty_cache()
    if "--kernels-only" in sys.argv[1:]:
        return

    model = build_vssm("vssm_tiny", device=dev)
    init_params(model, gen)
    images = torch.randn(cs.SS_VSSM_BATCH, 224, 224, 3, device=dev,
                         generator=gen)
    params = list(model.parameters())
    cot = torch.randn(cs.SS_VSSM_BATCH, model.dims[-1], device=dev,
                      generator=gen)
    _tower("vssm_tiny backbone fwd+bwd", lambda: torch.autograd.grad(
        model(images), params, cot), f"images={cs.SS_VSSM_BATCH} 224^2 "
        f"blocks={sum(model.depths)}", cs.device_ms)
    del model, images, params, cot
    torch.cuda.empty_cache()

    cfg = load_config(str(cs.PRESET), ["model.llm_kwargs={n_layers: 1}"])
    model = build_mrg_model(cfg, 1000, device=dev)
    init_params(model, gen)
    micro = cfg.data.batch_size // cfg.train.accum_steps
    size = cfg.data.input_size
    images = torch.randn(micro, cfg.data.num_views, size, size, 3,
                         device=dev, generator=gen)
    params = [p for n, p in model.named_parameters()
              if n.startswith(("vision.", "proj"))]
    cot = torch.randn(model.encode_img(images).shape, device=dev,
                      generator=gen)
    _tower("arm-b tower fwd+bwd", lambda: torch.autograd.grad(
        model.encode_img(images), params, cot),
        f"images={micro * cfg.data.num_views} {size}^2 "
        f"layers={len(model.vision.arm.layers)}", cs.device_ms)


def _tower(what: str, step, shape: str, device_ms,
           prefixes=TOWER_KERNELS) -> None:
    """A tower's call: CUDA-event ms, the profiled device time by the
    fused layer's kernels (names starting with one of ``prefixes``), and
    the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    ms = device_ms(step, 3)
    parts = kernel_ms(step, 1, prefixes)
    print(f"{what} {shape} ms={ms:.2f} profiled={_fmt(parts)} "
          f"peak_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}",
          flush=True)


if __name__ == "__main__":
    main()
