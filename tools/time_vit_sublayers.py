#!/usr/bin/env python3
"""Device time of the port's four ViT sub-layer kernels at the mae_hd_1280
shapes, on one NVIDIA GPU, with their GEMMs' share and rate.

    python3 tools/time_vit_sublayers.py

Times the checkout this script sits in: ``vit_attn_fwd``, ``vit_mlp_fwd``,
``vit_attn_bwd`` and ``vit_mlp_bwd`` at the encoder (B=16, L=1,401,
d=768) and the decoder (B=16, L=6,401, d=512) in fp32, and the two
forwards at bench.py's bf16 encode (B=64, L=145, d=768): CUDA events over
5 calls (``chip_smoke.device_ms``), then one call under
``torch.profiler``, whose GEMM kernel (the tensor-core ``gemm_tc_kernel``)
gives the GEMM time and rate (the products over that time). It reads only
the ViT wrappers and ``chip_smoke``'s ``_vit_weights``, ``device_ms`` and
``_dtype_name``, which older checkouts of the port have too, so that two
versions can be compared on one card: unpack the other into a git-ignored
directory and run the script of each checkout in one call, in turns: A,
B, B, A (each copy counts the GEMM kernels of its own checkout). Random
weights and inputs from seed 0; TF32 off. Needs a CUDA card.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (B, L, d, heads, dtype)
SHAPES = ((16, 1401, 768, 12, torch.float32),
          (16, 6401, 512, 16, torch.float32),
          (64, 145, 768, 12, torch.bfloat16))
GEMMS = re.compile(r"(?<!\w)gemm_tc_kernel(?!\w)")


def gemm_ms(fn) -> float:
    """Device ms of the port's GEMM kernels in one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if GEMMS.search(e.key)) / 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_vit_sublayers: needs a CUDA card")
    import chip_smoke as cs
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    vb.build()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for b, l, d, heads, dtype in SHAPES:
        w = cs._vit_weights(d, heads, dtype, dev, gen)
        x = torch.randn(b, l, d, device=dev, generator=gen).to(dtype)
        dy = torch.randn(b, l, d, device=dev, generator=gen)
        rows = b * l
        # (name, operations of its GEMMs, call)
        calls = [("vit_attn_fwd", 8 * rows * d * d,
                  lambda: vb.attn_block_fwd(x, *w["attn"], heads)),
                 ("vit_mlp_fwd", 16 * rows * d * d,
                  lambda: vb.mlp_block_fwd(x, *w["mlp"]))]
        if dtype == torch.float32:  # the backwards are fp32 only
            calls += [("vit_attn_bwd", 22 * rows * d * d,
                       lambda: vb.attn_block_bwd(x, *w["attn"], heads, dy)),
                      ("vit_mlp_bwd", 40 * rows * d * d,
                       lambda: vb.mlp_block_bwd(x, *w["mlp"], dy))]
        for name, ops, fn in calls:
            ms = cs.device_ms(fn, 5)
            g = gemm_ms(fn)
            print(f"{name} B={b} L={l} d={d} {cs._dtype_name(dtype)} "
                  f"ms={ms:.4f} gemm_ms={g:.4f} "
                  f"gemm_tflops={ops / g / 1e9:.2f}", flush=True)
        del w, x, dy


if __name__ == "__main__":
    main()
