#!/usr/bin/env python3
"""Device time of the general selective scan's forward
(``selective_scan_fwd``), and of the vssm_tiny backbone's forward on
``scan_backend: pallas``, on one NVIDIA GPU.

    python3 tools/time_selective_scan_fwd.py [--kernels-only]

Times the checkout this script sits in (``--kernels-only``: the first
part alone):

- ``selective_scan_fwd`` at every shape the main paths give it: ARM-B's
  layers (K=4, L=197, d_inner 768, d_state 16) at one image and at the
  training micro-batch of 6, fp32 and bf16; vssm_tiny's four stages at
  ``vssm_classify``'s batch of 128 and its validation batch of 64, fp32,
  stage 0 at 128 also in bf16. CUDA events over 20 calls at ARM-B and 5
  elsewhere (``chip_smoke.device_ms``), taken ``RUNS`` times in a row
  (``ms`` is their median), the bound (``chip_smoke._bound`` of
  ``selective_scan_pallas.flops``, as ``kernels_ss`` takes it), the
  call's launches on the main paths and launches x (ms - bound), summed
  at the end. Where the checkout has ``fwd_occupancy``, also the
  kernel's grid blocks, resident blocks an SM, shared memory a block and
  the waves the grid makes.
- vssm_tiny's backbone (random weights from the seed, 128 images of
  224^2 on the card) forward without a gradient on ``scan_backend:
  pallas``: CUDA events over 3 calls, then one call under
  ``torch.profiler`` for the scan forward's share.

When it builds the kernels it first prints the registers and spills
that ptxas reports for each instantiation of the forward kernel.

It reads only ``chip_smoke``'s ``_ss_case``, ``device_ms``, ``_bound``,
``_dtype_name``, ``SS_ARM`` and ``SS_VSSM_STAGES``, the scan's wrapper and
``flops``, ``build_vssm`` and the profiling helpers of
``tools/time_mamba_scan_bwd.py`` beside it, which older checkouts of the
port have too, so that two versions can be compared on one card: unpack
the other into a git-ignored directory, copy this script into its
``tools/``, and run the script of each checkout in one call, in turns: A,
B, B, A. Random inputs from seed 0; TF32 off. Needs a CUDA card.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from time_mamba_scan_bwd import _fmt, _tower, kernel_ms  # noqa: E402

# The prefix of every forward kernel's name in csrc/selective_scan.cu.
KERNELS = ("selective_scan_fwd",)
RUNS = 3  # CUDA-event timings of a case, one after the other
# The launches of each shape on the main paths: vssm_classify on
# scan_backend pallas (chip_smoke.py's train_cls_vssm_pallas: 2 steps at
# B=128 and one validation batch of 64; vssm_tiny's SS2D blocks by stage
# 2, 2, 5, 2, a forward each a call), and ARM-B's 12 layers in the tower
# of a training micro-batch of 6 images, each forward twice (remat), in
# fp32. ARM-B at one image is a serving shape that the pallas route does
# not take on a main path, and no main path runs the scan in bf16: timed,
# 0 launches.
VSSM_DEPTHS = (2, 2, 5, 2)
VSSM_CALLS = {128: 2, 64: 1}
ARM_CALLS = {6: 24, 1: 0}


def _cases(cs):
    """(case, batch, K, L, D, N, dtype, launches on the main paths)."""
    k, l, d, n = cs.SS_ARM
    out = [("arm_b", b, k, l, d, n, dtype,
            ARM_CALLS[b] if dtype == torch.float32 else 0)
           for b in (1, 6) for dtype in (torch.float32, torch.bfloat16)]
    for b in (128, 64):
        out += [(f"vssm_tiny_s{i}", b, 4, sl, sd, 16, torch.float32,
                 VSSM_DEPTHS[i] * VSSM_CALLS[b])
                for i, (sl, sd) in enumerate(cs.SS_VSSM_STAGES)]
    sl, sd = cs.SS_VSSM_STAGES[0]
    return out + [("vssm_tiny_s0", 128, 4, sl, sd, 16, torch.bfloat16, 0)]


def _ptxas(log: str) -> None:
    """The registers and spills of the forward kernel in nvcc's log."""
    for m in re.finditer(
            r"Compiling entry function '(\w+)'.*\n.*\n\s*\d+ bytes stack "
            r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n"
            r".*Used (\d+) registers", log):
        name = re.search(r"(selective_scan_fwd_kernel)I(\w+?)Li(\d+)E",
                         m[1])
        if name:
            src = "bf16" if "bfloat16" in name[2] else "fp32"
            print(f"ptxas {name[1]} {src} N={name[3]} registers={m[4]} "
                  f"spill_stores={m[2]} spill_loads={m[3]}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_selective_scan_fwd: needs a CUDA card")
    import chip_smoke as cs
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.vmamba import build_vssm
    from medical_image_analysis_tpu_torch.ops import selective_scan_pallas as ssp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _ptxas(ssp.build()[1])
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    total = 0.0
    for case, b, k, l, d, n, dtype, calls in _cases(cs):
        args = cs._ss_case(dev, gen, b, k, l, d, n, dtype)
        iters = 20 if case == "arm_b" else 5

        def call():
            return ssp.selective_scan_fwd(*args, True)

        runs = [cs.device_ms(call, iters) for _ in range(RUNS)]
        ms = statistics.median(runs)
        parts = kernel_ms(call, 3, KERNELS)
        y = call()
        bound = cs._bound([*args, y], ssp.flops("fwd", b * k, l, d, n))
        total += calls * (ms - bound[0])
        extra = {}
        if hasattr(ssp, "fwd_occupancy"):
            blocks, smem = ssp.fwd_occupancy(n, dtype)
            grid = ssp.fwd_grid_blocks(b * k, d)
            extra = dict(grid_blocks=grid, blocks_per_sm=blocks,
                         smem_bytes=smem,
                         waves=f"{grid / (blocks * sms):.2f}")
        print(f"selective_scan_fwd case={case} B={b} K={k} L={l} D={d} N={n} "
              f"{cs._dtype_name(dtype)} ms={ms:.4f} "
              f"ms_runs={'/'.join(f'{t:.4f}' for t in runs)} "
              f"bound_ms={bound[0]:.4f} bound_by={bound[1]} launches={calls} "
              f"x_ms_minus_bound={calls * (ms - bound[0]):.2f} "
              f"profiled={_fmt(parts)} "
              + " ".join(f"{k_}={v}" for k_, v in extra.items()), flush=True)
        del args, y
        torch.cuda.empty_cache()
    print(f"selective_scan_fwd launches x (ms - bound), summed: {total:.2f}",
          flush=True)
    if "--kernels-only" in sys.argv[1:]:
        return

    model = build_vssm("vssm_tiny", scan_backend="pallas", device=dev)
    init_params(model, gen)
    images = torch.randn(128, 224, 224, 3, device=dev, generator=gen)
    with torch.no_grad():
        _tower("vssm_tiny backbone fwd (pallas)", lambda: model(images),
               f"images=128 224^2 blocks={sum(model.depths)}", cs.device_ms,
               KERNELS)


if __name__ == "__main__":
    main()
