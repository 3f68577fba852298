#!/usr/bin/env python3
"""Device time of the d_state=1 scan's forward (``scan_n1_fwd``), and of
the vssm1_base tower's forward, on one NVIDIA GPU.

    python3 tools/time_scan_n1_fwd.py [--kernels-only]

Times the checkout this script sits in (``--kernels-only``: the first
part alone):

- ``scan_n1_fwd`` at every shape the main paths give it
  (``chip_smoke._n1_cases(N1_FWD_BATCHES)``: vssm1_base's four stages at
  the training step's 12 images, the context tower's 36 and validation's
  4, in fp32; stage 2 at 12 in bf16; stage 0 at one image): CUDA events
  over 20 calls (``chip_smoke.device_ms``), taken ``RUNS`` times in a row
  (``ms`` is their median, ``ms_runs`` all of them), then 5 calls under
  ``torch.profiler`` for each kernel's share by name (a spin kernel on
  each side); the bound (``chip_smoke._bound``, as ``kernels_n1`` takes
  it), the call's launches in ``chip_smoke.py``'s ``train_csr`` and
  launches x (ms - bound), summed over the shapes at the end. Where the
  checkout picks a regime per call (``fwd_chunk``), also the chunk it
  picks, the grids' blocks, each kernel's resident blocks an SM and shared
  memory a block, and the sweep behind the choice: the call timed with
  each regime forced, in turns (one pass, chunks, chunks, one pass).
- the vssm1_base tower of ``r2gencsr_iu`` (``R2GenCSR.encode_img``: 21
  SS2D blocks and the projector) forward without a gradient at the
  training step's 6 studies x 2 views of 224^2, and its context tower
  (``vision`` alone) at 36 images, random weights and images on the card:
  CUDA events over 3 calls, then one call under ``torch.profiler`` for
  the scan kernels' share of the device time.

It reads only ``chip_smoke``'s ``_n1_cases``, ``_n1_case``, ``N1_STAGES``,
``N1_FWD_BATCHES``, ``device_ms``, ``_bound``, ``_dtype_name``,
``CSR_PRESET`` and ``VSSM1_OVERRIDES``, the scan's wrappers,
``build_mrg_model`` and the profiling helpers of
``tools/time_mamba_scan_bwd.py`` beside it, which older checkouts of the
port have too, so that two versions can be compared on one card: unpack
the other into a git-ignored directory, copy this script into its
``tools/``, and run the script of each checkout in one call, in turns: A,
B, B, A. Random inputs from seed 0; TF32 off. Needs a CUDA card.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from time_mamba_scan_bwd import _fmt, _tower, kernel_ms  # noqa: E402

# The prefix of every forward kernel's name in csrc/scan_n1.cu.
KERNELS = ("scan_n1_fwd",)
RUNS = 3  # CUDA-event timings of a case, one after the other
# vssm1_base's SS2D blocks by stage, and the scan_n1_fwd calls each block
# makes in chip_smoke.py's train_csr (5 steps and 2 validation batches) by
# batch: 12 images (the 5 steps' towers, the first validation batch's, and
# the last validation batch's context), 36 (the context towers of the 5
# steps and of the first validation batch: 6 studies x 6 images), 4 (the
# last validation batch's tower). 14 a block, 294 in all.
DEPTHS = (2, 2, 15, 2)
CALLS_A_BLOCK = {12: 7, 36: 6, 4: 1}


@contextlib.contextmanager
def _regime(sn, chunked: bool):
    """``scan_n1_fwd`` in one regime at every shape while the block runs:
    chunks of ``_CHUNK`` rows (``chunked``) or one pass over L."""
    chosen = sn.fwd_chunk
    sn.fwd_chunk = (lambda b, seq_len, d_in, sms=0:
                    min(sn._CHUNK, seq_len) if chunked else seq_len)
    try:
        yield
    finally:
        sn.fwd_chunk = chosen


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_scan_n1_fwd: needs a CUDA card")
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
    total = 0.0
    for stage, b, dtype in cs._n1_cases(cs.N1_FWD_BATCHES):
        hw, dim = cs.N1_STAGES[stage]
        seq_len = hw * hw
        args, d_in, rank = cs._n1_case(dev, gen, hw, dim, b, dtype)

        def call():
            return sn.scan_n1_fwd(*args)

        runs = [cs.device_ms(call, 20) for _ in range(RUNS)]
        ms = statistics.median(runs)
        parts = kernel_ms(call, 5, KERNELS)
        y = call()
        bound = cs._bound([*args, y], 4 * b * seq_len * d_in * (2 * rank + 13))
        calls = (DEPTHS[stage] * CALLS_A_BLOCK.get(b, 0)
                 if dtype == torch.float32 else 0)
        total += calls * (ms - bound[0])
        extra = {}
        if hasattr(sn, "fwd_chunk"):
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            chunk = sn.fwd_chunk(b, seq_len, d_in, sms)
            extra["chunk"] = chunk
            extra["grid_blocks"] = _fmt(sn.fwd_grid_blocks(b, seq_len, d_in,
                                                           chunk))
            occupancy = sn.fwd_occupancy(rank, dtype, chunk < seq_len)
            extra["blocks_per_sm"] = _fmt(
                {k: v[0] for k, v in occupancy.items()})
            extra["smem_bytes"] = _fmt({k: v[1] for k, v in occupancy.items()})
            sweep = {"one_pass": 0.0, "chunked": 0.0}
            for name in ("one_pass", "chunked", "chunked", "one_pass"):
                with _regime(sn, name == "chunked"):
                    sweep[name] += cs.device_ms(call, 20) / 2
            extra["sweep_ms"] = _fmt(sweep)
        print(f"scan_n1_fwd stage={stage} B={b} L={seq_len} D={d_in} "
              f"R={rank} {cs._dtype_name(dtype)} ms={ms:.4f} "
              f"ms_runs={'/'.join(f'{t:.4f}' for t in runs)} "
              f"bound_ms={bound[0]:.4f} bound_by={bound[1]} launches={calls} "
              f"x_ms_minus_bound={calls * (ms - bound[0]):.2f} "
              f"profiled={_fmt(parts)} "
              + " ".join(f"{k}={v}" for k, v in extra.items()), flush=True)
        del args, y
        torch.cuda.empty_cache()
    print(f"scan_n1_fwd launches x (ms - bound), summed: {total:.2f}",
          flush=True)
    if "--kernels-only" in sys.argv[1:]:
        return

    cfg = load_config(str(cs.CSR_PRESET),
                      [*cs.VSSM1_OVERRIDES, "model.llm_kwargs={n_layers: 1}"])
    model = build_mrg_model(cfg, 1000, device=dev)
    init_params(model, gen)
    studies, size = cfg.data.batch_size, cfg.data.input_size
    blocks = sum(model.vision.vssm.depths)
    images = torch.randn(studies, cfg.data.num_views, size, size, 3,
                         device=dev, generator=gen)
    context = torch.randn(36, size, size, 3, device=dev, generator=gen)
    with torch.no_grad():
        _tower("vssm1_base tower fwd", lambda: model.encode_img(images),
               f"images={studies * cfg.data.num_views} {size}^2 "
               f"blocks={blocks}", cs.device_ms, ("scan_n1",))
        _tower("vssm1_base context tower fwd",
               lambda: model.vision(context, True),
               f"images={context.shape[0]} {size}^2 blocks={blocks}",
               cs.device_ms, ("scan_n1",))


if __name__ == "__main__":
    main()
