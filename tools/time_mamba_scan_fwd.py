#!/usr/bin/env python3
"""Device time of the fused Mamba layer's forward scan (``scan_fwd``), and
of the two towers that run it, on one NVIDIA GPU.

    python3 tools/time_mamba_scan_fwd.py [--kernels-only]

Times the checkout this script sits in (``--kernels-only``: the first
part alone):

- ``scan_fwd`` at every shape the main paths give it: an ARM-B layer of
  ``r2gengpt_mimic`` (K=4, L=197, D=768, N=16, R=48, with its conv) at the
  serving batch (B=1) and the training micro-batch (B=6), fp32 and bf16,
  and at validation's batches of 12 and 4 images, fp32; vssm_tiny's four
  stages at ``vssm_classify``'s B=128 and at its validation's 64 images,
  fp32 (K=4, no conv, N=16; L, D, R = 3,136, 192, 6 / 784, 384, 12 / 196,
  768, 24 / 49, 1,536, 48). CUDA events over 20 calls
  (``chip_smoke.device_ms``), taken ``RUNS`` times in a row (``ms`` is
  their median, ``ms_runs`` all of them), then 5 calls under
  ``torch.profiler`` for each kernel's share by name (a spin kernel on
  each side); ``xdbl_fwd``'s CUDA-event ms at the same shape; the chunk
  the wrapper picks, the grids' blocks and each kernel's resident blocks
  an SM and shared memory a block, where the checkout reports them.
- the vssm_tiny backbone's forward (11 SS2D blocks on the fused route) at
  ``vssm_classify``'s 128 images of 224^2, and the ARM-B tower of
  ``r2gengpt_mimic`` (``encode_img``: 12 layers and the projector) at its
  micro-batch of 3 samples x 2 views and at one image, all without a
  gradient: random weights and images on the card; CUDA events over 3
  calls, then one call under ``torch.profiler`` for the device time (the
  spin kernels left out) and the fused layer's kernels' share of it. At
  one image (a served request's tower) also the host's wall ms of a call
  waited for (the median of 20), and, where the checkout cuts L into
  chunks, all of it again with the cut path off (``fwd_chunk`` taking one
  pass over L at every shape), in turns: cut, one pass, cut, one pass.

It reads only ``chip_smoke``'s ``PRESET``, ``preset_layer``,
``_layer_weights``, ``device_ms``, ``vssm_bwd_case``, ``SS_VSSM_STAGES``,
``SS_VSSM_BATCH`` and ``LEARNABLE_VAL``, the fused layer's wrappers,
``build_vssm`` and ``build_mrg_model``, and the profiling helpers of
``tools/time_mamba_scan_bwd.py`` beside it, which the port's checkouts
since that script have too, so that two versions can be compared on one
card: unpack the other into a git-ignored directory, copy both scripts
into its ``tools/``, and run the script of each checkout in one call, in
turns: A, B, B, A. Random inputs from seed 0; TF32 off. Needs a CUDA
card.
"""

from __future__ import annotations

import contextlib
import itertools
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from time_mamba_scan_bwd import _fmt, _tower, kernel_ms  # noqa: E402

# Name prefixes of the forward's kernels in csrc/mamba_fused.cu: the chunk
# summaries and carries (the bodies of the backward's first two kernels
# without the adjoint) and the scan.
KERNELS = ("mamba_scan_sums", "mamba_scan_carry", "mamba_scan_kernel")
# The fused layer's kernels in a tower's forward profile.
TOWER_KERNELS = ("mamba_scan", "mamba_xdbl")
RUNS = 3  # CUDA-event timings of a scan_fwd case, one after the other


@contextlib.contextmanager
def _one_pass(mf):
    """``scan_fwd`` takes one chunk of all of L at every shape while the
    block runs: the cut path (summaries, carries, then the scan of each
    chunk) off."""
    chosen = mf.fwd_chunk
    mf.fwd_chunk = lambda b, k_dirs, seq_len, d_in, sms=0: seq_len
    try:
        yield
    finally:
        mf.fwd_chunk = chosen


def _wall_ms(fn, iters: int) -> float:
    """The host's wall ms of a call of ``fn`` waited for (what a caller
    that needs the result waits): the median over ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_mamba_scan_fwd: needs a CUDA card")
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
    mixer, arm_len, cls_pos = cs.preset_layer(cfg, dev, gen)
    w = cs._layer_weights(mixer)
    # (B, dtype): serving, the training micro-batch, validation's batches
    arm = [*itertools.product((1, 6), (torch.float32, torch.bfloat16)),
           (12, torch.float32), (4, torch.float32)]
    cases = []
    for b, dtype in arm:
        x = torch.randn(b, arm_len, mixer.d_inner, device=dev,
                        generator=gen).to(dtype)
        xc = mixer._col_major(x, cls_pos).contiguous()
        xargs = (x, xc, w["conv_w"], w["conv_b"], w["x_proj_w"], True)
        x_dbl = mf.xdbl_plain(*xargs)
        cases.append(("arm-b", b, xargs, (
            x, xc, x_dbl, w["conv_w"], w["conv_b"], w["dt_proj_w"],
            w["dt_bias"], w["A"], w["D"], True, True), mixer.rank))
    for batch, stage in itertools.product(
            (cs.SS_VSSM_BATCH, cs.LEARNABLE_VAL),
            range(len(cs.SS_VSSM_STAGES))):
        args, rank = cs.vssm_bwd_case(dev, gen, stage, batch)
        xr, xc, x_dbl, conv_w, conv_b = args[:5]
        wx = torch.randn(4, x_dbl.shape[-1], xr.shape[-1], device=dev,
                         generator=gen) * xr.shape[-1] ** -0.5
        cases.append((f"vssm_tiny_s{stage}", batch,
                      (xr, xc, conv_w, conv_b, wx, False),
                      (*args[:9], True, False), rank))
        del args
    for name, b, xargs, args, rank in cases:
        xr, dtype = args[0], args[0].dtype
        seq_len, d_in, n = xr.shape[1], args[7].shape[1], args[7].shape[2]
        runs = [cs.device_ms(lambda: mf.scan_fwd(*args), 20)
                for _ in range(RUNS)]
        ms = statistics.median(runs)
        parts = kernel_ms(lambda: mf.scan_fwd(*args), 5, KERNELS)
        xdbl_ms = cs.device_ms(lambda: mf.xdbl_fwd(*xargs), 20)
        extra = {}
        if hasattr(mf, "fwd_chunk"):
            extra["chunk"] = mf.fwd_chunk(b, 4, seq_len, d_in)
            extra["grid_blocks"] = _fmt(mf.fwd_grid_blocks(
                b, 4, seq_len, d_in, n, extra["chunk"]))
            occupancy = mf.fwd_occupancy(n, rank, dtype)
            extra["blocks_per_sm"] = _fmt(
                {k: v[0] for k, v in occupancy.items()})
            extra["smem_bytes"] = _fmt({k: v[1] for k, v in occupancy.items()})
        print(f"mamba_scan case={name} B={b} L={seq_len} D={d_in} N={n} "
              f"R={rank} {'fp32' if dtype == torch.float32 else 'bf16'} "
              f"ms={ms:.4f} ms_runs={'/'.join(f'{t:.4f}' for t in runs)} "
              f"profiled={_fmt(parts)} xdbl_ms={xdbl_ms:.4f} "
              + " ".join(f"{k}={v}" for k, v in extra.items()), flush=True)
    del cases, args, xargs
    torch.cuda.empty_cache()
    if "--kernels-only" in sys.argv[1:]:
        return

    model = build_vssm("vssm_tiny", device=dev)
    init_params(model, gen)
    images = torch.randn(cs.SS_VSSM_BATCH, 224, 224, 3, device=dev,
                         generator=gen)
    with torch.no_grad():
        _tower("vssm_tiny backbone fwd", lambda: model(images),
               f"images={cs.SS_VSSM_BATCH} 224^2 "
               f"blocks={sum(model.depths)}", cs.device_ms, TOWER_KERNELS)
    del model, images
    torch.cuda.empty_cache()

    cfg = load_config(str(cs.PRESET), ["model.llm_kwargs={n_layers: 1}"])
    model = build_mrg_model(cfg, 1000, device=dev)
    init_params(model, gen)
    size = cfg.data.input_size
    micro = cfg.data.batch_size // cfg.train.accum_steps
    layers = len(model.vision.arm.layers)
    images = torch.randn(micro, cfg.data.num_views, size, size, 3,
                         device=dev, generator=gen)
    with torch.no_grad():
        _tower("arm-b tower fwd", lambda: model.encode_img(images),
               f"images={micro * cfg.data.num_views} {size}^2 "
               f"layers={layers}", cs.device_ms, TOWER_KERNELS)
    images = torch.randn(1, 1, size, size, 3, device=dev, generator=gen)
    modes = [("", contextlib.nullcontext)]
    if hasattr(mf, "fwd_chunk"):
        modes = [("", contextlib.nullcontext),
                 (" one-pass", lambda: _one_pass(mf))] * 2
    for label, mode in modes:
        with torch.no_grad(), mode():
            shape = f"images=1 {size}^2 layers={layers}"
            _tower(f"arm-b tower fwd{label}",
                   lambda: model.encode_img(images), shape, cs.device_ms,
                   TOWER_KERNELS)
            print(f"arm-b tower fwd{label} {shape} wall_ms="
                  f"{_wall_ms(lambda: model.encode_img(images), 20):.3f}",
                  flush=True)


if __name__ == "__main__":
    main()
