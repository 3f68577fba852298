#!/usr/bin/env python3
"""Device time of the fused Mamba layer's x_proj product (``xdbl_fwd``), at
every shape the main paths give it, on one NVIDIA GPU.

    python3 tools/time_xdbl.py [--sweep] [--kernels-only]

Times the checkout this script sits in:

- ``xdbl_fwd`` at an ARM-B layer of ``r2gengpt_mimic`` (K=4, L=197,
  D=768, C=80, a conv of 4 taps) at the serving batch (B=1) and the
  training micro-batch (B=6), fp32 and bf16 sources, and at validation's
  12 and 4 images, fp32; and at vssm_tiny's four stages (K=4, no conv; L,
  D, C = 3,136, 192, 38 / 784, 384, 44 / 196, 768, 56 / 49, 1,536, 80)
  at ``vssm_classify``'s B=128 and its validation's 64, fp32; and at
  AM-MRG's ARM-L layer (K=4, L=197, D=1,024, C=96: dt rank 64, a conv of
  4 taps) at its training step's 12 images, validation's 4 and one
  image, fp32. Random
  inputs from seed 0 (sources N(0, 1), silu(N(0, 1)) for vssm_tiny as
  SS2D feeds them; weights N(0, 1/D)). For each: the CUDA-event ms of
  ``chip_smoke.device_ms`` (the median of ``RUNS`` timings of 20 calls,
  all of them printed), ``xdbl_plain``'s ms (the median of ``RUNS``
  timings of 3 calls; TF32 off, so its einsum runs in fp32 on cuBLAS),
  the kernel's largest error against it, the bound at the tensor-core
  rate (``chip_smoke._bound``: the sources, weights and x_dbl once at
  3.35 TB/s, the 2 B K L C D products at 165 TFLOP/s in 3xTF32, the conv
  and SiLU's 13 operations an element at 67), the main paths' launches
  of the shape (``LAUNCHES``) and launches x (ms - bound), summed at the
  end. Where the checkout has them, the tile ``xdbl_tile`` picks, the
  grid's blocks, and the kernel's resident blocks an SM and shared
  memory a block.
- ``--sweep`` (a checkout with ``xdbl_tile``): every shape again at each
  (rows, directions a block) the kernel takes, and where one range of D
  gives the card fewer than two blocks an SM at 2, 4 and 8 ranges,
  ``xdbl_tile`` patched.
- the vssm_tiny backbone's forward (11 SS2D blocks on the fused route)
  at 128 images of 224^2, and the ARM-B tower of ``r2gengpt_mimic``
  (``encode_img``: 12 layers and the projector) at its micro-batch of 3
  samples x 2 views, without a gradient: CUDA events over 3 calls and
  one profiled call split by the fused layer's kernels
  (``tools/time_mamba_scan_bwd.py``'s ``_tower``). ``--kernels-only``
  leaves them out.

It reads only ``xdbl_fwd`` and ``xdbl_plain``, ``chip_smoke``'s
``device_ms``, ``_bound``, ``PRESET``, ``SS_VSSM_STAGES`` and
``SS_VSSM_BATCH``, ``build_vssm``, ``build_mrg_model`` and
``tools/time_mamba_scan_bwd.py``'s ``_tower``, which every checkout of
the port that has that script has too, so that two versions can be
compared on one card: unpack the other into a git-ignored directory,
copy this script into its ``tools/``, and run the script of each
checkout in one call, in turns: A, B, B, A. Needs a CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from time_mamba_scan_bwd import _tower  # noqa: E402

RUNS = 3  # CUDA-event timings of a case, one after the other
# ARM-B's layer: directions, L (196 patches + cls), d_inner, C = R + 2N,
# conv taps.
ARM_B = (4, 197, 768, 80, 4)
# ARM-L's layer (AM-MRG): C = 64 + 2 x 16.
ARM_L = (4, 197, 1024, 96, 4)
# vssm_tiny's C = R + 2N by stage (R = ceil(d_model / 16), N = 16).
VSSM_C = (38, 44, 56, 80)
# The main paths' launches of each shape, as ROADMAP 2b reckons them: a
# 3-request serve (12 ARM-B layers a request, B=1), a 5-step train (2
# micro-batches of 6 images a step, each layer's forward run again by
# remat: 240) with its validation (12 and 4 images, 12 each), and a
# 2-step vssm_classify train (blocks per stage 2 / 2 / 5 / 2, at B=128)
# with one validation batch of 64. bf16 sources run on no main path.
LAUNCHES = {("arm-b", 1): 36, ("arm-b", 6): 240, ("arm-b", 12): 12,
            ("arm-b", 4): 12}
LAUNCHES.update({(f"vssm_tiny_s{s}", b): n * (2 if b == 128 else 1)
                 for s, n in enumerate((2, 2, 5, 2)) for b in (128, 64)})
# am_mrg_mimic: 5 steps of 12 images (24 layers, remat: 240) and a
# validation of 12 and 4 images (24 each).
LAUNCHES.update({("arm-l", 12): 264, ("arm-l", 4): 24})
# (rows, directions a block, ranges of D) that --sweep forces; the ranges
# only where one range leaves SMs idle
TILES = ((64, 2, 1), (64, 1, 1), (128, 2, 1), (128, 1, 1))
SPLITS = (2, 4, 8)
# The fused layer's kernels in a tower's forward profile.
TOWER_KERNELS = ("mamba_scan", "mamba_xdbl")


def _cases(dev, gen, batches_vssm):
    """(name, B, dtype, xdbl_fwd's arguments) at every main-path shape."""
    k_dirs, seq_len, d_in, c, taps = ARM_B

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    cases = []
    arm_w = (randn(k_dirs, taps, d_in) * 0.5, randn(k_dirs, d_in) * 0.5,
             randn(k_dirs, c, d_in) * d_in ** -0.5)
    for b, dtype in ((1, torch.float32), (1, torch.bfloat16),
                     (6, torch.float32), (6, torch.bfloat16),
                     (12, torch.float32), (4, torch.float32)):
        x = randn(b, seq_len, d_in).to(dtype)
        xc = randn(b, seq_len, d_in).to(dtype)  # the column-major source
        cases.append(("arm-b", b, dtype, (x, xc, *arm_w, True)))
    k_dirs, seq_len, d_in, c, taps = ARM_L
    arm_w = (randn(k_dirs, taps, d_in) * 0.5, randn(k_dirs, d_in) * 0.5,
             randn(k_dirs, c, d_in) * d_in ** -0.5)
    for b in (12, 4, 1):
        x, xc = randn(b, seq_len, d_in), randn(b, seq_len, d_in)
        cases.append(("arm-l", b, torch.float32, (x, xc, *arm_w, True)))
    import chip_smoke as cs

    for b in batches_vssm:
        for s, (seq_len, d_in) in enumerate(cs.SS_VSSM_STAGES):
            hw = int(round(seq_len ** 0.5))
            x = torch.nn.functional.silu(randn(b, hw, hw, d_in))
            xr = x.reshape(b, seq_len, d_in)
            xc = x.transpose(1, 2).reshape(b, seq_len, d_in).contiguous()
            wx = randn(4, VSSM_C[s], d_in) * d_in ** -0.5
            zeros = (torch.zeros(4, 4, d_in, device=dev),
                     torch.zeros(4, d_in, device=dev))
            cases.append((f"vssm_tiny_s{s}", b, torch.float32,
                          (xr, xc, *zeros, wx, False)))
    return cases


@contextlib.contextmanager
def _tile(mf, tile):
    """``xdbl_fwd`` takes ``tile``."""
    chosen = mf.xdbl_tile
    mf.xdbl_tile = lambda *a, **kw: tile
    try:
        yield
    finally:
        mf.xdbl_tile = chosen


def _shape_fields(mf, b, xargs) -> dict:
    """The tile, grid and occupancy of a call, where the checkout has them."""
    if not hasattr(mf, "xdbl_tile"):
        return {}
    xr, _, conv_w, _, wx, use_conv = xargs
    k_dirs, c, d_in = wx.shape
    seq_len = xr.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = mf.xdbl_tile(b, k_dirs, seq_len, d_in, c, sms)
    blocks, smem = mf.xdbl_occupancy(*tile[:2], xr.dtype, use_conv,
                                     conv_w.shape[1], c)
    return dict(tile="x".join(map(str, tile)),
                grid_blocks=mf.xdbl_grid_blocks(b, k_dirs, seq_len, c, *tile),
                blocks_per_sm=blocks, smem_bytes=smem)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_xdbl: needs a CUDA card")
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
    total = 0.0
    cases = _cases(dev, gen, (cs.SS_VSSM_BATCH, 64))
    for name, b, dtype, xargs in cases:
        got = mf.xdbl_fwd(*xargs)
        want = mf.xdbl_plain(*xargs)
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        runs = [cs.device_ms(lambda: mf.xdbl_fwd(*xargs), 20)
                for _ in range(RUNS)]
        ms = statistics.median(runs)
        plain = statistics.median(cs.device_ms(lambda: mf.xdbl_plain(*xargs),
                                               3) for _ in range(RUNS))
        k_dirs, c, d_in = xargs[4].shape
        elems = b * k_dirs * xargs[0].shape[1] * d_in
        bound = cs._bound([*xargs[:5], got], (
            2.0 * elems * c, 13.0 * elems if xargs[5] else 0.0))
        launches = LAUNCHES.get((name, b), 0) if dtype == torch.float32 else 0
        total += launches * (ms - bound[0])
        print(f"xdbl case={name} B={b} L={xargs[0].shape[1]} D={d_in} C={c} "
              f"{'fp32' if dtype == torch.float32 else 'bf16'} "
              f"ms={ms:.4f} ms_runs={'/'.join(f'{t:.4f}' for t in runs)} "
              f"plain_ms={plain:.4f} bound_ms={bound[0]:.4f} "
              f"bound_by={bound[2]} err={err:.3e} scale={scale:.3f} "
              f"launches={launches} "
              f"launches_x_ms_minus_bound={launches * (ms - bound[0]):.3f} "
              + " ".join(f"{k}={v}" for k, v in
                         _shape_fields(mf, b, xargs).items()), flush=True)
        del got, want
    print(f"xdbl launches_x_ms_minus_bound_total={total:.3f}", flush=True)

    if "--sweep" in sys.argv[1:] and hasattr(mf, "xdbl_tile"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for name, b, dtype, xargs in cases:
            k_dirs, c, d_in = xargs[4].shape
            seq_len = xargs[0].shape[1]
            tiles = [t for t in TILES if t[1] <= k_dirs]
            tiles += [(rows, dirs, s) for rows, dirs, _ in tiles
                      for s in SPLITS if mf.xdbl_grid_blocks(
                          b, k_dirs, seq_len, c, rows, dirs) < 2 * sms]
            row = {}
            for tile in tiles:
                with _tile(mf, tile):
                    row["x".join(map(str, tile))] = statistics.median(
                        cs.device_ms(lambda: mf.xdbl_fwd(*xargs), 20)
                        for _ in range(RUNS))
            print(f"xdbl sweep case={name} B={b} "
                  f"{'fp32' if dtype == torch.float32 else 'bf16'} "
                  f"chosen={_shape_fields(mf, b, xargs)['tile']} ms="
                  + json.dumps({k: round(v, 4) for k, v in row.items()},
                               separators=(",", ":")), flush=True)
    del cases
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
    images = torch.randn(micro, cfg.data.num_views, size, size, 3,
                         device=dev, generator=gen)
    with torch.no_grad():
        _tower("arm-b tower fwd", lambda: model.encode_img(images),
               f"images={micro * cfg.data.num_views} {size}^2 "
               f"layers={len(model.vision.arm.layers)}", cs.device_ms,
               TOWER_KERNELS)


if __name__ == "__main__":
    main()
