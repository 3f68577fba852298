#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Each phase prints one line, and any failure
raises (exit code 1):

1. device   -- a CUDA card is required; prints its name and power limit.
2. build    -- compiles ``medical_image_analysis_tpu_torch/csrc/mamba_fused.cu``,
               ``csrc/scan_n1.cu``, ``csrc/vit_block.cu``,
               ``csrc/swin_block.cu``, ``csrc/selective_scan.cu`` and
               ``csrc/attention.cu`` with nvcc for sm_90a into
               ``build/kernels/``, one nvcc per source, all at once.
3. kernels  -- both fused-Mamba forward wrappers (``xdbl_fwd``, and
               ``scan_fwd``: a chunked scan, three kernels, one launch count
               a call) against their plain PyTorch versions on the card, at
               the ARM-B layer shapes of the ``r2gengpt_mimic`` preset (K=4,
               L=197, D=768, N=16, R=48), batch 1 and 6, fp32 and bf16
               sources; the device time of each beside its plain version's,
               and the chunk ``scan_fwd`` took.
   kernels_fwd_vssm -- ``scan_fwd`` at vssm_tiny's four stage shapes
               (K=4, no conv, N=16; ``vssm_classify``'s SS2D blocks),
               held against ``scan_plain`` at B=8 and timed alone at B=128
               beside its bound, with its chunk and each kernel's grid
               blocks and resident blocks an SM.
   kernels_bwd -- the backward (``scan_bwd``: three kernels, chunk
               summaries, carries, gradients; one launch count a call)
               against ``scan_bwd_plain`` at the same shapes: the max error
               of each output, the device times, and each kernel's grid
               blocks, resident blocks an SM and shared memory a block;
               then at vssm_tiny's four stage shapes (K=4, no conv, N=16;
               ``vssm_classify``'s SS2D blocks), held against the plain
               version at B=8 and timed alone at B=128.
4. serve    -- the preset at full width (ARM-B 768x12 + qwen1_5_1_8b with
               Qwen1.5's vocabulary of 151,936; random weights from a seed)
               behind ``cli.demo.make_server``: synthetic 224x224 PNGs are
               POSTed, beam 3, 120 new tokens. Each reply is checked, and
               each kernel must have launched once per ARM layer per request.
5. tower    -- ``encode_img`` of one image through the kernels and through
               the plain versions; the relative gap is held to a bound.
6. train    -- the preset at full width through ``cli.train.main``
               in-process: frozen LLM with LoRA r16 on q/v, trainable
               tower, accumulation 2, remat, batch 6 x 2 views x 224^2, on
               the synthetic dataset (32 samples: 5 steps), then one
               validation (beam 3, 120 tokens). Every loss is finite, every
               trainable tensor moved and no frozen one did, the delta file
               exists, and each kernel launched as often as the design says
               (printed). Step and validation seconds, peak device memory.
7. train_grads -- one micro-batch at full width: the tower's and the
               projector's gradients through the kernels against those
               through the plain versions, from one cotangent at the
               projector's output, within a relative bound.
8. kernels_n1 -- the d_state=1 scan's forward (``scan_n1_fwd``: one pass
               of its scan kernel, or piece summaries, carries and the
               scan in chunks, as ``fwd_chunk`` picks; one launch count a
               call) against ``scan_n1_fwd_plain`` at the four stage
               shapes of vssm1_base at every batch the main path gives it
               (B=12 tower images, 36 context images, 4 images of
               validation's last batch; fp32), stage 2 in bf16 and stage 0
               at B=1; max error, device times and the bound of every
               case, the chunk, and each kernel's grid blocks, resident
               blocks an SM and shared memory a block.
   kernels_n1_bwd -- its backward (three kernels: piece summaries,
               carries, gradients; one launch count a call) against
               ``scan_n1_bwd_plain`` at the four stages at the training
               batch (B=12), stage 2 in bf16 and stage 0 at B=1, every
               output; each case's device times and bound, and each
               kernel's grid blocks, resident blocks an SM and shared
               memory a block.
9. train_csr -- the ``r2gencsr_iu`` preset with ``model.vision=vssm``,
               ``vision_size=base`` and the vssm1 ``vision_kwargs``
               (vssm1_base + qwen1_5_0_5b at full width, 3 + 3 context
               images per study, LoRA r16, trainable tower) through
               ``cli.train.main``: 5 steps and one validation (beam 3, 100
               tokens). The same checks as ``train``; each scan kernel
               launched as often as the design says.
10. train_csr_grads -- one batch: the vssm1 tower's and the projector's
               gradients through the kernels against the plain versions,
               from one cotangent at ``encode_img``'s outputs, and the
               context residuals (36 context images) likewise.
11. kernels_vit -- the ViT block's two forward kernels (``vit_attn_fwd``,
               ``vit_mlp_fwd``) against their plain versions at the shapes
               of ``mae_hd_1280``'s main path, B=16 as it trains: the
               encoder (L=1401, d=768, 12 heads) and the decoder (L=6401,
               d=512, 16 heads) in fp32; the 224^2 MAE's encoder (L=50) and
               decoder (L=197), and bench.py's encode in bf16 (B=64, L=145).
               The plain versions walk the heads one at a time, so the
               decoder's holds one head's (16, 6401, 6401) fp32 scores,
               2.6 GB, a few at a time. Each line: max error against its
               bound, the kernel's ms, the plain version's, and
               ``library_ms``, the sub-layer composed of ``F.layer_norm``,
               ``F.linear`` and ``F.scaled_dot_product_attention`` (a
               yardstick the port never calls).
    kernels_vit_bwd -- the two backward kernels against the plain
               backwards (``attn_block_bwd_plain``, ``mlp_block_bwd_plain``,
               per head as above; the CPU tests hold them to ``jax.vjp``
               of the TPU kernels) at the same fp32 shapes, every output;
               ms of the kernel, of the plain backward, and of the library
               composition's forward + backward. All four kernels' rows at
               the encoder and the decoder go into the kernels line (with
               a ``case`` key). ``vit_attn_bwd``'s device time at both is
               split by kernel (``kernels_vit_bwd_parts``: the tensor-core
               GEMM, the forward core's recompute, the dK/dV and dQ passes,
               the LayerNorm kernels and sums, the rest) from
               ``torch.profiler``.
    kernels_vit_parts -- ``vit_attn_fwd``, ``vit_mlp_fwd`` and
               ``vit_mlp_bwd`` split the same way at the encoder and the
               decoder, and both forwards at bench.py's bf16 encode, with
               the tensor-core GEMM's TFLOP/s (its products over its time);
               the phase fails if any launches a kernel named
               ``gemm_kernel`` or ``attn_fwd_kernel`` (the CUDA-core GEMM
               and attention core, both deleted): all four ViT kernels run
               every product on the tensor cores (fp32 in 3xTF32, bf16 as
               it is). Each split must add up to within 20% of the call's
               time by CUDA events (a profile that lost kernels is taken
               again, at most three times, and printed as
               ``profile_lost_kernels``).
    kernels_swin_parts -- ``swin_attn_fwd`` at swin_large's stage 2
               (B=64, shifted, fp32; the kernels line's row) split the same
               way: the tensor-core GEMM with its TFLOP/s, the window core,
               the LayerNorm kernels, the rest; it fails as
               ``kernels_vit_parts`` does.
12. train_mae -- the ``mae_hd_1280`` preset (MAE ViT-B/16 + 512x8 decoder,
               1280^2 images, region masking: encoder L=1401, decoder
               L=6401, batch 16, fp32) through ``cli.train.main`` on the
               synthetic dataset for 3 epochs (6 steps), no train state
               written: every loss finite, every parameter moved, each of
               the four ViT kernels launched 20 sub-layers x 6 steps times;
               step and set-up seconds, peak device memory.
13. train_mae_grads -- one batch of the preset (16 images) with the first
               step's masking noise: the loss and every parameter's
               gradient through the kernels against the plain versions
               (``set_fused(model, False)``), within a relative bound.
14. kernels_swin -- the Swin window-attention sub-layer (``swin_attn_fwd``)
               against ``swin_attn_block_plain`` at the four stage shapes of
               swin_large at B=64 (shifted and unshifted where the stage has
               both) and of swin_base at B=12, fp32, and swin_large's stage 0
               in bf16: max error against its bound, ms of the kernel, the
               plain version and ``library_ms`` (``F.layer_norm``,
               ``F.linear``, ``F.scaled_dot_product_attention`` with the
               bias and mask as ``attn_mask``), the bound and TFLOP/s.
15. train_cls -- the ``swinchex`` preset (swin_large, 14 two-way heads,
               B=64, 224^2, mixup 0.8 / cutmix 1.0, fp32) through
               ``cli.train.main`` on ``synthetic_learnable`` data (256 train
               samples: 4 steps; one validation of the 64 val samples):
               finite losses, every parameter moved, the Swin kernel
               launched 24 times (one per block) per validation batch and
               never in a training step; acc_mean, auc_mean, step and
               validation seconds, peak device memory.
16. tower_cls -- one validation batch of 64 through the trained SwinCheX:
               logits through the kernel against ``set_fused(model,
               False)`` within a relative bound, and a forward + backward
               with a gradient that launches it no time.
17. train_cls_vssm, train_cls_dp -- ``vssm_classify`` (vssm_tiny, B=128,
               EMA; the fused-Mamba kernels, d_state 16 without a conv) and
               ``dp_finetune`` (ViT-B/16, B=64, EMA; the four ViT kernels) at
               full width on the same data: 2 steps and one validation each,
               launches reckoned and printed, step seconds.
18. train_csr_swin -- the ``r2gencsr_iu`` preset as it stands (swin_base +
               qwen1_5_0_5b, 3 + 3 context images, LoRA r16, trainable
               tower) on the synthetic dataset: 5 steps and one validation
               (beam 3, 100 tokens), the checks of ``train_csr``; the Swin
               kernel launches for the context images of each step and for
               both towers of each validation batch, and the context
               residuals through the kernel match the plain versions'.
19. kernels_ss, kernels_ss_bwd -- the general selective scan's forward and
               backward kernels (``ops/selective_scan_pallas.py``) against
               their plain versions, every output, at ARM-B's layer shapes
               (K=4, L=197, D=768, N=16; B=1 forward, B=6 backward; fp32
               and bf16) and vssm_tiny's four stage shapes at B=128 (fp32,
               stage 0 also bf16): max errors, ms of the kernel and of the
               plain version, the bound; for the backward also its
               resident blocks an SM and shared memory a block, failing
               under SS_BWD_MIN_BLOCKS (5).
20. train_cls_vssm_pallas -- ``vssm_classify`` with ``--set
               model.vision_kwargs={scan_backend: pallas}`` (vssm_tiny at
               full width, 11 SS2D blocks, d_state 16, B=128, EMA,
               mixup/cutmix, fp32) through ``cli.train.main`` on the data of
               ``train_cls_vssm``: 2 steps and one validation, the scan
               kernels' launches reckoned, the fused layer's 0; step and
               validation seconds and peak memory beside ``train_cls_vssm``'s.
21. tower_arm_pallas -- ``r2gengpt_mimic``'s ARM-B tower on the same
               ``--set``, remat, one micro-batch of 6 images: the tower's and
               projector's gradients through the kernels against
               ``pallas_plain`` within TOWER_RTOL; the gap to the fused
               layer printed.
22. kernels_attn -- ``fused_attention``'s kernel against its plain version
               at ViT-B's widths (B=64, L=197, 12 heads of 64), fp32 and
               bf16, with and without a causal mask; ``library_ms`` is
               ``F.scaled_dot_product_attention``; then the kernel's wrapper
               at every head width (16, 32, 64, 128) and at L = 50 and
               1,401 beside 197, fp32 and bf16, with and without the mask,
               checked against the plain version; ViT-B at 384^2 (L=577)
               takes the einsum route and launches nothing.
23. attn     -- ``models/vit.py:Attention(768, 12)`` on (64, 197, 768):
               the kernel against ``set_fused(model, False)``, then 0
               launches under a gradient.

Bounds: the largest of the bytes at the HBM rate, the matrix products at
the tensor-core rate of their operand type (fp32 in 3xTF32, 165 TFLOP/s;
bf16 989) and the other operations at the CUDA cores' 67 TFLOP/s.

Then one JSON line of the kernels, and the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

TF32 is off for matmuls and for cuDNN throughout, since the comparisons
are made in fp32.
"""

from __future__ import annotations

import argparse
import base64
import gc
import io
import itertools
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

SEED = 0
VOCAB = 151936  # Qwen1.5's published vocabulary, used as a size only
REQUESTS = 3
TRAIN_SAMPLES = 32  # data.dataset=synthetic's train split
VAL_SAMPLES = 8  # and its val split
PRESET = (Path(__file__).resolve().parent / "medical_image_analysis_tpu_torch"
          / "configs" / "presets" / "r2gengpt_mimic.yaml")
CSR_PRESET = PRESET.parent / "r2gencsr_iu.yaml"
# vssm1_base through the JAX package's own entry point (vision=vssm, size
# base, and the d_state=1 family's kwargs)
VSSM1_OVERRIDES = (
    "model.vision=vssm", "model.vision_size=base",
    "model.vision_kwargs={d_state: 1, disable_z: true, conv_bias: false, "
    "patch_embed_version: v2}",
)
REPLACES = {
    "mamba_xdbl": "medical_image_analysis_tpu/ops/mamba_fused.py:111",
    "mamba_scan": "medical_image_analysis_tpu/ops/mamba_fused.py:145",
    "mamba_scan_bwd": "medical_image_analysis_tpu/ops/mamba_fused.py:197",
    "scan_n1_fwd": "medical_image_analysis_tpu/ops/scan_n1.py:89",
    "scan_n1_bwd": "medical_image_analysis_tpu/ops/scan_n1.py:150",
    "vit_attn_fwd": "medical_image_analysis_tpu/ops/vit_block.py:81",
    "vit_mlp_fwd": "medical_image_analysis_tpu/ops/vit_block.py:126",
    "vit_attn_bwd": "medical_image_analysis_tpu/ops/vit_block.py:298",
    "vit_mlp_bwd": "medical_image_analysis_tpu/ops/vit_block.py:235",
    "swin_attn_fwd": "medical_image_analysis_tpu/ops/swin_block.py:43",
    "selective_scan_fwd":
        "medical_image_analysis_tpu/ops/selective_scan_pallas.py:108",
    "selective_scan_bwd":
        "medical_image_analysis_tpu/ops/selective_scan_pallas.py:164",
    "fused_attention": "medical_image_analysis_tpu/ops/attention.py:28",
}
# vssm1_base's stages at 224^2: (H = W, model dim); d_inner = 2 dim, R = dim/16
N1_STAGES = ((56, 128), (28, 256), (14, 512), (7, 1024))
N1_BATCH = 12  # 6 studies x 2 views, the tower images of a training step
# The forward's other batches on the main path: the context tower's 6
# studies x (3 + 3) images, and validation's last batch (8 val samples in
# batches of 6), whose 2 studies give 4 images and 12 context images.
N1_FWD_BATCHES = (N1_BATCH, 36, 4)
N1_OUTPUTS = ("du", "dxdbl", "dA", "dD", "ddt_bias", "ddt_proj_w")
BWD_OUTPUTS = ("du", "u", "dsilu", "dxdbl", "dA", "dD", "ddt_bias",
               "ddt_proj_w")

# Tolerances, relative to max(1, max |plain|):
# x_dbl is fp32 from identical inputs; only the order of the sum over D
# differs.
XDBL_RTOL = 1e-4
# y: fp32 as x_dbl. From bf16 sources both sides compute in fp32 and
# round to bf16 (the d_state=1 scan: each direction, then the pair's sum),
# where they may land one bf16 step apart: 2^-7 of the largest value.
Y_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7}
# The backward's outputs are fp32 on both sides from the same inputs, for
# either source dtype; the sums over D and over L run in another order.
BWD_RTOL = 1e-4
# The tower through 12 layers, fp32: reordered sums, compounded per layer
# and rescaled by the final LayerNorm and projector. The same bound holds
# the tower's and projector's gradients, relative to each tensor's largest.
TOWER_RTOL = 1e-3
MAE_PRESET = PRESET.parent / "mae_hd_1280.yaml"
MAE_EPOCHS = 3  # 2 steps an epoch of the synthetic train split at batch 16
# (B, L, d, heads, dtype): the ViT sub-layers on the main path of
# mae_hd_1280 (encoder 1 + 1100 + 300 tokens, decoder 1 + 6400), the 224^2
# MAE's (1 + 49, 1 + 196) and bench.py's encode at 384^2 in bf16.
VIT_CASES = (
    (16, 1401, 768, 12, torch.float32),
    (16, 6401, 512, 16, torch.float32),
    (16, 50, 768, 12, torch.float32),
    (16, 197, 512, 16, torch.float32),
    (64, 145, 768, 12, torch.bfloat16),
)
# fp32: reordered sums, 1e-4 of max(1, max |plain|). bf16: both sides round
# at the TPU kernel's points, but the kernel rounds exp(s - m) before the
# softmax's division and the plain version after it, so two bf16 steps.
VIT_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}
# The kernels line's rows of the four ViT kernels, (B, L): (suffix of the
# measured row's key, the row's "case"): the mae_hd_1280 encoder and its
# decoder (16 heads of 32).
VIT_ROWS = {(16, 1401): ("", "mae_hd_1280 encoder B=16 L=1401"),
            (16, 6401): ("_decoder", "mae_hd_1280 decoder B=16 L=6401")}
VIT_GRADS = {"attn": ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dg", "db"),
             "mlp": ("dx", "dw1", "db1", "dw2", "db2", "dg", "db")}
# Classification on synthetic_learnable data: its val split has 64 samples;
# the train split is sized so that each preset takes the steps named above.
CLS_PRESET = PRESET.parent / "swinchex.yaml"
LEARNABLE_VAL = 64
CLS_TRAIN = {"swinchex.yaml": 256, "vssm_classify.yaml": 256,
             "dp_finetune.yaml": 128}
# (name, embed dim, heads per stage, images): the Swin towers on this
# slice's paths at 224^2 (patch 4, window 7: a 56^2 map at stage 0, 7^2 at
# stage 3): swinchex's swin_large at its batch of 64, and r2gencsr_iu's
# swin_base at the training step's 6 studies x 2 views.
SWIN_TOWERS = (("swin_large", 192, (6, 12, 24, 48), 64),
               ("swin_base", 128, (4, 8, 16, 32), 12))
# The kernel's fp32 result against the plain version's: reordered sums,
# 1e-4 of max(1, max |plain|); bf16 as the ViT kernels (VIT_RTOL).
SWIN_RTOL = VIT_RTOL
# The general selective scan on this slice's paths (scan_backend=pallas):
# ARM-B's layers (K=4 directions, L = 196 patches + cls, d_inner 768,
# d_state 16) at the serving batch (forward) and the training micro-batch
# of 3 samples x 2 views (backward), and vssm_tiny's four stages at 224^2
# (L = 56^2 .. 7^2, d_inner 192 .. 1536, d_state 16) at vssm_classify's
# batch of 128.
SS_ARM = (4, 197, 768, 16)  # K, L, d_inner, N
SS_ARM_BATCH = {"fwd": 1, "bwd": 6}
SS_VSSM_STAGES = ((3136, 192), (784, 384), (196, 768), (49, 1536))
SS_VSSM_BATCH = 128
# The backward's resident blocks of 64 threads an SM at the least: more
# warps to hide the latency of its sequential walks.
SS_BWD_MIN_BLOCKS = 5
# The fused backward's check at vssm_tiny's stages against scan_bwd_plain,
# whose per-row state lists hold B*4*L*D*16 floats: B=8 fits them (1.2 GB at
# stage 0). The kernels' indexing depends on B only through the grid.
MAMBA_VSSM_CHECK_BATCH = 8
VSSM_PALLAS = "model.vision_kwargs={scan_backend: pallas}"
# The fused attention at dp_finetune's ViT-B widths (B=64, L=197, 12
# heads of 64), and ViT-B at 384^2 (L=577), where the JAX dispatch takes
# the einsum route (8 x 577^2 x 4 bytes > 8 MiB).
ATTN_VIT_B = (64, 197, 12, 64)
ATTN_EINSUM = (8, 577, 12, 64)
# Every head width and a ragged L beside 197 through the kernel's wrapper
# (``attention_fwd``; L = 1,401 is past the JAX dispatch's 8 MiB tile at
# any batch, so ``fused_attention`` would take the einsum route): (B, L,
# heads, hd). Checked against the plain version, not timed.
ATTN_CHECKS = ((64, 50, 12, 64), (4, 1401, 12, 64), (16, 197, 24, 32),
               (16, 197, 48, 16), (16, 197, 6, 128), (2, 1401, 16, 32),
               (8, 50, 4, 128))
# The kernel's fp32 result against the plain version's: reordered sums,
# 1e-4 of max(1, max |plain|); bf16 as the ViT kernels (VIT_RTOL): p is
# rounded before the product and the output after it.
ATTN_RTOL = VIT_RTOL
# The published H100 SXM peaks (NVIDIA's H100 datasheet) that bound_ms
# divides by: HBM bytes per second; matrix products on the tensor cores at
# the rate of their operand type (fp32 at fp32 accuracy in 3xTF32, a third
# of the 495 TFLOP/s TF32 rate; bf16 at 989); every other operation at the
# 67 TFLOP/s fp32 rate of the CUDA cores.
HBM_BYTES_S = 3.35e12
PRODUCT_OPS_S = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
OTHER_OPS_S = 67e12


def _phase(phase: str, /, **fields) -> None:
    """Print a phase's line. On the card it ends with the device memory
    still allocated (``alloc_gib``) and what a garbage collection leaves of
    it (``alloc_gc_gib``): tensors held by reference cycles of an earlier
    phase count toward a later phase's peak until collected, so each line
    collects them."""
    if torch.cuda.is_available():
        held = torch.cuda.memory_allocated()
        gc.collect()
        fields = dict(fields, alloc_gib=f"{held / 2**30:.3f}",
                      alloc_gc_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}")
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def device_ms(fn, iters: int) -> float:
    """Device milliseconds per call of ``fn``, from CUDA events.

    A spin kernel queued first keeps the card busy while the host queues
    the calls, so the events time the device's work and not the host's
    launch overhead (unless queueing takes longer than the spin).
    """
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(tensors, work, dtype=torch.float32) -> tuple[float, str, str]:
    """The least time (ms) the card could take for a call, the largest of
    three: its inputs read once and its outputs written once at the HBM
    rate; its matrix products at the tensor-core rate of ``dtype``; its
    other operations at the CUDA cores' fp32 rate. ``work`` is an
    operation count with no products (the scans) or a ``(products,
    other)`` pair (``ops/*.py:work``). Returns the time, "bytes" or
    "operations" (the ``kernels`` line's ``bound_by``), and which of the
    three it is ("bytes", "products" or "other")."""
    products, other = work if isinstance(work, tuple) else (0.0, work)
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    ms, on = max((nbytes / HBM_BYTES_S * 1e3, "bytes"),
                 (products / PRODUCT_OPS_S[dtype] * 1e3, "products"),
                 (other / OTHER_OPS_S * 1e3, "other"))
    return ms, "bytes" if on == "bytes" else "operations", on


# Operations of the scan kernels per (image, direction, row, channel),
# counted from the algorithm (a multiply-add is two, an exp or a softplus
# one each): the causal conv and SiLU 13, dt_proj 2R, softplus 4, the
# N-state update and readout 7N, the D skip 2; the backward recomputes the
# forward and runs the adjoint (2R + 10N). The d_state=1 scan: dt_proj 2R,
# softplus, decay, update, readout and skip 13; its backward as above.
def _mamba_ops(rank, n, use_conv=True):
    return (13 if use_conv else 0) + 2 * rank + 4 + 7 * n + 2


def _max_err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    return err, scale


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _phase("device", name=repr(torch.cuda.get_device_name(0)),
           count=torch.cuda.device_count(), torch=torch.__version__,
           cuda=torch.version.cuda)


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    modules = _kernel_modules()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(modules)) as pool:  # one nvcc each
        logs = list(pool.map(lambda m: m.build()[1], modules))
    secs = time.perf_counter() - t0
    for log in logs:  # ptxas: registers, shared memory, spills
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(line.strip(), file=sys.stderr)
    _phase("build", seconds=f"{secs:.2f}",
           sources=",".join(m.KERNEL_SOURCE for m in modules))


def preset_layer(cfg, dev, gen):
    """One initialised ARM layer of the preset's tower, and its sequence
    length and cls position."""
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.mamba import ARM
    from medical_image_analysis_tpu_torch.train.loop import vision_preset

    vk = vision_preset(cfg.model.vision, cfg.model.vision_size,
                       cfg.model.vision_kwargs)
    arm = ARM(**dict(vk, depth=1), img_size=cfg.data.input_size, device=dev)
    init_params(arm, gen)
    seq_len = arm.pos_embed.shape[1]
    return arm.layers[0].mixer, seq_len, (seq_len - 1) // 2


def _layer_weights(mixer) -> dict:
    with torch.no_grad():
        w = dict(conv_w=mixer.conv_w, conv_b=mixer.conv_b,
                 x_proj_w=mixer.x_proj_w, dt_proj_w=mixer.dt_proj_w,
                 dt_bias=mixer.dt_bias, A=-torch.exp(mixer.A_log), D=mixer.D)
        return {k: v.detach().float().contiguous() for k, v in w.items()}


def phase_kernels(cfg, dev, gen, batches=(1, 6)) -> dict:
    """Kernels against plain versions; returns the serving-shape row
    (batch 1, fp32) for the kernels' JSON line."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    mixer, seq_len, cls_pos = preset_layer(cfg, dev, gen)
    w = _layer_weights(mixer)
    serving = {}
    for b in batches:
        x = torch.randn(b, seq_len, mixer.d_inner, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            xr = x.to(dtype)
            xc = mixer._col_major(xr, cls_pos).contiguous()
            xargs = (xr, xc, w["conv_w"], w["conv_b"], w["x_proj_w"])
            want_x = mf.xdbl_plain(*xargs)
            got_x = mf.xdbl_fwd(*xargs)
            sargs = (xr, xc, want_x, w["conv_w"], w["conv_b"],
                     w["dt_proj_w"], w["dt_bias"], w["A"], w["D"])
            want_y = mf.scan_plain(*sargs)
            got_y = mf.scan_fwd(*sargs)
            _sync(dev)
            _check(got_x.shape == want_x.shape and got_y.shape == want_y.shape
                   and got_y.dtype == dtype, "kernel output shape or dtype")
            err_x, scale_x = _max_err(got_x, want_x)
            err_y, scale_y = _max_err(got_y, want_y)
            _check(err_x <= XDBL_RTOL * scale_x,
                   f"mamba_xdbl B={b} {dtype}: max abs err {err_x:.3e} > "
                   f"{XDBL_RTOL} x {scale_x:.3f}")
            _check(err_y <= Y_RTOL[dtype] * scale_y,
                   f"mamba_scan B={b} {dtype}: max abs err {err_y:.3e} > "
                   f"{Y_RTOL[dtype]} x {scale_y:.3f}")
            # in turns: plain, kernel, kernel, plain
            t = {}
            for name, fn, iters in (
                ("xdbl_plain", lambda: mf.xdbl_plain(*xargs), 20),
                ("xdbl", lambda: mf.xdbl_fwd(*xargs), 50),
                ("xdbl", lambda: mf.xdbl_fwd(*xargs), 50),
                ("xdbl_plain", lambda: mf.xdbl_plain(*xargs), 20),
                ("scan_plain", lambda: mf.scan_plain(*sargs), 3),
                ("scan", lambda: mf.scan_fwd(*sargs), 50),
                ("scan", lambda: mf.scan_fwd(*sargs), 50),
                ("scan_plain", lambda: mf.scan_plain(*sargs), 3),
            ):
                t[name] = t.get(name, 0.0) + device_ms(fn, iters) / 2
            dt_name = "fp32" if dtype == torch.float32 else "bf16"
            _phase(
                "kernels", B=b, K=mixer.k, L=seq_len, D=mixer.d_inner,
                N=mixer.n, R=mixer.rank, src=dt_name,
                xdbl_err=f"{err_x:.3e}", scan_err=f"{err_y:.3e}",
                xdbl_ms=f"{t['xdbl']:.4f}",
                xdbl_plain_ms=f"{t['xdbl_plain']:.4f}",
                scan_ms=f"{t['scan']:.4f}",
                scan_plain_ms=f"{t['scan_plain']:.4f}",
                **_mamba_fwd_blocks(b, mixer.k, seq_len, mixer.d_inner,
                                    mixer.n, mixer.rank, dtype),
            )
            if b == 1 and dtype == torch.float32:
                elems = b * mixer.k * seq_len * mixer.d_inner
                serving = {
                    "mamba_xdbl": (err_x, t["xdbl"], t["xdbl_plain"],
                                   *_bound([*xargs, got_x], elems * (
                                       2 * got_x.shape[-1] + 13))[:2]),
                    "mamba_scan": (err_y, t["scan"], t["scan_plain"],
                                   *_bound([*sargs, got_y], elems * _mamba_ops(
                                       mixer.rank, mixer.n))[:2]),
                }
    return serving


def _mamba_fwd_blocks(b, k_dirs, seq_len, d_in, n, rank, dtype) -> dict:
    """The fused forward's chunk for (B, K, L, D) on this card, and its
    kernels' grid blocks, resident blocks an SM and shared memory a block,
    for a phase line."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk = mf.fwd_chunk(b, k_dirs, seq_len, d_in, sms)
    occupancy = mf.fwd_occupancy(n, rank, dtype)
    return dict(
        chunk=chunk,
        grid_blocks=_compact(mf.fwd_grid_blocks(b, k_dirs, seq_len, d_in, n,
                                                chunk)),
        blocks_per_sm=_compact({k: v[0] for k, v in occupancy.items()}),
        smem_bytes=_compact({k: v[1] for k, v in occupancy.items()}))


def phase_kernels_fwd_vssm(dev, gen) -> None:
    """``scan_fwd`` at vssm_tiny's four stage shapes (``vssm_bwd_case``'s
    arguments without dy: K=4, no conv, N=16, softplus), against
    ``scan_plain`` at B=MAMBA_VSSM_CHECK_BATCH within Y_RTOL (its per-row
    loop holds B=8 easily; the kernels' indexing depends on B only through
    the grid), then timed alone at ``vssm_classify``'s B=128 beside its
    bound: the median of three timings of 10 calls, all three printed
    (sorted) beside it."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    for stage, (seq_len, d_in) in enumerate(SS_VSSM_STAGES):
        args, rank = vssm_bwd_case(dev, gen, stage, MAMBA_VSSM_CHECK_BATCH)
        fargs = (*args[:9], True, False)
        del args
        want = mf.scan_plain(*fargs)
        got = mf.scan_fwd(*fargs)
        _sync(dev)
        _check(got.shape == want.shape and got.dtype == want.dtype
               and bool(torch.isfinite(got).all()),
               f"mamba_scan vssm_tiny stage {stage}: shape, dtype or "
               f"finiteness")
        err, scale = _max_err(got, want)
        _check(err <= Y_RTOL[torch.float32] * scale,
               f"mamba_scan vssm_tiny stage {stage} B="
               f"{MAMBA_VSSM_CHECK_BATCH}: max abs err {err:.3e} > "
               f"{Y_RTOL[torch.float32]} x {scale:.3f}")
        del fargs, want, got
        args, rank = vssm_bwd_case(dev, gen, stage, SS_VSSM_BATCH)
        fargs = (*args[:9], True, False)
        del args
        runs = sorted(device_ms(lambda: mf.scan_fwd(*fargs), 10)
                      for _ in range(3))
        ms = runs[1]
        bound = _bound([*fargs[:9], mf.scan_fwd(*fargs)],
                       SS_VSSM_BATCH * 4 * seq_len * d_in
                       * _mamba_ops(rank, 16, use_conv=False))
        _phase("kernels_fwd_vssm", stage=stage, B=SS_VSSM_BATCH, K=4,
               L=seq_len, D=d_in, N=16, R=rank, src="fp32",
               check_B=MAMBA_VSSM_CHECK_BATCH, err=f"{err:.3e}",
               ms=f"{ms:.4f}", ms_runs="/".join(f"{t:.4f}" for t in runs),
               bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
               **_mamba_fwd_blocks(
                   SS_VSSM_BATCH, 4, seq_len, d_in, 16, rank,
                   torch.float32))
        del fargs
        torch.cuda.empty_cache()


def phase_kernels_bwd(cfg, dev, gen, batches=(1, 6)) -> tuple:
    """The backward kernel against its plain version; returns the
    training-shape row (batch 6 = 3 samples x 2 views, fp32 sources, as
    the tower trains): (max abs err over the outputs, ms, plain ms)."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    mixer, seq_len, cls_pos = preset_layer(cfg, dev, gen)
    w = _layer_weights(mixer)
    training = None
    for b in batches:
        x = torch.randn(b, seq_len, mixer.d_inner, device=dev, generator=gen)
        dy = torch.randn(b, mixer.k, seq_len, mixer.d_inner, device=dev,
                         generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            xr = x.to(dtype)
            xc = mixer._col_major(xr, cls_pos).contiguous()
            x_dbl = mf.xdbl_plain(xr, xc, w["conv_w"], w["conv_b"],
                                  w["x_proj_w"])
            args = (xr, xc, x_dbl, w["conv_w"], w["conv_b"], w["dt_proj_w"],
                    w["dt_bias"], w["A"], w["D"], dy.to(dtype))
            want = mf.scan_bwd_plain(*args)
            got = mf.scan_bwd(*args)
            _sync(dev)
            errs = _bwd_errs(got, want, f"B={b} {dtype}")
            t = {}
            for name, fn, iters in (  # in turns: plain, kernel, kernel, plain
                ("plain", lambda: mf.scan_bwd_plain(*args), 2),
                ("kernel", lambda: mf.scan_bwd(*args), 20),
                ("kernel", lambda: mf.scan_bwd(*args), 20),
                ("plain", lambda: mf.scan_bwd_plain(*args), 2),
            ):
                t[name] = t.get(name, 0.0) + device_ms(fn, iters) / 2
            _phase(
                "kernels_bwd", B=b, K=mixer.k, L=seq_len, D=mixer.d_inner,
                N=mixer.n, R=mixer.rank,
                src="fp32" if dtype == torch.float32 else "bf16",
                errs=json.dumps({k: f"{v:.3e}" for k, v in errs.items()},
                                separators=(",", ":")),
                bwd_ms=f"{t['kernel']:.4f}", bwd_plain_ms=f"{t['plain']:.4f}",
                **_mamba_bwd_blocks(b, mixer.k, seq_len, mixer.d_inner,
                                    mixer.n, mixer.rank, dtype),
            )
            if b == 6 and dtype == torch.float32:
                training = (max(errs.values()), t["kernel"], t["plain"],
                            *_bound([*args, *got], _mamba_bwd_ops(
                                b, mixer.k, seq_len, mixer.d_inner,
                                mixer.n, mixer.rank))[:2])
    for stage, (seq_len, d_in) in enumerate(SS_VSSM_STAGES):
        args, rank = vssm_bwd_case(dev, gen, stage, MAMBA_VSSM_CHECK_BATCH)
        want = mf.scan_bwd_plain(*args)
        got = mf.scan_bwd(*args)
        _sync(dev)
        errs = _bwd_errs(got, want, f"vssm_tiny stage {stage} "
                         f"B={MAMBA_VSSM_CHECK_BATCH}")
        del args, want, got
        args, rank = vssm_bwd_case(dev, gen, stage, SS_VSSM_BATCH)
        ms = device_ms(lambda: mf.scan_bwd(*args), 5)
        bound = _bound([*args[:10], *mf.scan_bwd(*args)], _mamba_bwd_ops(
            SS_VSSM_BATCH, 4, seq_len, d_in, 16, rank))
        _phase("kernels_bwd_vssm", stage=stage, B=SS_VSSM_BATCH, K=4,
               L=seq_len, D=d_in, N=16, R=rank, src="fp32",
               check_B=MAMBA_VSSM_CHECK_BATCH, errs=_compact(
                   {k: f"{v:.3e}" for k, v in errs.items()}),
               ms=f"{ms:.4f}", bound_ms=f"{bound[0]:.4f}",
               bound_by=bound[1], **_mamba_bwd_blocks(
                   SS_VSSM_BATCH, 4, seq_len, d_in, 16, rank,
                   torch.float32))
        del args
        torch.cuda.empty_cache()
    return training


def _bwd_errs(got, want, what: str) -> dict:
    """Each fused-backward output's max abs error against the plain
    version's, held to BWD_RTOL."""
    errs = {}
    for name, g, wv in zip(BWD_OUTPUTS, got, want):
        _check(g.shape == wv.shape and g.dtype == torch.float32,
               f"mamba_scan_bwd {name}: shape or dtype")
        err, scale = _max_err(g, wv)
        _check(err <= BWD_RTOL * scale,
               f"mamba_scan_bwd {what} {name}: max abs err {err:.3e} > "
               f"{BWD_RTOL} x {scale:.3f}")
        errs[name] = err
    return errs


def _mamba_bwd_ops(b, k, seq_len, d_in, n, rank):
    """The fused backward's operations: it recomputes the forward and runs
    the adjoint (``_mamba_ops``' comment)."""
    return b * k * seq_len * d_in * (2 * _mamba_ops(rank, n) + 2 * rank
                                     + 10 * n)


def _mamba_bwd_blocks(b, k_dirs, seq_len, d_in, n, rank, dtype) -> dict:
    """The fused backward's kernels: grid blocks, resident blocks an SM and
    shared memory a block, for a phase line."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    occupancy = mf.bwd_occupancy(n, rank, dtype)
    return dict(
        grid_blocks=_compact(mf.bwd_grid_blocks(b, k_dirs, seq_len, d_in, n)),
        blocks_per_sm=_compact({k: v[0] for k, v in occupancy.items()}),
        smem_bytes=_compact({k: v[1] for k, v in occupancy.items()}))


def vssm_bwd_case(dev, gen, stage: int, batch: int):
    """``scan_bwd``'s fp32 arguments at a vssm_tiny stage (``SS_VSSM_STAGES``)
    as ``vssm_classify`` gives them: an initialised SS2D's fused-layer
    weights (d_state 16, no conv; its directions in the fused layer's
    order), sources silu(N(0, 1)) as SS2D feeds the scan, x_dbl as
    ``xdbl_plain`` gives it and a N(0, 1) cotangent. Returns (args, R)."""
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.vmamba import SS2D
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    seq_len, d_in = SS_VSSM_STAGES[stage]
    m = SS2D(d_in // 2, d_state=16, device=dev)
    init_params(m, gen)
    hw = int(round(seq_len**0.5))
    x = torch.nn.functional.silu(
        torch.randn(batch, hw, hw, d_in, device=dev, generator=gen))
    xr = x.reshape(batch, seq_len, d_in)
    xc = x.transpose(1, 2).reshape(batch, seq_len, d_in).contiguous()
    perm = [0, 2, 1, 3]  # SS2D's directions in the fused layer's order
    with torch.no_grad():
        w = [t.detach()[perm].float().contiguous() for t in (
            m.x_proj_w, m.dt_proj_w, m.dt_bias, -torch.exp(m.A_log), m.D)]
        conv_w = torch.zeros(4, 4, d_in, device=dev)
        conv_b = torch.zeros(4, d_in, device=dev)
        x_dbl = mf.xdbl_plain(xr, xc, conv_w, conv_b, w[0], False)
    dy = torch.randn(batch, 4, seq_len, d_in, device=dev, generator=gen)
    return (xr, xc, x_dbl, conv_w, conv_b, *w[1:], dy, True, False), m.rank


def _png(rng, size: int) -> bytes:
    import PIL.Image

    # a smooth radial field plus noise, 8-bit grey in three channels
    yy, xx = np.mgrid[0:size, 0:size] / size
    field = 160 * np.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) * 4)
    img = np.clip(field + rng.normal(0, 20, (size, size)), 0, 255)
    img = np.repeat(img.astype(np.uint8)[..., None], 3, axis=2)
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _post(port: int, png: bytes) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"image": base64.b64encode(png).decode()}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def phase_serve(config: str, vocab: int, device: str, requests: int):
    """Build the pipeline, serve ``requests`` POSTs; returns (pipeline,
    first PNG, launch counts of the run)."""
    from medical_image_analysis_tpu_torch.cli.demo import (
        build_pipeline,
        make_server,
    )
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    t0 = time.perf_counter()
    pipe = build_pipeline(argparse.Namespace(
        config=config, vocab=None, vocab_size=vocab, delta=None,
        device=device, seed=SEED,
    ))
    _sync(pipe.device)
    build_s = time.perf_counter() - t0
    model, gcfg = pipe.model, pipe.gcfg
    depth = len(model.vision.arm.layers)
    n_params = sum(p.numel() for p in model.parameters())

    rng = np.random.default_rng(SEED)
    pngs = [_png(rng, 224) for _ in range(requests)]
    server = make_server(pipe, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    secs = []
    try:
        mf.reset_launches()
        for png in pngs:
            t = time.perf_counter()
            status, out = _post(server.server_address[1], png)
            secs.append(time.perf_counter() - t)
            ids = out["ids"]
            _check(status == 200, f"HTTP status {status}")
            _check(len(ids) == gcfg.max_new_tokens,
                   f"{len(ids)} ids, expected {gcfg.max_new_tokens}")
            _check(all(0 <= i < vocab for i in ids), "token id out of range")
        launches = dict(mf.launches)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    _check(not thread.is_alive(), "server thread did not stop")
    _phase(
        "serve", preset=Path(config).name, params=n_params,
        arm_layers=depth, llm=f"{model.llm_cfg.dim}x{model.llm_cfg.n_layers}",
        vocab=model.llm_cfg.vocab_size, beams=gcfg.num_beams,
        new_tokens=gcfg.max_new_tokens, build_s=f"{build_s:.2f}",
        request_s=",".join(f"{s:.3f}" for s in secs),
        launches=json.dumps(launches, separators=(",", ":")),
    )
    return pipe, pngs[0], launches, depth


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def phase_tower(pipe, png: bytes, reps: int = 3):
    """encode_img through the kernels and through the plain versions, with
    the wall-clock time of each (host launches included, as served)."""
    import PIL.Image

    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend

    with PIL.Image.open(io.BytesIO(png)) as pil:
        img = np.asarray(pil.convert("RGB"), np.uint8)
    x = pipe.preprocess(img)
    model = pipe.model
    out, ms = {}, {}
    with torch.no_grad():
        for backend in ("plain", "auto", "auto", "plain"):  # in turns
            set_scan_backend(model, backend)
            out[backend] = model.encode_img(x)
            _sync(x.device)
            t0 = time.perf_counter()
            for _ in range(reps):
                model.encode_img(x)
            _sync(x.device)
            ms[backend] = ms.get(backend, 0.0) + (
                (time.perf_counter() - t0) * 1e3 / reps / 2)
        set_scan_backend(model, "auto")
    got, want = out["auto"], out["plain"]
    tokens = model.vision.arm.pos_embed.shape[1]
    _check(bool(torch.isfinite(got).all()), "non-finite tower output")
    _check(got.shape == want.shape
           and tuple(got.shape) == (1, tokens, model.llm_cfg.dim),
           f"tower output shape {tuple(got.shape)}")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    _check(rel <= TOWER_RTOL, f"tower max rel err {rel:.3e} > {TOWER_RTOL}")
    _phase("tower", shape=tuple(got.shape), max_rel_err=f"{rel:.3e}",
           bound=TOWER_RTOL, kernel_ms=f"{ms['auto']:.3f}",
           plain_ms=f"{ms['plain']:.3f}")


def _fingerprint(t: torch.Tensor) -> tuple:
    with torch.no_grad():
        return (t.sum(dtype=torch.float64).item(),
                t.abs().sum(dtype=torch.float64).item())


def _train_through_cli(argv: list[str], save_dir: Path, device: str,
                       epochs: int = 1, validated: bool = True) -> dict:
    """``cli.train.main(argv)`` for ``epochs``, with the kernels' counts at
    0 just before and read just after. Checks what every training run must
    show: the steps of the epochs, each finite; finite scores; every
    trainable tensor moved and no frozen one; when ``validated``, one
    validation and, for report generation, the delta written. Returns the
    model, the state, the run's config and counts, and the fields that the
    phases print (set-up seconds: from the call to the first step)."""
    from medical_image_analysis_tpu_torch.cli import train as cli_train

    seen = {}

    def on_start(model, state):
        seen["model"], seen["state"] = model, state
        seen["trainable"] = {n: p.detach().clone()
                             for n, p in state.params.items()}
        seen["frozen"] = {n: _fingerprint(p) for n, p in state.frozen.items()}
        _sync(torch.device(device))
        seen["setup_s"] = time.perf_counter() - t0

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    scores = cli_train.main([*argv, "--device", device], on_start=on_start)
    _sync(torch.device(device))
    total_s = time.perf_counter() - t0
    launches = _all_launches()
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    model, state = seen["model"], seen["state"]
    import yaml

    with open(save_dir / "config.yaml") as f:
        cfg = yaml.safe_load(f)
    batch = cfg["data"]["batch_size"]
    classify = cfg["model"]["task"] in ("swinchex", "dp")
    if cfg["data"]["dataset"] == "synthetic_learnable":
        train_samples = cfg["data"]["synthetic_train_size"] or 512
        val_samples = LEARNABLE_VAL
    else:
        train_samples, val_samples = TRAIN_SAMPLES, VAL_SAMPLES
    with open(save_dir / "log.txt") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "step" in r]
    vals = [r for r in records if "val_s" in r]
    n_steps = epochs * (train_samples // batch)
    _check(len(steps) == n_steps, f"{len(steps)} steps, expected {n_steps}")
    _check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in steps), "a non-finite loss or grad norm")
    _check(all(np.isfinite(np.asarray(v, np.float64)).all()
               for v in scores.values()), "non-finite scores")
    if validated:
        _check(len(vals) == 1, "validation missing")
    if validated and not classify:
        deltas = sorted(save_dir.glob("checkpoint_epoch0_*.pt"))
        _check(len(deltas) == 1
               and (save_dir / "checkpoint_best.pt").exists(),
               "delta checkpoint not written")
    moved = sum(not torch.equal(p, seen["trainable"][n])
                for n, p in state.params.items())
    _check(moved == len(state.params),
           f"{len(state.params) - moved} trainable tensors did not move")
    still = sum(_fingerprint(p) == seen["frozen"][n]
                for n, p in state.frozen.items())
    _check(still == len(state.frozen),
           f"{len(state.frozen) - still} frozen tensors moved")
    fields = dict(
        steps=n_steps, batch=batch, trainable=len(state.params),
        frozen=len(state.frozen),
        trainable_params=sum(p.numel() for p in state.params.values()),
        losses=",".join(f"{r['loss']:.4f}" for r in steps),
        grad_norms=",".join(f"{r['grad_norm']:.4f}" for r in steps),
        step_s=",".join(f"{r['step_s']:.3f}" for r in steps),
        setup_s=f"{seen['setup_s']:.2f}", total_s=f"{total_s:.2f}",
        peak_mem_gib=f"{peak / 2**30:.3f}",
        launches=json.dumps(launches, separators=(",", ":")),
    )
    if validated:
        fields.update(val_s=f"{vals[0]['val_s']:.3f}")
        fields.update({k: f"{scores[k]:.4f}" for k in (
            "acc_mean", "auc_mean", "instance_f1", "Bleu_4") if k in scores})
    val_bs = cfg["data"]["val_batch_size"] or batch
    val_batches = -(-val_samples // val_bs)
    if not classify:  # fit_mrg scores at most val_max_batches batches
        val_batches = min(val_batches,
                          cfg["train"]["val_max_batches"] or val_batches)
    return {"model": model, "state": state, "cfg": cfg, "cuda": cuda,
            "n_steps": n_steps, "val_batches": val_batches,
            "launches": launches, "fields": fields}


def _check_launches(run: dict, reckoned: dict, phase: str, how: str) -> None:
    """The run's counts against the design's reckoning (every kernel not
    named there at 0); a CPU rehearsal launches none."""
    want = {name: reckoned.get(name, 0) for name in run["launches"]}
    print(f"{phase}: launches reckoned: {how} -> "
          f"{json.dumps(want, separators=(',', ':'))}", flush=True)
    if not run["cuda"]:  # CPU tensors take the plain versions
        want = dict.fromkeys(want, 0)
    _check(run["launches"] == want,
           f"{phase}: launches {run['launches']}, expected {want}")


def phase_train(config: str, vocab: int, save_dir: Path,
                device: str = "cuda") -> dict:
    """Train the preset for one epoch through the CLI; returns the model,
    the batch size and accumulation, and the launch counts of the run."""
    argv = ["--config", config]
    for item in ("data.dataset=synthetic", f"model.llm_kwargs.vocab_size={vocab}",
                 "train.epochs=1", "train.save_state_every_epochs=2",
                 "train.log_every=1", f"train.save_dir={save_dir}"):
        argv += ["--set", item]
    run = _train_through_cli(argv, save_dir, device)
    model, n_steps = run["model"], run["n_steps"]
    accum = run["cfg"]["train"]["accum_steps"]

    # What the design implies: with remat, each ARM layer runs both forward
    # kernels twice per micro-batch (the checkpointed forward and its
    # recompute in the backward) and the backward kernel once; validation
    # encodes each val batch once (no gradient, no recompute).
    depth = len(model.vision.arm.layers)
    val_batches = run["val_batches"]
    fwd_step, bwd_step = depth * accum * 2, depth * accum
    fwd = n_steps * fwd_step + val_batches * depth
    _check_launches(
        run, {"mamba_xdbl": fwd, "mamba_scan": fwd,
              "mamba_scan_bwd": n_steps * bwd_step}, "train",
        f"per step {depth} layers x {accum} micro-batches x 2 forwards = "
        f"{fwd_step} of each forward kernel and {depth} x {accum} = "
        f"{bwd_step} backward; {n_steps} steps + {val_batches} val batches "
        f"x {depth} layers")
    _phase("train", preset=Path(config).name, accum=accum, **run["fields"])
    return {"model": model, "state": run["state"],
            "batch": run["cfg"]["data"]["batch_size"], "accum": accum,
            "launches": run["launches"]}


def _worst_rel(names, got, want) -> tuple[float, str]:
    """The largest max |got - want| / max |want| over the named gradients,
    and its name; every gradient must be finite."""
    out = (0.0, "")
    for n, g, gp in zip(names, got, want):
        _check(bool(torch.isfinite(g).all()), f"non-finite grad of {n}")
        rel = ((g - gp).abs().max() / gp.abs().max().clamp_min(1e-30)).item()
        out = max(out, (rel, n))
    return out


def phase_train_grads(model, state, config: str, batch: int, accum: int):
    """One micro-batch of the preset's data: the tower's and projector's
    gradients through the kernels against those through the plain
    versions, both driven by one cotangent at the projector's output.

    That cotangent is the loss's gradient w.r.t. the image tokens, taken
    once (plain path). Taken through the whole model instead, the two
    paths' gradients differ by a few percent: the bf16 LLM rounds the
    image tokens, and a 1e-6 gap in them flips some roundings by one bf16
    step, which the LLM's backward carries into every gradient. That gap
    is printed (``e2e_``), not bounded.
    """
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
    from medical_image_analysis_tpu_torch.train.loop import (
        _device_batch,
        build_data,
    )

    cfg = load_config(config, ["data.dataset=synthetic", "data.num_workers=1"])
    _, _, batcher, _ = build_data(cfg)
    train_b = batcher("train")
    try:
        host = next(train_b.batches(shuffle=False))
    finally:
        train_b.close()
    dev = next(model.parameters()).device
    micro = {k: v[: batch // accum]
             for k, v in _device_batch(host, dev).items()}
    names = [n for n in state.params if n.startswith(("base/vision/",
                                                      "base/proj"))]
    tensors = [state.params[n] for n in names]

    def loss_of(tokens):
        prompt = model._wrap(tokens, micro["before_ids"], micro["after_ids"])
        return model._loss(prompt, micro["target_ids"], micro["target_mask"])

    set_scan_backend(model, "plain")
    tokens = model.encode_img(micro["images"]).detach().requires_grad_()
    (cotangent,) = torch.autograd.grad(loss_of(tokens), tokens)
    grads, e2e, secs = {}, {}, {}
    for backend in ("auto", "plain"):
        set_scan_backend(model, backend)
        mf.reset_launches()
        t0 = time.perf_counter()
        out = model.encode_img(micro["images"])
        grads[backend] = torch.autograd.grad(out, tensors, cotangent)
        _sync(dev)
        secs[backend] = time.perf_counter() - t0
        if backend == "auto" and dev.type == "cuda":
            depth = len(model.vision.arm.layers)
            _check(mf.launches == {"mamba_xdbl": 2 * depth,
                                   "mamba_scan": 2 * depth,
                                   "mamba_scan_bwd": depth},
                   f"train_grads launches {mf.launches}")
        e2e[backend] = torch.autograd.grad(
            loss_of(model.encode_img(micro["images"])), tensors)
    set_scan_backend(model, "auto")

    rel, at = _worst_rel(names, grads["auto"], grads["plain"])
    e2e_rel, e2e_at = _worst_rel(names, e2e["auto"], e2e["plain"])
    _check(rel <= TOWER_RTOL,
           f"grad of {at}: max rel err {rel:.3e} > {TOWER_RTOL}")
    _phase("train_grads", tensors=len(names), micro_batch=batch // accum,
           max_rel_err=f"{rel:.3e}", at=at, bound=TOWER_RTOL,
           e2e_max_rel_err=f"{e2e_rel:.3e}", e2e_at=e2e_at,
           kernel_s=f"{secs['auto']:.3f}", plain_s=f"{secs['plain']:.3f}")


def _n1_case(dev, gen, hw: int, dim: int, batch: int, dtype):
    """An initialised vssm1_base SS2D's scan weights at one stage, and
    random sources of its shape: (args of scan_n1_fwd, D, R)."""
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.vmamba import SS2D
    from medical_image_analysis_tpu_torch.ops import scan_n1 as sn

    m = SS2D(dim, d_state=1, disable_z=True, conv_bias=False, device=dev)
    init_params(m, gen)
    d_in = m.d_inner
    x = torch.randn(batch, hw, hw, d_in, device=dev, generator=gen)
    x = torch.nn.functional.silu(x).to(dtype)  # as SS2D feeds the scan
    xr = x.reshape(batch, hw * hw, d_in)
    xc = x.transpose(1, 2).reshape(batch, hw * hw, d_in).contiguous()
    with torch.no_grad():
        a = -torch.exp(m.A_log.float())
        x_dbl = sn._x_dbl(xr, xc, m.x_proj_w)
        w = sn._weights(m.dt_proj_w, m.dt_bias, a, m.D)
    return (xr, xc, x_dbl, *w), d_in, m.rank


def _n1_cases(batches=None):
    """(stage, batch, dtype): the four stages at each of ``batches`` (by
    default the training batch) in fp32, stage 2 at the training batch in
    bf16, stage 0 at batch 1."""
    cases = [(i, b, torch.float32) for b in batches or (N1_BATCH,)
             for i in range(len(N1_STAGES))]
    return cases + [(2, N1_BATCH, torch.bfloat16), (0, 1, torch.float32)]


def _in_turns(plain_fn, kernel_fn, plain_iters, kernel_iters):
    """Device ms of each, timed in turns: plain, kernel, kernel, plain."""
    t = {}
    for name, fn, iters in (("plain", plain_fn, plain_iters),
                            ("kernel", kernel_fn, kernel_iters),
                            ("kernel", kernel_fn, kernel_iters),
                            ("plain", plain_fn, plain_iters)):
        t[name] = t.get(name, 0.0) + device_ms(fn, iters) / 2
    return t


def phase_kernels_n1(dev, gen) -> tuple:
    """The forward against its plain version at every batch the main path
    gives it; each line also names the chunk ``fwd_chunk`` picks (L: one
    pass) and each forward kernel's grid blocks, resident blocks an SM and
    shared memory a block. Returns the JSON row (max abs error over the
    fp32 cases, and stage 0's times at the training batch, the longest
    chain of the main path)."""
    from medical_image_analysis_tpu_torch.ops import scan_n1 as sn

    worst, row = 0.0, None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for stage, b, dtype in _n1_cases(N1_FWD_BATCHES):
        hw, dim = N1_STAGES[stage]
        args, d_in, rank = _n1_case(dev, gen, hw, dim, b, dtype)
        chunk = sn.fwd_chunk(b, hw * hw, d_in, sms)
        occupancy = sn.fwd_occupancy(rank, dtype, chunk < hw * hw)
        want = sn.scan_n1_fwd_plain(*args)
        got = sn.scan_n1_fwd(*args)
        _sync(dev)
        _check(got.shape == want.shape and got.dtype == dtype,
               "scan_n1_fwd output shape or dtype")
        err, scale = _max_err(got, want)
        _check(err <= Y_RTOL[dtype] * scale,
               f"scan_n1_fwd stage {stage} B={b} {dtype}: max abs err "
               f"{err:.3e} > {Y_RTOL[dtype]} x {scale:.3f}")
        t = _in_turns(lambda: sn.scan_n1_fwd_plain(*args),
                      lambda: sn.scan_n1_fwd(*args), 2, 20)
        bound = _bound([*args, got], 4 * b * hw * hw * d_in * (2 * rank + 13))
        _phase("kernels_n1", stage=stage, B=b, L=hw * hw, D=d_in, R=rank,
               src="fp32" if dtype == torch.float32 else "bf16",
               err=f"{err:.3e}", ms=f"{t['kernel']:.4f}",
               plain_ms=f"{t['plain']:.4f}", bound_ms=f"{bound[0]:.4f}",
               bound_by=bound[1], chunk=chunk,
               regime="one_pass" if chunk >= hw * hw else "chunks",
               grid_blocks=_compact(sn.fwd_grid_blocks(b, hw * hw, d_in,
                                                       chunk)),
               blocks_per_sm=_compact(
                   {k: v[0] for k, v in occupancy.items()}),
               smem_bytes=_compact({k: v[1] for k, v in occupancy.items()}))
        if dtype == torch.float32:
            worst = max(worst, err)
            if stage == 0 and b == N1_BATCH:
                row = (t["kernel"], t["plain"], *bound[:2])
    return (worst, *row)


def phase_kernels_n1_bwd(dev, gen) -> tuple:
    """The backward's kernels against their plain version, every output,
    at every stage; each line also names the three kernels' grid blocks,
    resident blocks an SM and shared memory a block. The JSON row as
    ``phase_kernels_n1``'s."""
    from medical_image_analysis_tpu_torch.ops import scan_n1 as sn

    worst, row = 0.0, None
    for stage, b, dtype in _n1_cases():
        hw, dim = N1_STAGES[stage]
        args, d_in, rank = _n1_case(dev, gen, hw, dim, b, dtype)
        dy = torch.randn(2, b, hw * hw, d_in, device=dev,
                         generator=gen).to(dtype)
        want = sn.scan_n1_bwd_plain(*args, dy)
        got = sn.scan_n1_bwd(*args, dy)
        _sync(dev)
        errs = {}
        for name, g, wv in zip(N1_OUTPUTS, got, want):
            _check(g.shape == wv.shape and g.dtype == torch.float32,
                   f"scan_n1_bwd {name}: shape or dtype")
            err, scale = _max_err(g, wv)
            _check(err <= BWD_RTOL * scale,
                   f"scan_n1_bwd stage {stage} B={b} {dtype} {name}: max abs "
                   f"err {err:.3e} > {BWD_RTOL} x {scale:.3f}")
            errs[name] = err
        t = _in_turns(lambda: sn.scan_n1_bwd_plain(*args, dy),
                      lambda: sn.scan_n1_bwd(*args, dy), 1, 10)
        ops = 4 * b * hw * hw * d_in * (2 * (2 * rank + 13) + 2 * rank + 10)
        bound = _bound([*args, dy, *got], ops)
        occupancy = sn.bwd_occupancy(rank, dtype)
        _phase("kernels_n1_bwd", stage=stage, B=b, L=hw * hw, D=d_in, R=rank,
               src=_dtype_name(dtype), errs=_compact(
                   {k: f"{v:.3e}" for k, v in errs.items()}),
               ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}",
               bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
               grid_blocks=_compact(sn.bwd_grid_blocks(b, hw * hw, d_in)),
               blocks_per_sm=_compact(
                   {k: v[0] for k, v in occupancy.items()}),
               smem_bytes=_compact({k: v[1] for k, v in occupancy.items()}))
        if dtype == torch.float32:
            worst = max(worst, max(errs.values()))
            if stage == 0 and b == N1_BATCH:
                row = (t["kernel"], t["plain"], *bound[:2])
    return (worst, *row)


def _compact(d: dict) -> str:
    return json.dumps(d, separators=(",", ":"))


def _kernel_modules():
    from medical_image_analysis_tpu_torch.ops import (
        attention,
        mamba_fused,
        scan_n1,
        selective_scan_pallas,
        swin_block,
        vit_block,
    )

    return (mamba_fused, scan_n1, vit_block, swin_block,
            selective_scan_pallas, attention)


def _all_launches() -> dict:
    return {k: v for m in _kernel_modules() for k, v in m.launches.items()}


def _reset_launches() -> None:
    for m in _kernel_modules():
        m.reset_launches()


def phase_train_csr(vocab: int, save_dir: Path, device: str = "cuda",
                    overrides=()) -> dict:
    """R2GenCSR on vssm1_base for one epoch through the CLI; returns the
    model, the state, the overrides and the launch counts of the run.

    ``overrides`` come after the slice's own (a CPU rehearsal shrinks the
    widths with them)."""
    sets = (*VSSM1_OVERRIDES, *overrides)
    run = _csr_through_cli(vocab, save_dir, device, sets)
    model, n_steps = run["model"], run["n_steps"]

    # What the design implies: every SS2D launches the forward kernel once
    # for the study's images (with a gradient) and once for the context
    # images (without), and the backward kernel once; validation runs both
    # forwards per val batch. No remat for the VSSM, as in the JAX package.
    blocks = sum(model.vision.vssm.depths)
    val_batches = run["val_batches"]
    n_ctx = run["cfg"]["data"]["n_context"]
    _check_launches(
        run, {"scan_n1_fwd": (n_steps + val_batches) * 2 * blocks,
              "scan_n1_bwd": n_steps * blocks}, "train_csr",
        f"{blocks} SS2D blocks x 2 towers (study images with grad, "
        f"{2 * n_ctx} context images per study without) x ({n_steps} steps "
        f"+ {val_batches} val batches) forward, {blocks} x {n_steps} backward")
    _phase("train_csr", preset=CSR_PRESET.name, n_context=n_ctx,
           blocks=blocks, llm=f"{model.llm_cfg.dim}x{model.llm_cfg.n_layers}",
           params=sum(p.numel() for p in model.parameters()), **run["fields"])
    return {"model": model, "state": run["state"], "launches": run["launches"],
            "overrides": run["sets"]}


def _csr_through_cli(vocab: int, save_dir: Path, device: str, overrides):
    """The r2gencsr_iu preset for one epoch on the synthetic dataset
    through the CLI, ``overrides`` after the phase's own; checks, beyond
    ``_train_through_cli``'s, that every trainable group of the recipe is
    there. Returns that function's result and the ``--set`` items."""
    sets = ("data.dataset=synthetic", f"model.llm_kwargs.vocab_size={vocab}",
            "train.epochs=1", "train.save_state_every_epochs=2",
            "train.log_every=1", f"train.save_dir={save_dir}", *overrides)
    argv = ["--config", str(CSR_PRESET)]
    for item in sets:
        argv += ["--set", item]
    run = _train_through_cli(argv, save_dir, device)
    kinds = {k: any(n.startswith(k) for n in run["state"].params)
             for k in ("base/vision/", "base/proj/", "base/ctx_proj/",
                       "base/pos_marker", "base/neg_marker", "lora/")}
    _check(all(kinds.values()), f"trainable groups {kinds}")
    return {**run, "sets": sets}


def phase_train_csr_grads(model, state, overrides) -> None:
    """One batch of the slice's data: the vssm1 tower's and the
    projector's gradients through the kernels against those through the
    plain versions, both driven by one cotangent at ``encode_img``'s two
    outputs (the projected tokens and the global feature that the context
    residuals subtract from), taken once from the loss (plain path).
    Through the whole loss the two paths differ by the bf16 LLM's
    roundings (see ``phase_train_grads``): printed (``e2e_``), not bounded.
    The context residuals (the tower without a gradient, on the batch's
    context images) are held to the same bound.
    """
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend
    from medical_image_analysis_tpu_torch.ops import scan_n1 as sn
    from medical_image_analysis_tpu_torch.train.loop import (
        _device_batch,
        build_data,
    )

    cfg = load_config(str(CSR_PRESET),
                      [*overrides, "data.num_workers=1"])
    _, _, batcher, _ = build_data(cfg)
    train_b = batcher("train", n_context=cfg.data.n_context)
    try:
        host = next(train_b.batches(shuffle=False))
    finally:
        train_b.close()
    dev = next(model.parameters()).device
    b = _device_batch(host, dev)
    names = [n for n in state.params if n.startswith(("base/vision/",
                                                      "base/proj"))]
    tensors = [state.params[n] for n in names]
    blocks = sum(model.vision.vssm.depths)

    def loss_of(img, global_feat):
        prompt = model.context_prompt(img, global_feat, b["context_images"],
                                      b["before_ids"], b["after_ids"])
        return model._loss(prompt, b["target_ids"], b["target_mask"])

    set_scan_backend(model, "plain")
    outs = [o.detach().requires_grad_() for o in model.encode_img(b["images"])]
    cotangents = torch.autograd.grad(loss_of(*outs), outs)
    ctx = {}
    with torch.no_grad():
        for backend in ("auto", "plain"):
            set_scan_backend(model, backend)
            sn.reset_launches()
            ctx[backend] = model.context_residuals(outs[1],
                                                   b["context_images"])
            if backend == "auto" and dev.type == "cuda":
                _check(sn.launches == {"scan_n1_fwd": blocks,
                                       "scan_n1_bwd": 0},
                       f"context_residuals launches {sn.launches}")
    grads, e2e, secs = {}, {}, {}
    for backend in ("auto", "plain"):
        set_scan_backend(model, backend)
        sn.reset_launches()
        t0 = time.perf_counter()
        outs = model.encode_img(b["images"])
        grads[backend] = torch.autograd.grad(outs, tensors, cotangents)
        _sync(dev)
        secs[backend] = time.perf_counter() - t0
        if backend == "auto" and dev.type == "cuda":
            _check(sn.launches == {"scan_n1_fwd": blocks,
                                   "scan_n1_bwd": blocks},
                   f"train_csr_grads launches {sn.launches}")
        e2e[backend] = torch.autograd.grad(
            loss_of(*model.encode_img(b["images"])), tensors)
    set_scan_backend(model, "auto")

    rel, at = _worst_rel(names, grads["auto"], grads["plain"])
    e2e_rel, e2e_at = _worst_rel(names, e2e["auto"], e2e["plain"])
    ctx_rel, _ = _worst_rel(["context residuals"], [ctx["auto"]],
                            [ctx["plain"]])
    _check(rel <= TOWER_RTOL,
           f"grad of {at}: max rel err {rel:.3e} > {TOWER_RTOL}")
    _check(ctx_rel <= TOWER_RTOL,
           f"context residuals: max rel err {ctx_rel:.3e} > {TOWER_RTOL}")
    _phase("train_csr_grads", tensors=len(names), batch=cfg.data.batch_size,
           context_images=b["context_images"].shape[0]
           * b["context_images"].shape[1],
           ctx_max_rel_err=f"{ctx_rel:.3e}",
           max_rel_err=f"{rel:.3e}", at=at, bound=TOWER_RTOL,
           e2e_max_rel_err=f"{e2e_rel:.3e}", e2e_at=e2e_at,
           kernel_s=f"{secs['auto']:.3f}", plain_s=f"{secs['plain']:.3f}")


def _vit_weights(d: int, heads: int, dtype, dev, gen):
    """An initialised ``TransformerBlock``'s attention and MLP weights in
    ``dtype``, with biases and LayerNorm affines moved off their zero and
    one initial values, as training moves them."""
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.vit import TransformerBlock

    blk = TransformerBlock(d, heads, device=dev)
    init_params(blk, gen)
    with torch.no_grad():
        for p in (blk.qkv_bias, blk.proj_bias, blk.fc1_bias, blk.fc2_bias,
                  blk.ln1_bias, blk.ln2_bias):
            p.normal_(0.0, 0.02, generator=gen)
        for p in (blk.ln1_scale, blk.ln2_scale):
            p.normal_(1.0, 0.02, generator=gen)

    def w(*ps):
        return tuple(p.detach().to(dtype).contiguous() for p in ps)

    return {"attn": w(blk.qkv_kernel, blk.qkv_bias, blk.proj_kernel,
                      blk.proj_bias, blk.ln1_scale, blk.ln1_bias),
            "mlp": w(blk.fc1_kernel, blk.fc1_bias, blk.fc2_kernel,
                     blk.fc2_bias, blk.ln2_scale, blk.ln2_bias)}


def attn_library(x, wqkv, bqkv, wo, bo, g, b, heads):
    """The attention sub-layer as a composition of PyTorch calls
    (``F.layer_norm``, ``F.linear``, ``F.scaled_dot_product_attention``):
    the yardstick timed beside the kernels (``library_ms``). The port never
    calls it."""
    F = torch.nn.functional
    bsz, seq, d = x.shape
    h = F.layer_norm(x, (d,), g, b, 1e-6)
    qkv = F.linear(h, wqkv.t(), bqkv).view(bsz, seq, 3, heads, d // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2)
    return x + F.linear(o.reshape(bsz, seq, d), wo.t(), bo)


def mlp_library(x, w1, b1, w2, b2, g, b):
    """The MLP sub-layer as a composition of PyTorch calls; a yardstick as
    :func:`attn_library`."""
    F = torch.nn.functional
    h = F.layer_norm(x, (x.shape[-1],), g, b, 1e-6)
    hidden = F.gelu(F.linear(h, w1.t(), b1), approximate="tanh")
    return x + F.linear(hidden, w2.t(), b2)


def _vit_fns(kind: str, heads: int):
    """(kernel, plain, library, kernel bwd, plain bwd) of one sub-layer, each
    taking (x, *weights[, dy])."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    if kind == "mlp":
        return (vb.mlp_block_fwd, vb.mlp_block_plain, mlp_library,
                vb.mlp_block_bwd, vb.mlp_block_bwd_plain)

    def bind(fn):
        return lambda x, *a: fn(x, *a[:6], heads, *a[6:])

    return tuple(bind(f) for f in (
        vb.attn_block_fwd, vb.attn_block_plain, attn_library,
        vb.attn_block_bwd, vb.attn_block_bwd_plain))


def _iters(ops: float) -> int:
    """Calls to time: about 0.5 TFLOP of work, 2 to 20 calls."""
    return max(2, min(20, int(5e11 / ops)))


def _dtype_name(dtype) -> str:
    return "fp32" if dtype == torch.float32 else "bf16"


def phase_kernels_vit(dev, gen) -> dict:
    """Both forward kernels against their plain versions at ``VIT_CASES``;
    returns the JSON rows (``VIT_ROWS``: mae_hd_1280's encoder and decoder,
    B=16, fp32)."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    rows = {}
    for b, l, d, heads, dtype in VIT_CASES:
        weights = _vit_weights(d, heads, dtype, dev, gen)
        x = torch.randn(b, l, d, device=dev, generator=gen).to(dtype)
        for kind in ("attn", "mlp"):
            kernel, plain, library, _, _ = _vit_fns(kind, heads)
            args = (x, *weights[kind])
            work = vb.work(f"{kind}_fwd", b, l, d, heads, 4 * d)
            ops = sum(work)
            iters = _iters(ops)
            got = kernel(*args)
            _sync(dev)
            _check(got.shape == x.shape and got.dtype == dtype
                   and bool(torch.isfinite(got).all()),
                   f"vit_{kind}_fwd output shape, dtype or finiteness")
            err, scale = _max_err(got, plain(*args))
            _check(err <= VIT_RTOL[dtype] * scale,
                   f"vit_{kind}_fwd B={b} L={l} {dtype}: max abs err "
                   f"{err:.3e} > {VIT_RTOL[dtype]} x {scale:.3f}")
            t = _in_turns(lambda: plain(*args), lambda: kernel(*args),
                          iters, iters)
            lib_ms = device_ms(lambda: library(*args), iters)
            bound = _bound([*args, got], work, dtype)
            _phase("kernels_vit", kernel=f"vit_{kind}_fwd", B=b, L=l, d=d,
                   heads=heads, dtype=_dtype_name(dtype), err=f"{err:.3e}",
                   ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}",
                   library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound[0]:.4f}",
                   bound_by=bound[1], bound_on=bound[2],
                   tflops=f"{ops / t['kernel'] / 1e9:.2f}")
            if dtype == torch.float32 and (b, l) in VIT_ROWS:
                rows[f"vit_{kind}_fwd{VIT_ROWS[b, l][0]}"] = (
                    err, t["kernel"], t["plain"], *bound[:2], lib_ms)
            del got
    return rows


# The kernels of a ViT sub-layer call by part, as torch.profiler names them:
# the tensor-core GEMM, the attention core, the backward's dK/dV and dQ
# passes, the LayerNorm kernels and column sums; PyTorch's own kernels (the
# split-K partials' sums, copies) under "other". The Swin sub-layer's parts
# put its window core in the attention core's place. The CUDA-core GEMM
# and attention core are gone and must not run in any of them.
VIT_PARTS = (("gemm_tc", ("gemm_tc_kernel",)),
             ("core", ("attn_tc_fwd_kernel",)),
             ("dkv", ("attn_dkv_tc_kernel",)), ("dq", ("attn_dq_tc_kernel",)),
             ("ln_sums", ("ln_stats_kernel", "ln_apply_kernel",
                          "ln_bwd_kernel", "colsum_kernel")))
SWIN_PARTS = (VIT_PARTS[0], ("swin_core", ("swin_attn_core_kernel",)),
              ("ln", ("ln_stats_kernel", "ln_apply_kernel")))
SIMT_KERNELS = ("gemm_kernel", "attn_fwd_kernel")
# A split's profiles: at most this many, each with a spin kernel of this
# many cycles (about 25 ms on an H100) before and after the call.
PROFILE_ATTEMPTS = 3
PROFILE_SPIN = 50_000_000


def _named(key: str, names) -> bool:
    """Whether a kernel's profiler key holds one of ``names`` as a whole
    identifier (``gemm_kernel`` is not ``gemm_tc_kernel``)."""
    return any(re.search(rf"(?<!\w){n}(?!\w)", key) for n in names)


def _vit_parts(fn, what: str, names=VIT_PARTS) -> dict:
    """Device ms of one call of ``fn`` by part (``names``: ``VIT_PARTS``,
    or ``SWIN_PARTS``; the rest under "other"), from ``torch.profiler``;
    fails if a kernel of ``SIMT_KERNELS`` ran, or if no profile of
    ``PROFILE_ATTEMPTS`` adds up to within 20% of the call's time by CUDA
    events.

    The profiler can drop the first kernels it sees (a split of
    ``vit_attn_fwd`` once lost its 1.6 ms qkv GEMM), so each profile puts
    a spin kernel (``PROFILE_SPIN`` cycles, left out of the parts) on each
    side of the call, and a profile that still lost kernels is taken
    again."""
    from torch.profiler import ProfilerActivity, profile

    ms = device_ms(fn, 3)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(PROFILE_SPIN)
            fn()
            torch.cuda._sleep(PROFILE_SPIN)
            torch.cuda.synchronize()
        parts = dict.fromkeys([name for name, _ in names] + ["other"], 0.0)
        for e in prof.key_averages():
            us = e.self_device_time_total
            if us <= 0 or _named(e.key, ("spin_kernel",)):
                continue
            _check(not _named(e.key, SIMT_KERNELS),
                   f"{what} launched the CUDA-core kernel {e.key}")
            name = next((n for n, k in names if _named(e.key, k)), "other")
            parts[name] += us / 1e3
        total = sum(parts.values())
        if abs(total - ms) <= 0.2 * ms:
            return parts
        _phase("profile_lost_kernels", call=what, attempt=attempt,
               parts_ms=f"{total:.4f}", events_ms=f"{ms:.4f}")
    _check(False, f"{what}'s kernels by part add up to {total:.4f} ms, not "
           f"the {ms:.4f} ms of its CUDA events, in {PROFILE_ATTEMPTS} "
           f"profiles")


def phase_kernels_vit_bwd(dev, gen) -> dict:
    """Both backward kernels against the plain backwards at the fp32
    cases, every output; ms of the kernel, of the plain backward and of the
    library composition's forward + backward. Returns the JSON rows
    (``VIT_ROWS``)."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    rows = {}
    for b, l, d, heads, dtype in VIT_CASES:
        if dtype != torch.float32:
            continue
        weights = _vit_weights(d, heads, dtype, dev, gen)
        x = torch.randn(b, l, d, device=dev, generator=gen)
        dy = torch.randn(b, l, d, device=dev, generator=gen)
        for kind in ("attn", "mlp"):
            _, _, library, kernel, plain_bwd = _vit_fns(kind, heads)
            args = (x, *weights[kind])
            work = vb.work(f"{kind}_bwd", b, l, d, heads, 4 * d)
            ops = sum(work)
            iters = _iters(ops)
            got = kernel(*args, dy)
            want = plain_bwd(*args, dy)
            _sync(dev)
            errs = {}
            for name, g, wv in zip(VIT_GRADS[kind], got, want):
                _check(g.shape == wv.shape and g.dtype == torch.float32
                       and bool(torch.isfinite(g).all()),
                       f"vit_{kind}_bwd {name}: shape, dtype or finiteness")
                err, scale = _max_err(g, wv)
                _check(err <= BWD_RTOL * scale,
                       f"vit_{kind}_bwd B={b} L={l} {name}: max abs err "
                       f"{err:.3e} > {BWD_RTOL} x {scale:.3f}")
                errs[name] = err
            del want
            t = _in_turns(lambda: plain_bwd(*args, dy),
                          lambda: kernel(*args, dy), iters, iters)
            lib_leaves = [a.detach().clone().requires_grad_() for a in args]
            lib_ms = device_ms(lambda: torch.autograd.grad(
                library(*lib_leaves), lib_leaves, dy), iters)
            bound = _bound([*args, dy, *got], work)
            _phase("kernels_vit_bwd", kernel=f"vit_{kind}_bwd", B=b, L=l,
                   d=d, heads=heads,
                   errs=json.dumps({k: f"{v:.3e}" for k, v in errs.items()},
                                   separators=(",", ":")),
                   ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}",
                   library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound[0]:.4f}",
                   bound_by=bound[1], bound_on=bound[2],
                   tflops=f"{ops / t['kernel'] / 1e9:.2f}")
            row = (max(errs.values()), t["kernel"], t["plain"], *bound[:2],
                   lib_ms)
            if (b, l) in VIT_ROWS:
                rows[f"vit_{kind}_bwd{VIT_ROWS[b, l][0]}"] = row
            if kind == "attn" and b * l * d > 10**7 and dev.type == "cuda":
                parts = _vit_parts(lambda: kernel(*args, dy), "vit_attn_bwd")
                _phase("kernels_vit_bwd_parts", kernel="vit_attn_bwd", B=b,
                       L=l, d=d, heads=heads,
                       **{f"{k}_ms": f"{v:.4f}" for k, v in parts.items()})
            del got, lib_leaves
    return rows


def phase_kernels_vit_parts(dev, gen) -> None:
    """``vit_attn_fwd``, ``vit_mlp_fwd`` and ``vit_mlp_bwd`` split by kernel
    (``VIT_PARTS``) at the fp32 shapes of ``VIT_ROWS``, and both forwards
    at the bf16 case of ``VIT_CASES``, from ``torch.profiler``: one call
    each, after one to warm up, with the tensor-core GEMM's rate (its
    products over its time). None may launch a kernel of
    ``SIMT_KERNELS``."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    for b, l, d, heads, dtype in VIT_CASES:
        bf16 = dtype == torch.bfloat16
        if not bf16 and (b, l) not in VIT_ROWS:
            continue
        weights = _vit_weights(d, heads, dtype, dev, gen)
        x = torch.randn(b, l, d, device=dev, generator=gen).to(dtype)
        dy = torch.randn(b, l, d, device=dev, generator=gen)
        rows = b * l
        calls = [("vit_attn_fwd", 8 * rows * d * d,
                  lambda: vb.attn_block_fwd(x, *weights["attn"], heads)),
                 ("vit_mlp_fwd", 4 * rows * d * 4 * d,
                  lambda: vb.mlp_block_fwd(x, *weights["mlp"]))]
        if not bf16:  # the backward is fp32 only
            calls.append(("vit_mlp_bwd", 10 * rows * d * 4 * d,
                          lambda: vb.mlp_block_bwd(x, *weights["mlp"], dy)))
        for kernel, gemm_ops, fn in calls:
            parts = _vit_parts(fn, kernel)
            _phase("kernels_vit_parts", kernel=kernel, B=b, L=l, d=d,
                   heads=heads, dtype=_dtype_name(dtype),
                   total_ms=f"{sum(parts.values()):.4f}",
                   **{f"{k}_ms": f"{v:.4f}" for k, v in parts.items()},
                   gemm_tflops=f"{gemm_ops / parts['gemm_tc'] / 1e9:.2f}")
        del x, dy, weights


def phase_kernels_swin_parts(dev, gen) -> None:
    """``swin_attn_fwd`` at the kernels line's row (swin_large stage 2,
    B=64, shifted, fp32) split by kernel (``SWIN_PARTS``), with the
    tensor-core GEMM's rate. It runs beside ``kernels_vit_parts``, early in
    the process: after the training phases, the profiler lost the first
    kernels of this call in every attempt."""
    from medical_image_analysis_tpu_torch.ops import swin_block as sb

    name, embed, heads, images = SWIN_TOWERS[0]
    bn, d, nw = images * 4, embed << 2, 4
    x, w, bias, mask = _swin_inputs(bn, d, heads[2], nw, torch.float32, dev,
                                    gen)
    parts = _vit_parts(lambda: sb.swin_attn_fwd(x, *w, bias, mask, heads[2]),
                       "swin_attn_fwd", SWIN_PARTS)
    gemm_ops = 8 * bn * 49 * d * d  # q, k, v and the projection
    _phase("kernels_swin_parts", tower=name, stage=2, windows=bn, C=d,
           heads=heads[2], nW=nw, dtype="fp32",
           total_ms=f"{sum(parts.values()):.4f}",
           **{f"{k}_ms": f"{v:.4f}" for k, v in parts.items()},
           gemm_tflops=f"{gemm_ops / parts['gemm_tc'] / 1e9:.2f}")


def phase_train_mae(save_dir: Path, device: str = "cuda",
                    overrides=()) -> dict:
    """The mae_hd_1280 preset through the CLI for ``MAE_EPOCHS`` epochs;
    returns the model, the state, the overrides and the launch counts.
    ``overrides`` come after the phase's own (a CPU rehearsal shrinks the
    widths and the images with them)."""
    from medical_image_analysis_tpu_torch.models.vit import region_split

    sets = ("data.dataset=synthetic", f"train.epochs={MAE_EPOCHS}",
            f"train.save_state_every_epochs={MAE_EPOCHS + 1}",
            "train.log_every=1", f"train.save_dir={save_dir}", *overrides)
    argv = ["--config", str(MAE_PRESET)]
    for item in sets:
        argv += ["--set", item]
    run = _train_through_cli(argv, save_dir, device, epochs=MAE_EPOCHS,
                             validated=False)
    model, n_steps, cfg = run["model"], run["n_steps"], run["cfg"]
    l = model.num_patches(torch.empty(1, cfg["data"]["input_size"],
                                      cfg["data"]["input_size"], 1))
    idx_out, idx_in = region_split(l)
    keep = (int(len(idx_out) * (1 - cfg["model"]["mask_ratio"]))
            + int(len(idx_in) * (1 - cfg["model"]["mask_ratio_inner"])))

    # What the design implies: every TransformerBlock runs its attention and
    # MLP sub-layers through one forward and one backward wrapper call a
    # step (no remat, no validation).
    blocks = len(model.blocks) + len(model.decoder_blocks)
    _check_launches(
        run, dict.fromkeys(("vit_attn_fwd", "vit_mlp_fwd", "vit_attn_bwd",
                            "vit_mlp_bwd"), blocks * n_steps), "train_mae",
        f"{len(model.blocks)} encoder + {len(model.decoder_blocks)} decoder "
        f"blocks, each one attention and one MLP sub-layer forward and "
        f"backward, x {n_steps} steps")
    _phase("train_mae", preset=MAE_PRESET.name,
           params=sum(p.numel() for p in model.parameters()),
           encoder_tokens=1 + keep, decoder_tokens=1 + l, **run["fields"])
    return {"model": model, "state": run["state"],
            "launches": run["launches"], "overrides": sets}


def phase_train_mae_grads(model, overrides) -> None:
    """One batch of the preset's data with the first step's masking noise:
    the loss and every parameter's gradient through the kernels against
    the plain versions, forward and backward (``set_fused(model,
    False)``)."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.common import set_fused
    from medical_image_analysis_tpu_torch.ops import vit_block as vb
    from medical_image_analysis_tpu_torch.train.loop import (
        build_data,
        mae_loss_fn,
        mae_mask_noise,
    )

    cfg = load_config(str(MAE_PRESET), [*overrides, "data.num_workers=1"])
    _, _, batcher, _ = build_data(cfg)
    train_b = batcher("train")
    try:
        host = next(train_b.batches(shuffle=False))
    finally:
        train_b.close()
    dev = next(model.parameters()).device
    batch = cfg.data.batch_size
    imgs = torch.from_numpy(host["images"][:, 0]).to(dev)
    _check(imgs.shape[0] == batch, f"a batch of {imgs.shape[0]} images")
    noise = mae_mask_noise(cfg.train.seed, 0, batch, model.num_patches(imgs),
                           dev)
    loss_fn = mae_loss_fn(model, cfg.model)
    named = flax_named_parameters(model)
    names, tensors = list(named), list(named.values())
    blocks = len(model.blocks) + len(model.decoder_blocks)
    losses, grads, secs = {}, {}, {}
    for fused in (True, False):
        set_fused(model, fused)
        vb.reset_launches()
        t0 = time.perf_counter()
        loss = loss_fn({"images": imgs, "mask_noise": noise})
        grads[fused] = torch.autograd.grad(loss, tensors)
        _sync(dev)
        secs[fused] = time.perf_counter() - t0
        losses[fused] = loss.item()
        del loss
        if fused and dev.type == "cuda":
            _check(vb.launches == dict.fromkeys(vb.launches, blocks),
                   f"train_mae_grads launches {vb.launches}")
    set_fused(model, True)
    loss_rel = abs(losses[True] - losses[False]) / abs(losses[False])
    rel, at = _worst_rel(names, grads[True], grads[False])
    _check(loss_rel <= TOWER_RTOL,
           f"loss: rel err {loss_rel:.3e} > {TOWER_RTOL}")
    _check(rel <= TOWER_RTOL,
           f"grad of {at}: max rel err {rel:.3e} > {TOWER_RTOL}")
    _phase("train_mae_grads", tensors=len(names), batch=batch,
           loss=f"{losses[True]:.6f}", loss_rel_err=f"{loss_rel:.3e}",
           max_rel_err=f"{rel:.3e}", at=at, bound=TOWER_RTOL,
           kernel_s=f"{secs[True]:.3f}", plain_s=f"{secs[False]:.3f}")


def _swin_cases():
    """(tower, stage, windows, C, heads, nW, dtype): every stage of
    ``SWIN_TOWERS`` in fp32 (swin_large's shifted and unshifted where the
    stage has both, swin_base's shifted where it has one), and swin_large's
    stage 0, shifted, in bf16. At stage 3 the window covers the 7 x 7 map,
    so its blocks are unshifted."""
    cases = []
    for name, embed, heads, images in SWIN_TOWERS:
        for stage, h in enumerate(heads):
            per_image = (56 >> stage) ** 2 // 49
            shifts = [per_image] if per_image > 1 else []
            if per_image == 1 or name == "swin_large":
                shifts.append(1)  # the mask of an unshifted block: zeros
            cases += [(name, stage, images * per_image, embed << stage, h, nw,
                       torch.float32) for nw in shifts]
    name, embed, heads, images = SWIN_TOWERS[0]
    return cases + [(name, 0, images * 64, embed, heads[0], 64,
                     torch.bfloat16)]


def _swin_inputs(windows, d, heads, nw, dtype, dev, gen):
    """Windows (windows, 49, d) in ``dtype``, an initialised
    ``WindowAttention``'s weights with its biases, norm affine and bias
    table moved off their initial values, the (heads, 49, 49) bias and the
    (nW, 49, 49) shift mask (zeros (1, 49, 49) unshifted)."""
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.swin import (
        WindowAttention,
        _shift_attn_mask,
    )

    attn = WindowAttention(d, heads, 7, device=dev)
    init_params(attn, gen)
    with torch.no_grad():
        attn.relative_position_bias_table.normal_(0.0, 0.5, generator=gen)
        for p in (attn.qkv.bias, attn.proj.bias):
            p.normal_(0.0, 0.02, generator=gen)
        g = torch.randn(d, device=dev, generator=gen) * 0.02 + 1.0
        b = torch.randn(d, device=dev, generator=gen) * 0.02
        w = tuple(t.to(dtype).contiguous() for t in (
            attn.qkv.weight.t(), attn.qkv.bias, attn.proj.weight.t(),
            attn.proj.bias, g, b))
        bias = attn.rel_bias().contiguous()
    side = 7 * int(round(nw**0.5))
    mask = (torch.from_numpy(_shift_attn_mask(side, side, 7, 3)).to(dev)
            if nw > 1 else torch.zeros(1, 49, 49, device=dev))
    x = torch.randn(windows, 49, d, device=dev, generator=gen).to(dtype)
    return x, w, bias, mask


def swin_attn_library(x, wqkv, bqkv, wo, bo, g, b, bias, mask, heads):
    """The Swin window-attention sub-layer as a composition of PyTorch
    calls, the bias and shift mask summed into SDPA's ``attn_mask``: the
    yardstick timed beside the kernel (``library_ms``). The port never
    calls it."""
    F = torch.nn.functional
    bn, l, d = x.shape
    nw = mask.shape[0]
    h = F.layer_norm(x, (d,), g, b, 1e-5)
    qkv = F.linear(h, wqkv.t(), bqkv).view(bn, l, 3, heads, d // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    am = (bias[None] + mask[:, None]).to(x.dtype)  # (nW, heads, L, L)
    am = am.expand(bn // nw, nw, heads, l, l).reshape(bn, heads, l, l)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=am).transpose(1, 2)
    return x + F.linear(o.reshape(bn, l, d), wo.t(), bo)


def phase_kernels_swin(dev, gen) -> tuple:
    """The Swin kernel against its plain version at ``_swin_cases``;
    returns the JSON row: swin_large's stage 2 (18 of its 24 blocks) at
    B=64, shifted, fp32."""
    from medical_image_analysis_tpu_torch.ops import swin_block as sb

    row = None
    for name, stage, bn, d, heads, nw, dtype in _swin_cases():
        x, w, bias, mask = _swin_inputs(bn, d, heads, nw, dtype, dev, gen)
        args = (x, *w, bias, mask, heads)
        work = sb.work(bn, 49, d, heads)
        ops = sum(work)
        iters = _iters(ops)
        got = sb.swin_attn_fwd(*args)
        _sync(dev)
        _check(got.shape == x.shape and got.dtype == dtype
               and bool(torch.isfinite(got).all()),
               "swin_attn_fwd output shape, dtype or finiteness")
        err, scale = _max_err(got, sb.swin_attn_block_plain(*args))
        _check(err <= SWIN_RTOL[dtype] * scale,
               f"swin_attn_fwd {name} stage {stage} nW={nw} {dtype}: max abs "
               f"err {err:.3e} > {SWIN_RTOL[dtype]} x {scale:.3f}")
        t = _in_turns(lambda: sb.swin_attn_block_plain(*args),
                      lambda: sb.swin_attn_fwd(*args), iters, iters)
        lib_ms = device_ms(lambda: swin_attn_library(*args), iters)
        bound = _bound([x, *w, bias, mask, got], work, dtype)
        _phase("kernels_swin", tower=name, stage=stage, windows=bn, L=49,
               C=d, heads=heads, nW=nw, dtype=_dtype_name(dtype),
               err=f"{err:.3e}", ms=f"{t['kernel']:.4f}",
               plain_ms=f"{t['plain']:.4f}", library_ms=f"{lib_ms:.4f}",
               bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
               bound_on=bound[2],
               tflops=f"{ops / t['kernel'] / 1e9:.2f}")
        if (name, stage, nw, dtype) == ("swin_large", 2, 4, torch.float32):
            row = (err, t["kernel"], t["plain"], *bound[:2], lib_ms)
        del got
    return row


def _cls_through_cli(preset: str, save_dir: Path, device: str, overrides=()):
    """A classification preset for one epoch on ``synthetic_learnable``
    data through the CLI (``CLS_TRAIN`` train samples, the 64 val samples),
    ``overrides`` after the phase's own; returns ``_train_through_cli``'s
    result and the ``--set`` items."""
    sets = ("data.dataset=synthetic_learnable",
            f"data.synthetic_train_size={CLS_TRAIN[preset]}",
            "train.epochs=1", "train.save_state_every_epochs=2",
            "train.log_every=1", f"train.save_dir={save_dir}", *overrides)
    argv = ["--config", str(PRESET.parent / preset)]
    for item in sets:
        argv += ["--set", item]
    return {**_train_through_cli(argv, save_dir, device), "sets": sets}


def phase_train_cls(save_dir: Path, device: str = "cuda",
                    overrides=()) -> dict:
    """SwinCheX (the swinchex preset) for one epoch through the CLI; returns
    the run (model, state, launches, ``--set`` items)."""
    run = _cls_through_cli(CLS_PRESET.name, save_dir, device, overrides)
    model, n_steps, cfg = run["model"], run["n_steps"], run["cfg"]
    _check((cfg["train"]["mixup"], cfg["train"]["cutmix"]) == (0.8, 1.0),
           "swinchex without its mixup 0.8 / cutmix 1.0")
    # What the design implies: a training step needs a gradient through
    # every block, so it takes the unfused route (no launch); validation
    # runs under no_grad, one launch per block and val batch.
    blocks = sum(model.backbone.depths)
    val_batches = run["val_batches"]
    _check_launches(
        run, {"swin_attn_fwd": blocks * val_batches}, "train_cls",
        f"0 in {n_steps} training steps (unfused route); {blocks} blocks x "
        f"{val_batches} val batch(es) under no_grad")
    _phase("train_cls", preset=CLS_PRESET.name,
           params=sum(p.numel() for p in model.parameters()),
           images=cfg["data"]["input_size"], **run["fields"])
    return run


def _val_batch(preset: str, sets, dev) -> torch.Tensor:
    """The first validation batch's images (B, H, W, 3) of a classification
    preset's data, on ``dev``."""
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.train.loop import build_data

    cfg = load_config(str(PRESET.parent / preset), [*sets, "data.num_workers=1"])
    _, _, batcher, _ = build_data(cfg)
    vb = batcher("val")
    try:
        host = next(vb.batches(shuffle=False, drop_last=False))
    finally:
        vb.close()
    return torch.from_numpy(host["images"][:, 0]).to(dev)


def phase_tower_cls(model, sets) -> None:
    """One validation batch through the trained SwinCheX: logits through
    the kernel against the plain versions (``set_fused(model, False)``),
    in turns, wall seconds of each; then a forward and backward with a
    gradient, which must launch the kernel no time."""
    from medical_image_analysis_tpu_torch.models.common import set_fused
    from medical_image_analysis_tpu_torch.ops import swin_block as sb

    dev = next(model.parameters()).device
    imgs = _val_batch(CLS_PRESET.name, sets, dev)
    blocks = sum(model.backbone.depths)
    out, secs = {}, {}
    with torch.no_grad():
        for fused in (False, True, True, False):
            set_fused(model, fused)
            sb.reset_launches()
            _sync(dev)
            t0 = time.perf_counter()
            out[fused] = model(imgs)
            _sync(dev)
            secs[fused] = secs.get(fused, 0.0) + (time.perf_counter() - t0) / 2
            if fused and dev.type == "cuda":
                _check(sb.launches["swin_attn_fwd"] == blocks,
                       f"tower_cls launches {sb.launches}, expected {blocks}")
    set_fused(model, True)
    got, want = out[True], out[False]
    _check(bool(torch.isfinite(got).all()) and got.shape == want.shape
           == (imgs.shape[0], 14, 2), f"logits {tuple(got.shape)}")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    _check(rel <= TOWER_RTOL, f"tower_cls max rel err {rel:.3e} > "
           f"{TOWER_RTOL}")
    sb.reset_launches()
    model(imgs[:8]).float().sum().backward()
    model.zero_grad(set_to_none=True)
    _check(sb.launches["swin_attn_fwd"] == 0,
           f"{sb.launches['swin_attn_fwd']} launches with a gradient")
    _phase("tower_cls", batch=imgs.shape[0], shape=tuple(got.shape),
           max_rel_err=f"{rel:.3e}", bound=TOWER_RTOL, launches=blocks,
           grad_launches=0, kernel_s=f"{secs[True]:.3f}",
           plain_s=f"{secs[False]:.3f}")


def phase_train_cls_other(preset: str, save_dir: Path, device: str = "cuda",
                          overrides=()) -> dict:
    """``vssm_classify`` (phase ``train_cls_vssm``; ``train_cls_vssm_pallas``
    when ``overrides`` set ``scan_backend: pallas``) or ``dp_finetune``
    (``train_cls_dp``) for one epoch through the CLI, launches reckoned;
    returns the run."""
    run = _cls_through_cli(preset, save_dir, device, overrides)
    model, n_steps, val_b = run["model"], run["n_steps"], run["val_batches"]
    if preset == "vssm_classify.yaml" and VSSM_PALLAS in overrides:
        # every SS2D launches the general scan's forward kernel once per
        # forward and its backward once per step, the fused layer never;
        # no remat
        phase, blocks = "train_cls_vssm_pallas", sum(model.backbone.depths)
        _check(model.backbone.stage0_block0.op.scan_backend == "pallas",
               "vssm_classify not on scan_backend=pallas")
        reckoned = {"selective_scan_fwd": (n_steps + val_b) * blocks,
                    "selective_scan_bwd": n_steps * blocks}
        how = (f"{blocks} SS2D blocks x ({n_steps} steps + {val_b} val "
               f"batches) forward, x {n_steps} steps backward; 0 of the "
               f"fused layer")
    elif preset == "vssm_classify.yaml":
        # every SS2D (d_state 16, no conv in the fused layer) launches both
        # forward kernels once per forward and the backward once per step;
        # no remat
        phase, blocks = "train_cls_vssm", sum(model.backbone.depths)
        fwd = (n_steps + val_b) * blocks
        reckoned = {"mamba_xdbl": fwd, "mamba_scan": fwd,
                    "mamba_scan_bwd": n_steps * blocks}
        how = (f"{blocks} SS2D blocks x ({n_steps} steps + {val_b} val "
               f"batches) forward, x {n_steps} steps backward")
    else:
        # every TransformerBlock: one call of each forward wrapper per
        # forward, one of each backward wrapper per step
        phase, blocks = "train_cls_dp", len(model.encoder.blocks)
        reckoned = {
            **dict.fromkeys(("vit_attn_fwd", "vit_mlp_fwd"),
                            (n_steps + val_b) * blocks),
            **dict.fromkeys(("vit_attn_bwd", "vit_mlp_bwd"),
                            n_steps * blocks)}
        how = (f"{blocks} ViT blocks x ({n_steps} steps + {val_b} val "
               f"batches) forward, x {n_steps} steps backward")
    _check_launches(run, reckoned, phase, how)
    _phase(phase, preset=preset,
           params=sum(p.numel() for p in model.parameters()),
           ema=run["cfg"]["train"]["ema_decay"], **run["fields"])
    return run


def phase_train_csr_swin(vocab: int, save_dir: Path, device: str = "cuda",
                         overrides=()) -> dict:
    """R2GenCSR on its own Swin tower (the preset as it stands) for one
    epoch through the CLI; then, on the first training batch, both towers
    under no_grad (``encode_img`` and the context residuals, as validation
    runs them) through the kernel against the plain versions. Returns the
    run."""
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.common import set_fused
    from medical_image_analysis_tpu_torch.ops import swin_block as sb
    from medical_image_analysis_tpu_torch.train.loop import (
        _device_batch,
        build_data,
    )

    run = _csr_through_cli(vocab, save_dir, device, overrides)
    model, n_steps, val_b = run["model"], run["n_steps"], run["val_batches"]
    _check(run["cfg"]["model"]["vision"] == "swin", "not the Swin tower")
    # What the design implies: the study images need a gradient (the tower
    # trains), so they take the unfused route; the context images run
    # under no_grad, one launch per block a step; validation runs both
    # towers under no_grad.
    blocks = sum(model.vision.swin.depths)
    n_ctx = run["cfg"]["data"]["n_context"]
    _check_launches(
        run, {"swin_attn_fwd": blocks * (n_steps + 2 * val_b)},
        "train_csr_swin",
        f"{blocks} blocks x {n_steps} steps for the {2 * n_ctx} context "
        f"images per study (none for the study images: a gradient), + "
        f"{blocks} x 2 towers x {val_b} val batches")
    _phase("train_csr_swin", preset=CSR_PRESET.name, n_context=n_ctx,
           blocks=blocks, llm=f"{model.llm_cfg.dim}x{model.llm_cfg.n_layers}",
           params=sum(p.numel() for p in model.parameters()), **run["fields"])

    cfg = load_config(str(CSR_PRESET), [*run["sets"], "data.num_workers=1"])
    _, _, batcher, _ = build_data(cfg)
    train_b = batcher("train", n_context=cfg.data.n_context)
    try:
        host = next(train_b.batches(shuffle=False))
    finally:
        train_b.close()
    dev = next(model.parameters()).device
    b = _device_batch(host, dev)
    outs = {}
    with torch.no_grad():
        for fused in (True, False):
            set_fused(model, fused)
            sb.reset_launches()
            tok, glob = model.encode_img(b["images"])
            outs[fused] = (tok, glob, model.context_residuals(
                glob, b["context_images"]))
            if fused and dev.type == "cuda":
                _check(sb.launches["swin_attn_fwd"] == 2 * blocks,
                       f"train_csr_swin towers: launches {sb.launches}")
    set_fused(model, True)
    rel, at = _worst_rel(("image tokens", "global feature",
                          "context residuals"), outs[True], outs[False])
    _check(rel <= TOWER_RTOL, f"{at}: max rel err {rel:.3e} > {TOWER_RTOL}")
    _phase("train_csr_swin_towers", images=b["images"].shape[0]
           * b["images"].shape[1], context_images=b["context_images"].shape[0]
           * b["context_images"].shape[1], max_rel_err=f"{rel:.3e}", at=at,
           bound=TOWER_RTOL)
    return run


def _ss_case(dev, gen, batch: int, k: int, l: int, d: int, n: int, dtype):
    """The folded inputs of one general-scan call at a main-path shape: an
    initialised SS2D's A, D and delta bias (its 4 directions of d
    channels), u = silu(N(0, 1)) and delta ~ N(0, 0.5) in ``dtype``, and B
    and C read in place from a random (batch * k, L, R + 2N) x_dbl, as the
    models hand them over."""
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.vmamba import SS2D

    m = SS2D(d // 2, d_state=n, device=dev)
    init_params(m, gen)
    rows, r = batch * k, m.rank
    with torch.no_grad():
        a = -torch.exp(m.A_log.float())[:k].contiguous()
        dv, db = (p.detach()[:k].contiguous() for p in (m.D, m.dt_bias))
    u = torch.nn.functional.silu(
        torch.randn(rows, l, d, device=dev, generator=gen)).to(dtype)
    delta = (torch.randn(rows, l, d, device=dev, generator=gen)
             * 0.5).to(dtype)
    x_dbl = torch.randn(rows, l, r + 2 * n, device=dev, generator=gen)
    x_dbl = x_dbl.to(dtype)
    return u, delta, a, x_dbl[..., r : r + n], x_dbl[..., r + n :], dv, db


def _ss_cases(kind: str):
    """(case, batch, K, L, D, N, dtype): ARM-B at the phase's batch in fp32
    and bf16, vssm_tiny's four stages at B=128 in fp32, stage 0 in bf16."""
    k, l, d, n = SS_ARM
    cases = [("arm_b", SS_ARM_BATCH[kind], k, l, d, n, dtype)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(f"vssm_tiny_s{i}", SS_VSSM_BATCH, 4, l, d, 16, torch.float32)
              for i, (l, d) in enumerate(SS_VSSM_STAGES)]
    return cases + [("vssm_tiny_s0", SS_VSSM_BATCH, 4, *SS_VSSM_STAGES[0],
                     16, torch.bfloat16)]


def phase_kernels_ss(dev, gen, kind: str) -> tuple:
    """The general scan's forward (``kind="fwd"``, phase ``kernels_ss``) or
    backward kernel (``"bwd"``, ``kernels_ss_bwd``) against its plain
    version at ``_ss_cases``, every output: fp32 outputs within BWD_RTOL
    (1e-4) of max(1, max |plain|), outputs rounded to bf16 on both sides
    within one bf16 step (Y_RTOL). The plain versions hold B=128, so every
    case compares and times at the batch it prints. Returns the JSON row:
    vssm_tiny's stage 0 at B=128, fp32, the longest chain of the main
    path (no library call computes the scan: ``library_ms`` null)."""
    from medical_image_analysis_tpu_torch.ops import selective_scan_pallas as ssp

    row = None
    occupancy = {}
    names = (("y",) if kind == "fwd" else
             ("du", "ddelta", "dA", "dB", "dC", "dD", "ddelta_bias"))
    for case, b, k, l, d, n, dtype in _ss_cases(kind):
        args = _ss_case(dev, gen, b, k, l, d, n, dtype)
        if kind == "fwd":
            def plain():
                return (ssp.selective_scan_fwd_plain(*args, True),)

            def kernel():
                return (ssp.selective_scan_fwd(*args, True),)
            extra = []
        else:
            dy = torch.randn(b * k, l, d, device=dev, generator=gen).to(dtype)

            def plain():
                return ssp.selective_scan_bwd_plain(*args, dy, True)

            def kernel():
                return ssp.selective_scan_bwd(*args, dy, True)
            extra = [dy]
        want, got = plain(), kernel()
        _sync(dev)
        errs = {}
        for name, g, w in zip(names, got, want):
            _check(g.shape == w.shape and g.dtype == w.dtype
                   and bool(torch.isfinite(g).all()),
                   f"selective_scan_{kind} {name}: shape, dtype or finiteness")
            err, scale = _max_err(g, w)
            tol = Y_RTOL[g.dtype] if g.dtype == torch.bfloat16 else BWD_RTOL
            _check(err <= tol * scale,
                   f"selective_scan_{kind} {case} B={b} {dtype} {name}: max "
                   f"abs err {err:.3e} > {tol} x {scale:.3f}")
            errs[name] = err
        del want
        t = _in_turns(plain, kernel, 1, 20 if case == "arm_b" else 3)
        bound = _bound([*args, *extra, *got],
                       ssp.flops(kind, b * k, l, d, n))
        if kind == "bwd":  # resident blocks an SM, shared memory a block
            blocks, smem = ssp.bwd_occupancy(n, dtype)
            _check(blocks >= SS_BWD_MIN_BLOCKS,
                   f"selective_scan_bwd N={n} {dtype}: {blocks} blocks an SM "
                   f"(at least {SS_BWD_MIN_BLOCKS}), {smem} bytes of shared "
                   f"memory a block")
            occupancy = dict(blocks_per_sm=blocks, smem_bytes=smem)
        _phase("kernels_ss" if kind == "fwd" else "kernels_ss_bwd",
               case=case, B=b, K=k, L=l, D=d, N=n, src=_dtype_name(dtype),
               errs=json.dumps({k_: f"{v:.3e}" for k_, v in errs.items()},
                               separators=(",", ":")),
               ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}",
               bound_ms=f"{bound[0]:.4f}", bound_by=bound[1], **occupancy)
        if (case, dtype) == ("vssm_tiny_s0", torch.float32):
            row = (max(errs.values()), t["kernel"], t["plain"], *bound[:2])
        del args, got, extra
        torch.cuda.empty_cache()
    return row


def phase_tower_arm_pallas(dev, gen) -> dict:
    """``r2gengpt_mimic``'s ARM-B tower on ``scan_backend=pallas``
    (``build_mrg_model`` with that ``--set``; random weights from the seed;
    the LLM, which this phase does not run, cut to one layer and a
    1,000-token vocabulary) on one micro-batch of 3 samples x 2 views at
    224^2, remat on as the preset trains: ``encode_img`` forward and a
    backward from one cotangent at the projector's output, through the
    kernels and through ``pallas_plain``. The tower's and projector's
    gradients must agree within TOWER_RTOL (``train_grads``'s bound); the
    gap to the fused layer (``auto``, whose x_dbl is fp32 by design) is
    printed, not bounded. Returns the kernel run's launch counts."""
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.common import init_params
    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend
    from medical_image_analysis_tpu_torch.train.loop import build_mrg_model

    cfg = load_config(str(PRESET), [VSSM_PALLAS,
                                    "model.llm_kwargs={n_layers: 1}"])
    model = build_mrg_model(cfg, 1000, device=dev)
    init_params(model, gen)
    arm = model.vision.arm
    depth = len(arm.layers)
    _check(arm.remat and arm.layers[0].mixer.scan_backend == "pallas",
           "the ARM tower is not on remat + scan_backend=pallas")
    micro = cfg.data.batch_size // cfg.train.accum_steps
    size = cfg.data.input_size
    images = torch.randn(micro, cfg.data.num_views, size, size, 3,
                         device=dev, generator=gen)
    named = [(n, p) for n, p in model.named_parameters()
             if n.startswith(("vision.", "proj"))]
    names, tensors = [n for n, _ in named], [p for _, p in named]
    cot = None
    for backend in ("pallas", "pallas_plain", "auto"):
        # warm-up: each route's first forward and backward, with their
        # one-time set-up, kept out of the timed runs below
        set_scan_backend(model, backend)
        out = model.encode_img(images)
        if cot is None:
            cot = torch.randn(out.shape, device=dev, generator=gen)
        torch.autograd.grad(out, tensors, cot)
        del out
    grads, secs, launches = {}, {}, None
    for backend in ("pallas", "pallas_plain", "auto"):
        set_scan_backend(model, backend)
        _reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        out = model.encode_img(images)
        grads[backend] = torch.autograd.grad(out, tensors, cot)
        _sync(dev)
        secs[backend] = time.perf_counter() - t0
        if backend == "pallas":
            launches = _all_launches()
            want = {k: 0 for k in launches}
            want.update(selective_scan_fwd=2 * depth,
                        selective_scan_bwd=depth)
            print(f"tower_arm_pallas: launches reckoned: {depth} layers x 2 "
                  f"forwards (remat) and {depth} backwards -> "
                  f"{json.dumps(want, separators=(',', ':'))}", flush=True)
            if dev.type != "cuda":  # CPU tensors take the plain versions
                want = dict.fromkeys(want, 0)
            _check(launches == want, f"tower_arm_pallas launches {launches}")
        del out
    rel, at = _worst_rel(names, grads["pallas"], grads["pallas_plain"])
    fused_rel, fused_at = _worst_rel(names, grads["pallas"], grads["auto"])
    _check(rel <= TOWER_RTOL,
           f"tower_arm_pallas grad of {at}: max rel err {rel:.3e} > "
           f"{TOWER_RTOL}")
    _phase("tower_arm_pallas", images=micro * cfg.data.num_views,
           layers=depth, tensors=len(names), max_rel_err=f"{rel:.3e}", at=at,
           bound=TOWER_RTOL, fused_gap=f"{fused_rel:.3e}", fused_at=fused_at,
           kernel_s=f"{secs['pallas']:.3f}",
           plain_s=f"{secs['pallas_plain']:.3f}",
           fused_s=f"{secs['auto']:.3f}")
    return launches


def phase_kernels_attn(dev, gen) -> tuple:
    """``fused_attention`` (its kernel route) against ``attention_plain`` at
    ViT-B's widths (B=64, L=197, 12 heads of 64), fp32 and bf16, without a
    mask and with a causal one, q, k and v read in place from one (B, L, 3,
    H, hd) product: max error against ATTN_RTOL, ms of the kernel, the
    plain version and ``library_ms`` (``F.scaled_dot_product_attention``
    with the mask as ``attn_mask``), the bound and TFLOP/s. Then ViT-B at
    384^2 (L=577), where the dispatch takes the einsum route: 0 launches.
    Then the kernel's wrapper at ``ATTN_CHECKS`` (every head width, L = 50
    and 1,401), fp32 and bf16, with and without the mask, against the plain
    version. Returns the JSON row (fp32, no mask)."""
    from medical_image_analysis_tpu_torch.ops import attention as att

    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, l, h, hd = ATTN_VIT_B
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        for masked in (False, True):
            qkv = torch.randn(b, l, 3, h, hd, device=dev, generator=gen)
            q, k, v = qkv.to(dtype).unbind(2)
            mask = (torch.full((l, l), float("-inf"), device=dev).triu(1)
                    if masked else None)
            before = att.launches["fused_attention"]
            got = att.fused_attention(q, k, v, mask)
            _sync(dev)
            _check(att.launches["fused_attention"]
                   == before + (dev.type == "cuda"),
                   "fused_attention did not take its kernel route")
            _check(got.shape == q.shape and got.dtype == dtype
                   and bool(torch.isfinite(got).all()),
                   "fused_attention output shape, dtype or finiteness")
            err, scale = _max_err(got, att.attention_plain(q, k, v, mask))
            _check(err <= ATTN_RTOL[dtype] * scale,
                   f"fused_attention {dtype} mask={masked}: max abs err "
                   f"{err:.3e} > {ATTN_RTOL[dtype]} x {scale:.3f}")
            work = att.work(b, l, h, hd)
            ops = sum(work)
            iters = _iters(ops)
            t = _in_turns(lambda: att.attention_plain(q, k, v, mask),
                          lambda: att.fused_attention(q, k, v, mask),
                          iters, iters)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            am = None if mask is None else mask.to(dtype)
            lib_ms = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=am), iters)
            bound = _bound([q, k, v, mask, got], work, dtype)
            _phase("kernels_attn", B=b, L=l, heads=h, hd=hd,
                   dtype=_dtype_name(dtype),
                   mask="causal" if masked else "none", err=f"{err:.3e}",
                   ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}",
                   library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound[0]:.4f}",
                   bound_by=bound[1], bound_on=bound[2],
                   tflops=f"{ops / t['kernel'] / 1e9:.2f}")
            if dtype == torch.float32 and not masked:
                row = (err, t["kernel"], t["plain"], *bound[:2], lib_ms)
    for (b, l, h, hd), dtype, masked in itertools.product(
            ATTN_CHECKS, (torch.float32, torch.bfloat16), (False, True)):
        qkv = torch.randn(b, l, 3, h, hd, device=dev, generator=gen)
        q, k, v = qkv.to(dtype).unbind(2)
        mask = (torch.full((l, l), float("-inf"), device=dev).triu(1)
                if masked else None)
        got = att.attention_fwd(q, k, v, mask)
        _sync(dev)
        _check(got.shape == q.shape and got.dtype == dtype
               and bool(torch.isfinite(got).all()),
               "attention_fwd output shape, dtype or finiteness")
        err, scale = _max_err(got, att.attention_plain(q, k, v, mask))
        _check(err <= ATTN_RTOL[dtype] * scale,
               f"attention_fwd B={b} L={l} hd={hd} {dtype} mask={masked}: "
               f"max abs err {err:.3e} > {ATTN_RTOL[dtype]} x {scale:.3f}")
        _phase("kernels_attn", B=b, L=l, heads=h, hd=hd,
               dtype=_dtype_name(dtype), mask="causal" if masked else "none",
               err=f"{err:.3e}", checked=True)
        del qkv, q, k, v, got
    b, l, h, hd = ATTN_EINSUM
    q, k, v = torch.randn(3, b, l, h, hd, device=dev, generator=gen).unbind(0)
    before = att.launches["fused_attention"]
    out = att.fused_attention(q, k, v)
    _sync(dev)
    _check(att.launches["fused_attention"] == before,
           "the einsum route launched the kernel")
    _check(out.shape == q.shape and bool(torch.isfinite(out).all()),
           "einsum route output shape or finiteness")
    _phase("kernels_attn", B=b, L=l, heads=h, hd=hd, dtype="fp32",
           route="einsum", tile_bytes=8 * l * l * 4, launches=0)
    return row


def phase_attn(dev, gen) -> dict:
    """``models/vit.py:Attention(768, 12)`` on (64, 197, 768) with seeded
    weights (biases moved off zero): the module through the kernel against
    ``set_fused(model, False)`` within ATTN_RTOL, then a forward and
    backward with a gradient, which must launch the kernel no time. Returns
    the kernel run's launch counts (the counts at 0 just before it)."""
    from medical_image_analysis_tpu_torch.models.common import (
        init_params,
        set_fused,
    )
    from medical_image_analysis_tpu_torch.models.vit import Attention
    from medical_image_analysis_tpu_torch.ops import attention as att

    b, l, h, hd = ATTN_VIT_B
    m = Attention(h * hd, h, device=dev)
    init_params(m, gen)
    with torch.no_grad():
        for p in (m.qkv.bias, m.proj.bias):
            p.normal_(0.0, 0.02, generator=gen)
    x = torch.randn(b, l, h * hd, device=dev, generator=gen)
    out, secs = {}, {}
    for fused in (True, False):
        set_fused(m, fused)
        _reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            out[fused] = m(x)
        _sync(dev)
        secs[fused] = time.perf_counter() - t0
        if fused:
            launches = _all_launches()
            want = dict.fromkeys(launches, 0)
            want["fused_attention"] = int(dev.type == "cuda")
            _check(launches == want, f"attn launches {launches}")
    set_fused(m, True)
    err, scale = _max_err(out[True], out[False])
    _check(err <= ATTN_RTOL[torch.float32] * scale,
           f"attn: max abs err {err:.3e} > {ATTN_RTOL[torch.float32]} x "
           f"{scale:.3f}")
    att.reset_launches()
    m(x).sum().backward()
    _sync(dev)
    _check(att.launches["fused_attention"] == 0,
           f"{att.launches['fused_attention']} launches with a gradient")
    _phase("attn", shape=tuple(x.shape), heads=h, max_abs_err=f"{err:.3e}",
           bound=ATTN_RTOL[torch.float32], launches=1, grad_launches=0,
           kernel_s=f"{secs[True]:.4f}", plain_s=f"{secs[False]:.4f}")
    return launches


def main() -> None:
    phase_device()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED)
    from medical_image_analysis_tpu_torch.configs.config import load_config

    cfg = load_config(str(PRESET))
    phase_build()
    measured = phase_kernels(cfg, dev, gen)
    phase_kernels_fwd_vssm(dev, gen)
    measured["mamba_scan_bwd"] = phase_kernels_bwd(cfg, dev, gen)
    measured["scan_n1_fwd"] = phase_kernels_n1(dev, gen)
    measured["scan_n1_bwd"] = phase_kernels_n1_bwd(dev, gen)
    _reset_launches()
    pipe, png, launches, depth = phase_serve(str(PRESET), VOCAB, "cuda",
                                             REQUESTS)
    for name in ("mamba_xdbl", "mamba_scan"):
        _check(launches.get(name, 0) == depth * REQUESTS,
               f"{name} launched {launches.get(name, 0)} times while serving; "
               f"expected {depth} layers x {REQUESTS} requests")
    _check(launches.get("mamba_scan_bwd") == 0,
           "the backward kernel launched while serving")
    phase_tower(pipe, png)
    del pipe
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        run = phase_train(str(PRESET), VOCAB, Path(tmp))
    phase_train_grads(run["model"], run["state"], str(PRESET), run["batch"],
                      run["accum"])
    train_launches = run["launches"]
    del run
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_csr_") as tmp:
        csr = phase_train_csr(VOCAB, Path(tmp))
    phase_train_csr_grads(csr["model"], csr["state"], csr["overrides"])
    csr_launches = csr["launches"]
    del csr
    torch.cuda.empty_cache()
    measured.update(phase_kernels_vit(dev, gen))
    measured.update(phase_kernels_vit_bwd(dev, gen))
    phase_kernels_vit_parts(dev, gen)
    phase_kernels_swin_parts(dev, gen)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mae_") as tmp:
        mae = phase_train_mae(Path(tmp))
    phase_train_mae_grads(mae["model"], mae["overrides"])
    runs = [launches, train_launches, csr_launches, mae["launches"]]
    del mae
    torch.cuda.empty_cache()

    measured["swin_attn_fwd"] = phase_kernels_swin(dev, gen)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cls_") as tmp:
        cls = phase_train_cls(Path(tmp))
    phase_tower_cls(cls["model"], cls["sets"])
    runs.append(cls["launches"])
    del cls
    cls_fields = {}
    for preset in ("vssm_classify.yaml", "dp_finetune.yaml"):
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cls_") as tmp:
            other = phase_train_cls_other(preset, Path(tmp))
        runs.append(other["launches"])
        cls_fields[preset] = other["fields"]
        del other
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_csr_swin_") as tmp:
        runs.append(phase_train_csr_swin(VOCAB, Path(tmp))["launches"])

    torch.cuda.empty_cache()
    measured["selective_scan_fwd"] = phase_kernels_ss(dev, gen, "fwd")
    measured["selective_scan_bwd"] = phase_kernels_ss(dev, gen, "bwd")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cls_") as tmp:
        pallas = phase_train_cls_other("vssm_classify.yaml", Path(tmp),
                                       overrides=(VSSM_PALLAS,))
    runs.append(pallas["launches"])
    fused = cls_fields["vssm_classify.yaml"]
    _phase("train_cls_vssm_pallas_vs_fused", **{
        f"{k}{suffix}": f[k] for k in ("step_s", "val_s", "peak_mem_gib")
        for suffix, f in (("", pallas["fields"]), ("_fused", fused))})
    del pallas
    torch.cuda.empty_cache()
    runs.append(phase_tower_arm_pallas(dev, gen))
    torch.cuda.empty_cache()
    measured["fused_attention"] = phase_kernels_attn(dev, gen)
    runs.append(phase_attn(dev, gen))

    # launches: the main paths' runs (serving, the eight trainings, the
    # ARM tower on scan_backend=pallas, the Attention module), each read
    # just after it was driven with the counts at 0
    main_runs = {name: sum(run.get(name, 0) for run in runs)
                 for name in REPLACES}
    sources = {k: m.KERNEL_SOURCE for m in _kernel_modules()
               for k in m.launches}
    kernels = []
    vit = ("vit_attn_fwd", "vit_mlp_fwd", "vit_attn_bwd", "vit_mlp_bwd")
    for name in REPLACES:
        for suffix, case in (VIT_ROWS.values() if name in vit
                             else [("", None)]):
            err, ms, plain_ms, bound_ms, bound_by, *lib = measured[
                name + suffix]
            kernels.append({
                "name": name, "route": "cuda", "source": sources[name],
                "replaces": REPLACES[name], "launches": main_runs[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib[0] if lib else None})
            if case is not None:  # launches: both shapes' (and dp's)
                kernels[-1]["case"] = case
    _check(all(k["launches"] > 0 for k in kernels),
           f"a kernel of the main paths never launched: {main_runs}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
