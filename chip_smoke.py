#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Each phase prints one line, and any failure
raises (exit code 1):

1. device   -- a CUDA card is required; prints its name and power limit.
2. build    -- compiles ``medical_image_analysis_tpu_torch/csrc/mamba_fused.cu``
               and ``csrc/scan_n1.cu`` with nvcc for sm_90a into
               ``build/kernels/``, one nvcc per source, both at once.
3. kernels  -- both fused-Mamba forward kernels against their plain
               PyTorch versions on the card, at the ARM-B layer shapes of
               the ``r2gengpt_mimic`` preset (K=4, L=197, D=768, N=16,
               R=48), batch 1 and 6, fp32 and bf16 sources; the device time
               of each beside its plain version's.
   kernels_bwd -- the backward kernel (``scan_bwd``) against
               ``scan_bwd_plain`` at the same shapes: the max error of each
               output and the device times.
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
8. kernels_n1 -- the d_state=1 scan's forward kernel (``scan_n1_fwd``)
               against ``scan_n1_fwd_plain`` at the four stage shapes of
               vssm1_base at every batch the main path gives it (B=12
               tower images, 36 context images, 4 images of validation's
               last batch; fp32), stage 2 in bf16 and stage 0 at B=1; max
               error and device times.
   kernels_n1_bwd -- its backward kernel against ``scan_n1_bwd_plain`` at
               the training batch (B=12), stage 2 in bf16 and stage 0 at
               B=1, every output.
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

Then one JSON line of the kernels, and the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

TF32 is off for matmuls and for cuDNN throughout, since the comparisons
are made in fp32.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
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
PRESET = (Path(__file__).resolve().parent / "medical_image_analysis_tpu"
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


def _phase(phase: str, /, **fields) -> None:
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

    from medical_image_analysis_tpu_torch.ops import mamba_fused, scan_n1

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc per source
        logs = list(pool.map(lambda m: m.build()[1], (mamba_fused, scan_n1)))
    secs = time.perf_counter() - t0
    for log in logs:  # ptxas: registers, shared memory, spills
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(line.strip(), file=sys.stderr)
    _phase("build", seconds=f"{secs:.2f}",
           sources=",".join((mamba_fused.KERNEL_SOURCE, scan_n1.KERNEL_SOURCE)))


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
            )
            if b == 1 and dtype == torch.float32:
                serving = {
                    "mamba_xdbl": (err_x, t["xdbl"], t["xdbl_plain"]),
                    "mamba_scan": (err_y, t["scan"], t["scan_plain"]),
                }
    return serving


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
            errs = {}
            for name, g, wv in zip(BWD_OUTPUTS, got, want):
                _check(g.shape == wv.shape and g.dtype == torch.float32,
                       f"mamba_scan_bwd {name}: shape or dtype")
                err, scale = _max_err(g, wv)
                _check(err <= BWD_RTOL * scale,
                       f"mamba_scan_bwd B={b} {dtype} {name}: max abs err "
                       f"{err:.3e} > {BWD_RTOL} x {scale:.3f}")
                errs[name] = err
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
            )
            if b == 6 and dtype == torch.float32:
                training = (max(errs.values()), t["kernel"], t["plain"])
    return training


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


def _train_through_cli(argv: list[str], save_dir: Path, device: str) -> dict:
    """``cli.train.main(argv)`` for one epoch, with the kernels' counts at 0
    just before and read just after. Checks what every training run must
    show: the steps of the epoch, each finite; one validation with finite
    scores; the delta written; every trainable tensor moved and no frozen
    one. Returns the model, the state, the run's config and counts, and the
    fields that the phases print."""
    from medical_image_analysis_tpu_torch.cli import train as cli_train

    seen = {}

    def on_start(model, state):
        seen["model"], seen["state"] = model, state
        seen["trainable"] = {n: p.detach().clone()
                             for n, p in state.params.items()}
        seen["frozen"] = {n: _fingerprint(p) for n, p in state.frozen.items()}

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
    with open(save_dir / "log.txt") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "step" in r]
    vals = [r for r in records if "val_s" in r]
    n_steps = TRAIN_SAMPLES // batch
    _check(len(steps) == n_steps, f"{len(steps)} steps, expected {n_steps}")
    _check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in steps), "a non-finite loss or grad norm")
    _check(len(vals) == 1 and all(np.isfinite(v) for v in scores.values()),
           "validation missing or non-finite scores")
    deltas = sorted(save_dir.glob("checkpoint_epoch0_*.pt"))
    _check(len(deltas) == 1 and (save_dir / "checkpoint_best.pt").exists(),
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
        val_s=f"{vals[0]['val_s']:.3f}", total_s=f"{total_s:.2f}",
        peak_mem_gib=f"{peak / 2**30:.3f}", bleu4=f"{scores['Bleu_4']:.4f}",
        launches=json.dumps(launches, separators=(",", ":")),
    )
    val_bs = cfg["data"]["val_batch_size"] or batch
    return {"model": model, "state": state, "cfg": cfg, "cuda": cuda,
            "n_steps": n_steps, "val_batches": -(-VAL_SAMPLES // val_bs),
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
    """The forward kernel against its plain version at every batch the
    main path gives it; returns the JSON row (max abs error over the fp32
    cases, and stage 0's times at the training batch, the longest chain of
    the main path)."""
    from medical_image_analysis_tpu_torch.ops import scan_n1 as sn

    worst, row = 0.0, None
    for stage, b, dtype in _n1_cases(N1_FWD_BATCHES):
        hw, dim = N1_STAGES[stage]
        args, d_in, rank = _n1_case(dev, gen, hw, dim, b, dtype)
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
        _phase("kernels_n1", stage=stage, B=b, L=hw * hw, D=d_in, R=rank,
               src="fp32" if dtype == torch.float32 else "bf16",
               err=f"{err:.3e}", ms=f"{t['kernel']:.4f}",
               plain_ms=f"{t['plain']:.4f}")
        if dtype == torch.float32:
            worst = max(worst, err)
            if stage == 0 and b == N1_BATCH:
                row = (t["kernel"], t["plain"])
    return (worst, *row)


def phase_kernels_n1_bwd(dev, gen) -> tuple:
    """The backward kernel against its plain version, every output; the
    JSON row as ``phase_kernels_n1``'s."""
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
        _phase("kernels_n1_bwd", stage=stage, B=b, L=hw * hw, D=d_in, R=rank,
               src="fp32" if dtype == torch.float32 else "bf16",
               errs=json.dumps({k: f"{v:.3e}" for k, v in errs.items()},
                               separators=(",", ":")),
               ms=f"{t['kernel']:.4f}", plain_ms=f"{t['plain']:.4f}")
        if dtype == torch.float32:
            worst = max(worst, max(errs.values()))
            if stage == 0 and b == N1_BATCH:
                row = (t["kernel"], t["plain"])
    return (worst, *row)


def _all_launches() -> dict:
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
    from medical_image_analysis_tpu_torch.ops import scan_n1 as sn

    return {**mf.launches, **sn.launches}


def _reset_launches() -> None:
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
    from medical_image_analysis_tpu_torch.ops import scan_n1 as sn

    mf.reset_launches()
    sn.reset_launches()


def phase_train_csr(vocab: int, save_dir: Path, device: str = "cuda",
                    overrides=()) -> dict:
    """R2GenCSR on vssm1_base for one epoch through the CLI; returns the
    model, the state, the overrides and the launch counts of the run.

    ``overrides`` come after the slice's own (a CPU rehearsal shrinks the
    widths with them)."""
    sets = ("data.dataset=synthetic", *VSSM1_OVERRIDES,
            f"model.llm_kwargs.vocab_size={vocab}", "train.epochs=1",
            "train.save_state_every_epochs=2", "train.log_every=1",
            f"train.save_dir={save_dir}", *overrides)
    argv = ["--config", str(CSR_PRESET)]
    for item in sets:
        argv += ["--set", item]
    run = _train_through_cli(argv, save_dir, device)
    model, state, n_steps = run["model"], run["state"], run["n_steps"]
    kinds = {k: any(n.startswith(k) for n in state.params)
             for k in ("base/vision/", "base/proj/", "base/ctx_proj/",
                       "base/pos_marker", "base/neg_marker", "lora/")}
    _check(all(kinds.values()), f"trainable groups {kinds}")

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
    return {"model": model, "state": state, "launches": run["launches"],
            "overrides": sets}


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


def main() -> None:
    phase_device()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED)
    from medical_image_analysis_tpu_torch.configs.config import load_config

    cfg = load_config(str(PRESET))
    phase_build()
    measured = phase_kernels(cfg, dev, gen)
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
    from medical_image_analysis_tpu_torch.ops import mamba_fused, scan_n1

    # launches: the main paths' runs (serving, the two trainings), each
    # read just after it was driven with the counts at 0
    main_runs = {name: launches.get(name, 0) + train_launches.get(name, 0)
                 + csr["launches"].get(name, 0) for name in REPLACES}
    kernels = [
        {"name": name, "route": "cuda",
         "source": (scan_n1 if name.startswith("scan_n1")
                    else mamba_fused).KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": main_runs[name],
         "max_abs_err": measured[name][0], "ms": measured[name][1],
         "plain_ms": measured[name][2]}
        for name in REPLACES
    ]
    _check(all(k["launches"] > 0 for k in kernels),
           f"a kernel of the main paths never launched: {main_runs}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
