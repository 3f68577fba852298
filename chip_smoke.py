#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Each phase prints one line, and any failure
raises (exit code 1):

1. device   -- a CUDA card is required; prints its name and power limit.
2. build    -- compiles ``medical_image_analysis_tpu_torch/csrc/mamba_fused.cu``
               with nvcc for sm_90a into ``build/kernels/``.
3. kernels  -- both fused-Mamba kernels against their plain PyTorch versions
               on the card, at the ARM-B layer shapes of the
               ``r2gengpt_mimic`` preset (K=4, L=197, D=768, N=16, R=48),
               batch 1 and 6, fp32 and bf16 sources; the device time of
               each beside its plain version's.
4. serve    -- the preset at full width (ARM-B 768x12 + qwen1_5_1_8b with
               Qwen1.5's vocabulary of 151,936; random weights from a seed)
               behind ``cli.demo.make_server``: synthetic 224x224 PNGs are
               POSTed, beam 3, 120 new tokens. Each reply is checked, and
               each kernel must have launched once per ARM layer per request.
5. tower    -- ``encode_img`` of one image through the kernels and through
               the plain versions; the relative gap is held to a bound.

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
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

SEED = 0
VOCAB = 151936  # Qwen1.5's published vocabulary, used as a size only
REQUESTS = 3
PRESET = (Path(__file__).resolve().parent / "medical_image_analysis_tpu"
          / "configs" / "presets" / "r2gengpt_mimic.yaml")
REPLACES = {
    "mamba_xdbl": "medical_image_analysis_tpu/ops/mamba_fused.py:111",
    "mamba_scan": "medical_image_analysis_tpu/ops/mamba_fused.py:145",
}

# Tolerances, relative to max(1, max |plain|):
# x_dbl is fp32 from identical inputs; only the order of the sum over D
# differs.
XDBL_RTOL = 1e-4
# y: fp32 as x_dbl. From bf16 sources both sides compute in fp32 and
# round once to bf16 at the end, where they may land one bf16 step
# (2^-8 relative) apart.
Y_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# The tower through 12 layers, fp32: reordered sums, compounded per layer
# and rescaled by the final LayerNorm and projector.
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
    from medical_image_analysis_tpu_torch.ops import mamba_fused

    t0 = time.perf_counter()
    _, log = mamba_fused.build()
    secs = time.perf_counter() - t0
    for line in log.splitlines():  # ptxas: registers, shared memory, spills
        if "ptxas info" in line or "spill" in line:
            print(line.strip(), file=sys.stderr)
    _phase("build", seconds=f"{secs:.2f}", source=mamba_fused.KERNEL_SOURCE)


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


def phase_kernels(cfg, dev, gen, batches=(1, 6)) -> dict:
    """Kernels against plain versions; returns the serving-shape row
    (batch 1, fp32) for the kernels' JSON line."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    mixer, seq_len, cls_pos = preset_layer(cfg, dev, gen)
    with torch.no_grad():
        w = dict(conv_w=mixer.conv_w, conv_b=mixer.conv_b,
                 x_proj_w=mixer.x_proj_w, dt_proj_w=mixer.dt_proj_w,
                 dt_bias=mixer.dt_bias, A=-torch.exp(mixer.A_log), D=mixer.D)
        w = {k: v.detach().float().contiguous() for k, v in w.items()}
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


def main() -> None:
    phase_device()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED)
    from medical_image_analysis_tpu_torch.configs.config import load_config

    cfg = load_config(str(PRESET))
    phase_build()
    serving = phase_kernels(cfg, dev, gen)
    pipe, png, launches, depth = phase_serve(str(PRESET), VOCAB, "cuda",
                                             REQUESTS)
    for name in REPLACES:
        _check(launches.get(name, 0) == depth * REQUESTS,
               f"{name} launched {launches.get(name, 0)} times while serving; "
               f"expected {depth} layers x {REQUESTS} requests")
    phase_tower(pipe, png)
    from medical_image_analysis_tpu_torch.ops.mamba_fused import KERNEL_SOURCE

    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": serving[name][0], "ms": serving[name][1],
         "plain_ms": serving[name][2]}
        for name in REPLACES
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
