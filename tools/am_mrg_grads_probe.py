#!/usr/bin/env python3
"""``chip_smoke.py``'s ``train_am_mrg_grads`` check under many string-hash
seeds, with two witnesses that tell a kernel gap from an ill-conditioned
gradient, on one NVIDIA GPU.

    python3 tools/am_mrg_grads_probe.py [--seeds 4-27] [--parallel 3]
        [--out chiprun_out/am_mrg_grads_probe.jsonl]
        [--device cpu --set <item> ...]

``--device cpu`` with ``--set`` items that shrink the preset tries the
script on the CPU, where every wrapper runs its plain version (every gap
is then 0).

The synthetic pixels are seeded by Python's salted ``hash(sample.id)``
(``data/datasets.py``), so each process trains AM-MRG on other images and
the check reads another number. For each seed a child process is started
under ``PYTHONHASHSEED=<seed>``; it runs ``phase_train_am_mrg`` (the
am_mrg_mimic preset at full width, 5 steps and one validation, as the
smoke does) and then, on the phase's first batch and cotangent:

- ``check``: the phase's own reading, the largest relative gradient gap
  between the kernel path and ``scan_backend="plain"`` over every
  trainable tensor before the LLM but the ``ZERO_GRAD`` ones (bound
  ``TOWER_RTOL``), and the tensor where it is largest;
- ``tokens_gap``: the ARM's view-averaged tokens, kernel against plain,
  largest gap over the largest token;
- the downstream tensors (the Q-Former, its projection, both Hopfield
  memories and the four projections: everything after the ARM, plain
  PyTorch on both paths) have gradients that depend on the path only
  through those tokens. Their gradients at the plain tokens are held
  against (a) those at the kernel's tokens (``kernel``: the check's own
  gap), (b) those at the plain tokens plus Gaussian noise of the kernel
  gap's root mean square, two draws from seed 0 (``noise``: what any
  perturbation of that size does), and (c) the same modules in fp64 at
  the plain tokens (``fp64``: the fp32 computation's own error). Each is
  the largest, over the tensors but the ``ZERO_GRAD`` ones, of
  max |g - g_plain| / max |g_plain| (for ``fp64`` of
  max |g_plain - g_fp64| / max |g_fp64|), with its tensor, and the
  reading of the check's worst tensor in each.

A seed whose ``check`` exceeds the bound is run again in a new process to
show that it repeats. One JSON line per child goes to ``--out``; the
parent prints a table at the end.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DOWNSTREAM = ("qformer_proj", "qformer", "visual_memory", "report_memory",
              "visual_proj", "query_proj", "dmem_proj", "rmem_proj")


def _downstream(mods: dict, tokens, visual_bank, report_bank):
    """``AMMRG.encode_img`` after the ARM, on the modules ``mods``."""
    import torch

    query = mods["qformer"](mods["qformer_proj"](tokens))
    dmem = mods["visual_memory"](query, visual_bank)
    rmem = mods["report_memory"](query, report_bank)
    return torch.cat([mods["visual_proj"](tokens), mods["query_proj"](query),
                      mods["dmem_proj"](dmem), mods["rmem_proj"](rmem)],
                     dim=1)


def _rel(got, want) -> float:
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def _worst(names, got, want) -> tuple[float, str]:
    return max(((_rel(g, w), n) for n, g, w in zip(names, got, want)),
               default=(0.0, ""))


def child(seed: int, device: str, overrides: list[str]) -> dict:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from medical_image_analysis_tpu_torch.configs.config import load_config
    from medical_image_analysis_tpu_torch.models.mamba import set_scan_backend
    from medical_image_analysis_tpu_torch.models.mrg import _encode_views
    from medical_image_analysis_tpu_torch.train.loop import (
        _device_batch,
        build_data,
        make_task_adapter,
    )

    # chip_smoke.phase_device's settings: no TF32 in products or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="am_probe_") as tmp:
        run = cs.phase_train_am_mrg(None if overrides else cs.VOCAB,
                                    Path(tmp), device, overrides)
    model, state, sets = run["model"], run["state"], run["sets"]
    losses = run["losses"]
    del run
    dev = next(model.parameters()).device
    # the phase's batch, banks and cotangent (phase_train_am_mrg_grads)
    cfg = load_config(str(cs.AM_PRESET), [*sets, "data.num_workers=1"])
    ann, tok, batcher, loader = build_data(cfg)
    banks = make_task_adapter(cfg, ann, tok, loader, dev).side
    train_b = batcher("train")
    try:
        host = next(train_b.batches(shuffle=False))
    finally:
        train_b.close()
    b = _device_batch(host, dev)
    vb, rb = banks["visual_bank"], banks["report_bank"]
    names = [n for n in state.params
             if n.startswith("base/") and not n.startswith("base/llm/")]
    tensors = [state.params[n] for n in names]

    def encode():
        return model.encode_img(b["images"], vb, rb)

    set_scan_backend(model, "plain")
    img = encode().detach().requires_grad_()
    prompt = model._wrap(img, b["before_ids"], b["after_ids"])
    (cot,) = torch.autograd.grad(
        model._loss(prompt, b["target_ids"], b["target_mask"]), img)
    grads, tokens = {}, {}
    for path, backend in (("kernel", "auto"), ("plain", "plain")):
        set_scan_backend(model, backend)
        grads[path] = torch.autograd.grad(encode(), tensors, cot)
        with torch.no_grad():
            tokens[path] = _encode_views(lambda x: model.vision(x, True),
                                         b["images"])
    set_scan_backend(model, "auto")
    rest = [i for i, n in enumerate(names) if not cs.ZERO_GRAD.search(n)]
    check, at = _worst([names[i] for i in rest],
                       [grads["kernel"][i] for i in rest],
                       [grads["plain"][i] for i in rest])
    largest = max(g.abs().max().item() for g in grads["plain"])

    # the downstream modules' gradients as functions of the tokens
    name_of = {id(p): n for n, p in state.params.items()}
    mods = {m: getattr(model, m) for m in DOWNSTREAM}
    down = [(m, p) for m in DOWNSTREAM for p in mods[m].parameters()
            if id(p) in name_of and not cs.ZERO_GRAD.search(name_of[id(p)])]
    dnames = [name_of[id(p)] for _, p in down]

    def down_grads(toks, ms, params, banks_):
        out = _downstream(ms, toks, *banks_)
        return torch.autograd.grad(out, params, cot.to(out.dtype))

    params = [p for _, p in down]
    at_plain = down_grads(tokens["plain"], mods, params, (vb, rb))
    at_kernel = down_grads(tokens["kernel"], mods, params, (vb, rb))
    same = max(_rel(g, w) for g, w in zip(
        at_plain, [grads["plain"][names.index(n)] for n in dnames]))
    diff = tokens["kernel"] - tokens["plain"]
    rms = diff.square().mean().sqrt()
    gen = torch.Generator(dev).manual_seed(0)
    noise = []
    for _ in range(2):
        r = torch.randn(tokens["plain"].shape, device=dev, generator=gen)
        at_noise = down_grads(tokens["plain"] + rms * r, mods, params,
                              (vb, rb))
        noise.append((_worst(dnames, at_noise, at_plain),
                      _rel(at_noise[dnames.index(at)], at_plain[dnames.index(
                          at)]) if at in dnames else None))
    mods64 = {m: copy.deepcopy(mods[m]).double() for m in DOWNSTREAM}
    index = {id(p): i for i, (_, p) in enumerate(down)}
    params64 = [None] * len(down)
    for m in DOWNSTREAM:
        for p, p64 in zip(mods[m].parameters(), mods64[m].parameters()):
            if id(p) in index:
                params64[index[id(p)]] = p64
    at64 = down_grads(tokens["plain"].double(), mods64, params64,
                      (vb.double(), rb.double()))
    fp64 = _worst(dnames, at_plain, at64)
    fp64_kernel = _worst(dnames, at_kernel, at64)

    def at_worst(got, want):
        i = dnames.index(at) if at in dnames else None
        return None if i is None else _rel(got[i], want[i])

    return {
        "hashseed": seed, "losses": losses, "check": check, "at": at,
        "bound": cs.TOWER_RTOL, "largest_grad": largest,
        "at_largest_over_largest": max(
            grads["plain"][names.index(at)].abs().max().item() / largest,
            0.0) if at else None,
        "tokens_gap": (diff.abs().max() / tokens["plain"].abs().max()).item(),
        "tokens_gap_rms": rms.item(),
        "downstream_tensors": len(dnames),
        "downstream_equals_phase": same,
        "kernel": _worst(dnames, at_kernel, at_plain),
        "noise": [n[0] for n in noise], "noise_at_check": [n[1] for n in noise],
        "fp64": fp64, "fp64_kernel": fp64_kernel,
        "fp64_at_check": at_worst(at_plain, at64),
        "fp64_kernel_at_check": at_worst(at_kernel, at64),
    }


def _seeds(spec: str) -> list[int]:
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def _spawn(seed: int, out: Path, child_args: list[str]):
    env = dict(os.environ, PYTHONHASHSEED=str(seed))
    log = open(out.parent / f"am_mrg_probe_{seed}_{time.time_ns()}.log", "w")
    return subprocess.Popen(
        [sys.executable, __file__, "--child", str(seed), "--out", str(out),
         *child_args],
        env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT)), log


def _run_all(seeds: list[int], parallel: int, out: Path,
             child_args: list[str]) -> None:
    pending, running = list(seeds), []
    while pending or running:
        while pending and len(running) < parallel:
            seed = pending.pop(0)
            running.append((seed, *_spawn(seed, out, child_args)))
        time.sleep(1)
        for item in list(running):
            seed, proc, log = item
            if proc.poll() is not None:
                log.close()
                running.remove(item)
                print(f"hashseed {seed}: rc {proc.returncode}", flush=True)


def _read(out: Path) -> list[dict]:
    if not out.exists():
        return []
    with open(out) as f:
        return [json.loads(line) for line in f]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="4-27")
    ap.add_argument("--parallel", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/am_mrg_grads_probe.jsonl")
    ap.add_argument("--child", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[])
    args = ap.parse_args()
    child_args = ["--device", args.device]
    for item in args.set:
        child_args += ["--set", item]
    out = Path(args.out)
    if not out.is_absolute():
        out = ROOT / out
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.child is not None:
        row = child(args.child, args.device, args.set)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
        return
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    if args.device == "cuda":  # once, before the children load them
        cs.phase_build()
    _run_all(_seeds(args.seeds), args.parallel, out, child_args)
    over = sorted({r["hashseed"] for r in _read(out)
                   if r["check"] > r["bound"]})
    if over:  # each failing seed again, in a new process
        _run_all(over, args.parallel, out, child_args)
    for r in _read(out):
        print(f"hashseed={r['hashseed']} check={r['check']:.3e} at={r['at']} "
              f"tokens_gap={r['tokens_gap']:.3e} "
              f"kernel={r['kernel'][0]:.3e} "
              f"noise={','.join(f'{n[0]:.3e}' for n in r['noise'])} "
              f"noise_at_check={r['noise_at_check']} "
              f"fp64={r['fp64'][0]:.3e}@{r['fp64'][1]} "
              f"fp64_at_check={r['fp64_at_check']} "
              f"fp64_kernel_at_check={r['fp64_kernel_at_check']}",
              flush=True)


if __name__ == "__main__":
    main()
