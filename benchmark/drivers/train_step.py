"""The training-step driver: set-up, the timed window, the traced steps and
the comparison with the reference.

Set-up makes the weights on the device from the seed, builds the program
through its own build functions (the cell's family, ``families/<family>.py``)
and drives its one step object through the first ``follow_steps`` steps,
each on its own batch: that is the warm-up (the kernels build and every
shape runs) and the program's side of the comparison (each step's loss,
the first gradient read off AdamW's first moment, every tensor's change).
The window then drives the same object, one step after another, each
ended by reading its loss back, and closes at the end of the first step
that ends after ``seconds``. Its rate is the samples of all whole steps
over the whole window. With ``trace``, ``trace_steps`` more steps run
under the profiler with the device's activity alone (the per-layer
metrics read them), and one more under host and device tracing, which
only names the device's idle gaps by what the host was doing. Every fp32
product runs in fp32: TF32 is off in both the program and the reference.
Once the program's state is freed, the reference
follows the first steps from the same weights and batches
(``reference/train.py``) and ``correctness.py`` judges the two.
"""

from __future__ import annotations

import gc
import importlib
import math
import sys
import time
import traceback

import torch

import correctness
import profile_trace as bench_trace
from harness import load_module
from reference.train import follow
from traffic import make_batch
from weights import make


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().float()))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _counters(program) -> dict:
    return {k: v for c in program.counters.values() for k, v in c.items()}


def prepare(wl: dict, cfg: dict, seed: int, device):
    """(family, reference module, weight specs, batch function)."""
    family = load_module("families", cfg["family"])
    ref = importlib.import_module(f"reference.{family.REFERENCE}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def batch(i):
        return make_batch(wl["traffic"], seed, i, device)

    return family, ref, ref.param_specs(cfg), batch


def follow_program(program, batch, steps: int) -> dict:
    """Drive the program's step object through the first ``steps`` steps
    and read them: each loss, the first gradient off AdamW's first moment,
    each tensor's change."""
    state, step, names = program.state, program.step, program.names
    start = {n: p.detach().clone() for n, p in state.params.items()}
    prog = {"loss": [], "grad1": {}, "change": {}}
    for i in range(steps):
        out = step(state, batch(i))
        prog["loss"].append(float(out["loss"]))
        if i == 0:
            prog["grad1"] = {names[n]: _norm(m) / (1.0 - state.tx.b1)
                             for n, m in state.tx.mu.items()}
    prog["change"] = {names[n]: _norm(p - start[n])
                      for n, p in state.params.items()}
    return prog


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell: str, wl: dict, cfg: dict, seed: int, seconds: float,
        trace: bool, device, started: float, tamper=None) -> dict:
    """One run of a training cell; ``started`` is the process's start
    (``time.time()``), ``tamper(program)`` a test's fault planted in the
    program after it is built."""
    device = torch.device(device)
    family, ref, specs, batch = prepare(wl, cfg, seed, device)
    traffic = wl["traffic"]
    n_follow = wl["follow_steps"]
    program = family.build(cfg, make(specs, seed, device), device)
    if tamper is not None:
        tamper(program)
    prog = follow_program(program, batch, n_follow)
    state, step = program.state, program.step
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - started

    attempted = failed = 0
    index = n_follow
    step_s = []

    def one_step():
        nonlocal attempted, failed, index
        attempted += 1
        t = time.perf_counter()
        try:
            loss = float(step(state, batch(index))["loss"])
            ok = math.isfinite(loss)
        except Exception:  # a failed step counts; the run goes on
            traceback.print_exc(file=sys.stderr)
            ok = False
        failed += not ok
        index += 1
        step_s.append(time.perf_counter() - t)

    t0 = time.perf_counter()
    while True:
        one_step()
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    done = attempted - failed
    print(f"window: {attempted} steps in {window_s:.3f} s, a step "
          f"{min(step_s):.4f} / {sorted(step_s)[len(step_s) // 2]:.4f} / "
          f"{max(step_s):.4f} s (least / median / most)", file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    traced = None
    if trace:
        cpu, cuda = (torch.profiler.ProfilerActivity.CPU,
                     torch.profiler.ProfilerActivity.CUDA)
        before = _counters(program)
        tfail = failed
        with torch.profiler.profile(
                activities=[cuda] if device.type == "cuda" else [cpu]) as prof:
            t = time.perf_counter()
            for _ in range(wl["trace_steps"]):
                one_step()
            _sync(device)
            traced_s = time.perf_counter() - t
        after = _counters(program)
        events = bench_trace.device_events(bench_trace.export(prof))
        traced = {"seconds": traced_s, "device": events,
                  "kernels": sum(1 for e in events if e[3] == "kernel"),
                  "steps": wl["trace_steps"] - (failed - tfail),
                  "counters": {k: after[k] - before[k] for k in after}}
        acts = [cpu] + ([cuda] if device.type == "cuda" else [])
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(bench_trace.WINDOW):
                one_step()
                _sync(device)
        traced["labelled"] = bench_trace.read(bench_trace.export(prof))
        del prof

    del state, step, program
    free(device)

    t_ref = time.perf_counter()
    reference = follow(ref, cfg, make(specs, seed, device), batch, n_follow)
    ref_s = time.perf_counter() - t_ref
    numbers = correctness.gaps(prog, reference)
    ok, checks = correctness.judge(numbers, wl["limits"])
    return {"correct": ok, "attempted": attempted, "failed": failed,
            "peak_bytes": peak, "checks": checks, "reference_s": ref_s,
            # the end-to-end metrics this driver measures, by name
            "end_to_end": {wl["rate"]: done * traffic["batch"] / window_s,
                           "peak_mem_gib": peak / 2**30,
                           "setup_s": setup_s},
            # what the per-layer readers read besides the cell's files
            "context": {"window": {"steps": done, "seconds": window_s},
                        "trace": traced}}
