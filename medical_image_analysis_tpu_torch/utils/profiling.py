"""Profiling and numerical-debug utilities.

Counterpart of ``medical_image_analysis_tpu/utils/profiling.py`` in
PyTorch's idiom:

- :func:`enable_debug_nans` (``train.debug_nans``): forward hooks on every
  module that raise ``FloatingPointError`` at the first module whose output
  holds a NaN, naming it; the training step then checks the loss and every
  gradient (:func:`check_nan`). As JAX's ``jax_debug_nans``, an infinity
  alone does not raise. The JAX flag makes XLA check every operation; the
  hooks check every module, the innermost first.
- :func:`check_finite`: raises on a NaN or an infinity, as the JAX one.
- :func:`trace`: a Chrome trace through ``torch.profiler``.
- :func:`throughput`: timed calls, with CUDA events on the card.
- :func:`device_memory_stats`: ``torch.cuda.memory_stats``.
- :func:`flops_of`: ``torch.utils.flop_counter.FlopCounterMode``, which
  counts aten operations only. The port's kernels are ctypes calls that it
  would count as 0, so :func:`flops_of` raises where one of them launched
  during the call: count such a model on the CPU, where every wrapper runs
  its plain PyTorch version.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
import torch.nn as nn


def _raise_where(name: str, x, bad, what: str) -> None:
    """Raise ``FloatingPointError`` naming ``name`` where ``bad`` of the
    floating tensor ``x`` (or of one in a tuple, list or dict of them) is
    true. Waits for the device."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point() and bool(bad(x).any()):
            raise FloatingPointError(f"{what} in {name}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            _raise_where(f"{name}[{i}]", v, bad, what)
    elif isinstance(x, dict):
        for k, v in x.items():
            _raise_where(f"{name}[{k!r}]", v, bad, what)


def check_finite(name: str, x) -> None:
    """Raise ``FloatingPointError`` naming ``name`` where ``x`` (a tensor,
    or a tuple, list or dict of them) holds a NaN or an infinity."""
    _raise_where(name, x, lambda t: ~torch.isfinite(t), "non-finite value")


def check_nan(name: str, x) -> None:
    """Raise ``FloatingPointError`` naming ``name`` where ``x`` holds a NaN
    (``train.debug_nans``; an infinity passes, as under JAX's flag)."""
    _raise_where(name, x, torch.isnan, "NaN")


def enable_debug_nans(model: nn.Module) -> Callable[[], None]:
    """Check the output of every module of ``model`` after its forward
    (:func:`check_nan`, named ``module <qualified name> output``; the root
    is ``model``). Returns a function that removes the hooks. The
    checks wait for the device after every module; they change no value."""

    def hook(name):
        def check(_module, _inputs, output):
            check_nan(f"module {name} output", output)
        return check

    handles = [m.register_forward_hook(hook(name or "model"))
               for name, m in model.named_modules()]

    def remove() -> None:
        for h in handles:
            h.remove()

    return remove


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host, and the card where there is one) and write
    ``<log_dir>/trace.json``, a Chrome trace (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def throughput(fn, args, batch_size: int, iters: int = 30,
               warmup: int = 3) -> dict:
    """``fn(*args)`` called ``warmup`` times, then timed over ``iters``
    calls: CUDA events where the first tensor of ``args`` is on the card
    (the device's time from the first call queued to the last finished),
    else the host's clock. Returns ``{"ms_per_iter", "items_per_sec"}``."""
    device = _device_of(args)
    with torch.no_grad():
        for _ in range(warmup):
            fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            ms = (time.perf_counter() - t0) * 1e3 / iters
    return {"ms_per_iter": ms, "items_per_sec": batch_size / (ms / 1e3)}


def device_memory_stats(device=None) -> dict:
    """``torch.cuda.memory_stats`` of ``device`` (peak and current bytes
    allocated and reserved, ...); an empty dict without a card."""
    if not torch.cuda.is_available():
        return {}
    return torch.cuda.memory_stats(device)


def kernel_modules() -> tuple:
    """The port's modules that hold a hand-written kernel, each with its
    ``KERNEL_SOURCE``, ``build()``, ``launches`` and ``reset_launches()``."""
    from ..ops import (attention, mamba_fused, scan_n1,
                       selective_scan_pallas, swin_block, vit_block)

    return (mamba_fused, scan_n1, vit_block, swin_block,
            selective_scan_pallas, attention)


def kernel_launches() -> dict[str, int]:
    """The launch counts of the port's hand-written kernels, by name."""
    return {k: v for m in kernel_modules() for k, v in m.launches.items()}


def reset_kernel_launches() -> None:
    """Every kernel's launch count to 0."""
    for m in kernel_modules():
        m.reset_launches()


def flops_of(fn, *args) -> float:
    """Floating-point operations of ``fn(*args)`` counted by
    ``FlopCounterMode`` (matrix products and convolutions, a multiply-add
    two). Raises ``ValueError`` where one of the port's kernels launched
    during the call: the counter cannot see inside them, and a count
    without them would be short."""
    from torch.utils.flop_counter import FlopCounterMode

    before = kernel_launches()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args)
    launched = {k: v - before[k] for k, v in kernel_launches().items()
                if v != before[k]}
    if launched:
        raise ValueError(
            f"flops_of: the port's kernels launched {launched}; "
            "FlopCounterMode counts them as 0. Count on the CPU, where "
            "each wrapper runs its plain version.")
    return float(counter.get_total_flops())
