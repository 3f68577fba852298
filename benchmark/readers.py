"""The training step's per-layer readers, which several metrics share: a
metric's file under ``metrics/`` names one of them as its ``read`` (each
metric is named after the end-to-end rate it moves, and so exists once a
rate: ``mfu.images`` and ``mfu.studies`` read alike)."""

from __future__ import annotations

import profile_trace


def mfu(ctx):
    """The window's share of the chip's peak for the model's work, in %:
    the least time of each step's model FLOPs (``flops/<config>.py:
    step_parts``, each part over the published peak of the precision it
    computes in) times the window's whole steps, over the window's
    seconds."""
    w = ctx["window"]
    if not w["steps"]:
        return None
    peaks = ctx["peaks"]["ops_s"]
    parts = ctx["flops"].step_parts(ctx["config"], ctx["workload"])
    least = sum(flops / peaks[precision] for _, flops, precision in parts)
    return 100.0 * w["steps"] * least / w["seconds"]


def launches_per_step(ctx):
    """Kernels that ran on the device in the traced steps (the trace's
    kernel events, one a launch), over those steps."""
    tr = ctx["trace"]
    if not tr["steps"] or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["steps"]


def device_idle_pct(ctx):
    """The share of the traced steps' time, in %, in which no kernel, copy
    or set ran on the device: the union of their intervals in the trace,
    which records the device's activity alone, over the steps' seconds on
    the host's clock."""
    tr = ctx["trace"]
    if tr["seconds"] <= 0 or not tr["device"]:
        return None
    return 100.0 * (1.0 - profile_trace.busy_us(tr["device"]) * 1e-6
                    / tr["seconds"])
