"""The profiler's traces of the traced steps, reduced to what the per-layer
metrics read.

The traced steps run under ``torch.profiler`` with the device's activity
alone (no host operations recorded, so the profiler adds next to nothing
to the host's time a launch): :func:`device_events` gives their kernels,
copies and sets. One step more runs under host and device tracing inside
a ``bench.window`` span, only to name the device's idle gaps by what the
host was doing (:func:`read`). Each trace is written as Chrome JSON to a
temporary file, read back and deleted. Times are microseconds of the
trace's clock.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def export(prof) -> dict:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def _complete(chrome: dict) -> list[dict]:
    return [e for e in chrome.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e]


def device_events(chrome: dict) -> list[tuple]:
    """Every kernel, copy and set of the trace: (name, ts, dur, cat)."""
    return [(e["name"], float(e["ts"]), float(e["dur"]), e["cat"])
            for e in _complete(chrome) if e.get("cat") in DEVICE_CATS]


def read(chrome: dict) -> dict:
    """The ``bench.window`` span's bounds, and the device's work and the
    host's operations inside it."""
    events = _complete(chrome)
    spans = [e for e in events if e["name"] == WINDOW
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise RuntimeError(f"trace: {len(spans)} '{WINDOW}' spans")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])

    def inside(e):
        return float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0

    device = [(e["name"], float(e["ts"]), float(e["dur"]), e["cat"])
              for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
    host = [(e["name"], float(e["ts"]), float(e["dur"]))
            for e in events if e.get("cat") in HOST_CATS and inside(e)
            and e["name"] != WINDOW]
    return {"t0": t0, "t1": t1, "device": device, "host": host}


def busy_intervals(device, t0=-np.inf, t1=np.inf) -> list[tuple]:
    """The union of the device's work (``(name, ts, dur, cat)``), cut to
    [t0, t1] and merged."""
    iv = sorted((max(ts, t0), min(ts + dur, t1)) for _, ts, dur, _ in device)
    out: list[list[float]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out if b > a]


def busy_us(device) -> float:
    return sum(b - a for a, b in busy_intervals(device))


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymous
    parts, template arguments and parameters (``void (anonymous
    namespace)::gemm_tc_kernel<float>(...)`` -> ``gemm_tc_kernel``)."""
    name = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    base = "".join(out)
    if "(" in base and not base.startswith(("Memcpy", "Memset")):
        base = base[:base.index("(")]
    words = base.split()
    if words and words[0] == "void":
        words = words[1:]
    return " ".join(words) if words else name


def device_ops(device, top: int = 10) -> list[list]:
    """The device operations that took most time: [name, seconds], summed
    by :func:`short_name`."""
    by_op: dict[str, float] = {}
    for name, _, dur, _ in device:
        key = short_name(name)
        by_op[key] = by_op.get(key, 0.0) + dur * 1e-6
    return [[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])
            [:top]]


def idle_gaps(tr: dict, top: int = 10, labelled: int = 400) -> list[list]:
    """The idle time between the device's operations inside the span of
    :func:`read` by what the host was doing: the ``labelled`` longest
    gaps, each named by the innermost host operation running at its
    middle (or, where the host ran Python between operations, ``after``
    the last one that had ended), summed by that name: [name, seconds]."""
    busy = busy_intervals(tr["device"], tr["t0"], tr["t1"])
    edges = [tr["t0"]] + [x for iv in busy for x in iv] + [tr["t1"]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:labelled]
    host = tr["host"]
    starts = np.array([h[1] for h in host]) if host else np.zeros(0)
    ends = starts + np.array([h[2] for h in host]) if host else starts
    durs = ends - starts
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if len(hit):
            name = host[hit[np.argmin(durs[hit])]][0]
        else:  # the host ran Python between operations
            done = np.nonzero(ends < mid)[0]
            name = ("after " + host[done[np.argmax(ends[done])]][0]
                    if len(done) else "(before any host operation)")
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])
            [:top]]


def breakdown(tr: dict) -> dict:
    """The traced steps' device operations that took most time, and the
    labelled step's idle gaps by what the host was doing."""
    return {"device_ops": device_ops(tr["device"]),
            "idle_gaps": idle_gaps(tr["labelled"])}
