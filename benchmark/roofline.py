"""A kernel family's share of its roofline, from the traced steps.

The numerator is the least time of the family's calls: for each call the
largest of its products over the peak of their precision, its other
operations over the CUDA cores' fp32 peak, and its inputs read once and
outputs written once over the memory's bandwidth. The calls are the
configuration's (``flops/<config>.py``), each counted by the program's
``launches``: a count that differs from what the configuration implies
is a failure, and no number is given. The denominator is the summed
device time of the family's kernels in the trace, matched by name.
"""

from __future__ import annotations

import profile_trace
from harness import BenchError


def share(ctx, calls, counter, kernels, work, nbytes, precision="fp32"):
    """``calls``: (kind, calls a step, shape); ``counter``: kind -> the
    name of its ``launches`` counter; ``work(kind, **shape)`` ->
    (products, other); ``nbytes(kind, **shape)`` -> bytes."""
    tr = ctx["trace"]
    if not calls or not tr["steps"]:
        return None
    peaks = ctx["peaks"]
    ops = peaks["ops_s"]
    expected: dict[str, int] = {}
    least = 0.0
    for kind, per_step, shape in calls:
        n = per_step * tr["steps"]
        expected[counter[kind]] = expected.get(counter[kind], 0) + n
        products, other = work(kind, **shape)
        least += n * max(products / ops[precision],
                         other / ops["fp32_cuda_core"],
                         nbytes(kind, **shape) / peaks["hbm_bytes_s"])
    for name, n in expected.items():
        got = tr["counters"].get(name)
        if got != n:
            raise BenchError(f"roofline: {got} {name} calls in the traced "
                             f"steps, the configuration implies {n}")
    device_us = sum(dur for name, _, dur, cat in tr["device"]
                    if cat == "kernel"
                    and profile_trace.short_name(name) in kernels)
    if device_us <= 0:
        return None
    return 100.0 * least / (device_us * 1e-6)
