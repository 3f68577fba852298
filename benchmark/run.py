"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``benchmark/workloads/<cell>.json``; it names its
configuration (``benchmark/configs/<config>.json``) and its driver
(``benchmark/drivers/<driver>.py``). With ``--trace 0`` the result's
metrics are the cell's end-to-end metrics in ``BENCHMARK.json``; with
``--trace 1`` its per-layer metrics, each read by
``benchmark/metrics/<name>.py``. The last line of standard output is the
result (JSON); the numbers that decided ``correct`` are the last lines of
standard error and the result's last key. A run without a CUDA device,
with fewer devices than the cell asks for, or with the JAX package or JAX
loaded, prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

# One intra-op thread, as torchrun sets it for each process unless told
# otherwise (the step's work is on the card).
os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

import harness  # noqa: E402

STARTED = harness.process_start()


def end_to_end(spec: dict, cell: str, values: dict) -> dict:
    """The cell's end-to-end metrics, from the values its driver
    measured."""
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in harness.cell_metrics(spec, cell, "end_to_end")}


def per_layer(spec: dict, cell: str, ctx: dict) -> dict:
    out = {}
    for m in harness.cell_metrics(spec, cell, "per_layer"):
        value = harness.load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device="cuda", tamper=None, spec=None) -> dict:
    """The result of one run (the dict that is printed), on ``device``."""
    import torch

    spec = spec or harness.benchmark_spec()
    wl = harness.load_json("workloads", cell)
    cfg = harness.load_json("configs", wl["config"])
    driver = harness.load_module("drivers", wl["driver"])
    res = driver.run(cell, wl, cfg, seed, seconds, trace, device, STARTED,
                     tamper=tamper)
    harness.check_imports("after the window")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    result = {"correct": res["correct"], "attempted": res["attempted"],
              "failed": res["failed"]}
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": wl["chips"], "memory_peak_bytes": res["peak_bytes"]}
    if trace:
        import profile_trace

        tr = res["context"]["trace"]
        ctx = {"cell": cell, "workload": wl, "config": cfg,
               "peaks": harness.peaks(), **res["context"],
               "flops": harness.load_module("flops", wl["config"])}
        result["metrics"] = per_layer(spec, cell, ctx)
        device_info["busy_s"] = profile_trace.busy_us(tr["device"]) * 1e-6
        device_info["window_s"] = tr["seconds"]
        result["device"] = device_info
        result["breakdown"] = profile_trace.breakdown(tr)
    else:
        result["metrics"] = end_to_end(spec, cell, res["end_to_end"])
        result["device"] = device_info
    result["checks"] = res["checks"]  # last: the numbers that decided
    result["_reference_s"] = res["reference_s"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        harness.check_imports("at start")
        import torch

        wl = harness.load_json("workloads", args.workload)
        if not torch.cuda.is_available():
            raise harness.BenchError("no CUDA device")
        if torch.cuda.device_count() < wl["chips"]:
            raise harness.BenchError(
                f"{torch.cuda.device_count()} CUDA devices; the cell asks "
                f"for {wl['chips']}")
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except harness.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    ref_s = result.pop("_reference_s")
    print(f"reference followed the first steps in {ref_s:.1f} s",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
