"""Readings that a cell's limits are set from, and its faults.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--faults half_batch,unchanged]

For each seed: the program's first steps against the reference's (the
lower reading of each number is the largest over the seeds); on the
control seeds, the reference computed one precision below the
configuration's in the program's place (the upper reading is the
smallest); and each fault planted in the program. Prints one JSON line a
reading; the benchmark's runs never run this. The faults:

- ``unchanged``: the step returns its state unchanged (no update);
- ``half_batch``: the first half (rounded down) of each micro-batch
  kept, the loss the mean over it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

# One intra-op thread, as torchrun sets it for each process unless told
# otherwise (the step's work is on the card).
os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

import correctness  # noqa: E402
import harness  # noqa: E402
from reference.train import follow  # noqa: E402
from weights import make  # noqa: E402


def fault(kind: str, accum: int):
    """A function that plants the fault ``kind`` in a built program."""
    def unchanged(program):
        program.state.tx.step = lambda grads, norm=None: 0.0

    def half_batch(program):
        from medical_image_analysis_tpu_torch.train.train_state import \
            make_train_step

        loss_fn = program.loss_fn

        def half(batch):
            return loss_fn({k: v[: v.shape[0] // 2] for k, v in batch.items()})

        program.step = make_train_step(half, accum)

    return {"unchanged": unchanged, "half_batch": half_batch}[kind]


def readings(cell: str, seed: int, control: bool, faults, device="cuda",
             emit=print) -> None:
    driver = harness.load_module("drivers", "train_step")
    wl = harness.load_json("workloads", cell)
    cfg = harness.load_json("configs", wl["config"])
    family, ref, specs, batch = driver.prepare(wl, cfg, seed, device)
    steps = wl["follow_steps"]
    sides = {}
    for kind in ("program", *faults):
        t0 = time.perf_counter()
        program = family.build(cfg, make(specs, seed, device), device)
        if kind != "program":
            fault(kind, cfg["train"]["accum_steps"])(program)
        sides[kind] = driver.follow_program(program, batch, steps)
        sides[kind]["seconds"] = time.perf_counter() - t0
        del program
        driver.free(device)
    t0 = time.perf_counter()
    exact = follow(ref, cfg, make(specs, seed, device), batch, steps)
    exact_s = time.perf_counter() - t0
    if control:
        t0 = time.perf_counter()
        sides["control"] = follow(ref, cfg, make(specs, seed, device), batch,
                                  steps, precision="lower")
        sides["control"]["seconds"] = time.perf_counter() - t0
    for kind, side in sides.items():
        emit(json.dumps({"cell": cell, "seed": seed, "kind": kind,
                         "gaps": correctness.gaps(side, exact),
                         "seconds": side["seconds"],
                         "reference_s": exact_s,
                         "loss": side["loss"], "ref_loss": exact["loss"]}),
             flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    faults = [f for f in args.faults.split(",") if f]
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds + sorted(control - set(seeds)):
        readings(args.workload, seed, seed in control,
                 faults if seed in control else (), "cuda")
    harness.check_imports("after the readings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
