"""What every part of the benchmark shares: where its files are, how they
are found by name, seeds, the import guard, and the table of peaks.

Nothing here imports the program. A configuration, a cell, a driver, a
family and a per-layer metric are each a file under this folder, found by
the name that ``BENCHMARK.json`` or a cell's file gives it
(:func:`load_json`, :func:`load_module`), so a later change adds one by
adding files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

# Top-level module names that no run may hold (compared whole: the port's
# name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "medical_image_analysis_tpu")
PROGRAM = "medical_image_analysis_tpu_torch"


class BenchError(RuntimeError):
    """A run that cannot give a result: it prints none and exits non-zero."""


@dataclasses.dataclass
class Program:
    """What a family builds of the program: its ``TrainState``, the step
    object the window drives and the loss it is made of, the program's
    ``launches`` counters by kernel family, and the program's tensor names
    mapped to the reference's."""

    state: object
    step: object
    loss_fn: object
    counters: dict
    names: dict


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def check_imports(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise BenchError(f"import guard ({when}): loaded {found}")


def load_json(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1]} named {name!r} ({path})")
    key = f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[key]
        raise
    return module


def benchmark_spec() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def peaks() -> dict:
    with open(HERE / "peaks.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it, and those that list no cells."""
    return [m for m in spec[section]
            if cell in m.get("workloads", [cell])]


def derive(seed: int, *tags) -> int:
    """A 63-bit key from the run's seed and the tags (ints or strings)."""
    words = [int(seed) % (1 << 64)]
    for t in tags:
        words.append(t if isinstance(t, int) else
                     int.from_bytes(str(t).encode()[:32].ljust(8, b"\0"),
                                    "little"))
    return int(np.random.SeedSequence(words).generate_state(
        2, np.uint64)[0]) & ((1 << 63) - 1)


def process_start() -> float:
    """The ``time.time()`` at which this process started (Linux ``/proc``;
    else the time of this module's import)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])  # starttime, clock ticks after boot
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _IMPORTED


_IMPORTED = time.time()

