"""The harness finds what a later change adds as files, keeps JAX and the
JAX package out of a run, refuses a run without a card, and gives the
same batches and weights for a seed."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import harness
import run
from conftest import BENCH, tiny_mae
from traffic import make_batch
from weights import make


def test_cell_config_and_metric_added_as_files(tmp_path, monkeypatch):
    """A copy of the benchmark's folder with a new configuration, cell,
    FLOP count and per-layer metric, each only a new file and a new entry
    of the specification, runs with the new metric reported."""
    here = tmp_path / "benchmark"
    shutil.copytree(BENCH, here, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    cfg, wl = tiny_mae()
    cfg["name"] = "mae_tiny"
    wl.update(name="mae_tiny.small", config="mae_tiny")
    (here / "configs" / "mae_tiny.json").write_text(json.dumps(cfg))
    (here / "workloads" / "mae_tiny.small.json").write_text(json.dumps(wl))
    shutil.copy(here / "flops" / "mae_hd_1280.py",
                here / "flops" / "mae_tiny.py")
    (here / "metrics" / "steps_seen.train.py").write_text(
        "def read(ctx):\n    return float(ctx['trace']['steps'])\n")
    spec = harness.benchmark_spec()
    spec["configs"].append({"name": "mae_tiny", "source": "test",
                            "file": "benchmark/configs/mae_tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "mae_tiny.small", "config": "mae_tiny",
                              "traffic": "small", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("train_images_per_s", "mfu.images"):
            m["workloads"].append("mae_tiny.small")
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if not m["name"].startswith("roofline_pct.")]
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                              "better": "higher", "source": "device_trace",
                              "layer": "test",
                              "moves": "train_images_per_s",
                              "workloads": ["mae_tiny.small"]})
    monkeypatch.setattr(harness, "HERE", here)
    res = run.run_cell("mae_tiny.small", 7, 0.1, True, device="cpu",
                       spec=spec)
    assert res["metrics"]["steps_seen.train"]["value"] == \
        wl["trace_steps"]
    assert res["metrics"]["mfu.images"]["value"] > 0
    assert res["correct"]
    e2e = run.run_cell("mae_tiny.small", 7, 0.1, False, device="cpu",
                       spec=spec)["metrics"]
    assert set(e2e) == {"train_images_per_s", "peak_mem_gib", "setup_s"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".", 1)[0]
            assert top not in (harness.PROGRAM, *harness.FORBIDDEN), \
                (path.name, name)


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".", 1)[0] not in harness.FORBIDDEN, \
                (path, name)


@pytest.mark.parametrize("cell", ["mae_hd_1280.pretrain",
                                  "r2gengpt_mimic.lora_b6"])
def test_a_cpu_run_loads_neither_jax_nor_the_jax_package(cell):
    code = f"""
import sys
sys.path.insert(0, {str(BENCH)!r}); sys.path.insert(1, {str(BENCH.parent)!r})
sys.path.insert(2, {str(BENCH / 'tests')!r})
import harness, run
from conftest import TINY
cfg, wl = TINY[{cell!r}]()
real = harness.load_json
harness.load_json = lambda k, n: wl if k == "workloads" else (
    cfg if k == "configs" else real(k, n))
spec = harness.benchmark_spec()
spec["per_layer"] = [m for m in spec["per_layer"]
                     if not m["name"].startswith("roofline_pct.")]
res = run.run_cell({cell!r}, 11, 0.1, True, device="cpu", spec=spec)
print("FOUND", harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def test_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(["medical_image_analysis_tpu_torch.ops",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["medical_image_analysis_tpu.models",
                                      "jax.numpy"]) == [
        "jax", "medical_image_analysis_tpu"]


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is here: the run would measure")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "mae_hd_1280.pretrain", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env=env, cwd=BENCH.parent)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_same_seed_same_batches_and_weights():
    cfg, wl = tiny_mae()
    from reference import mae as ref

    seed = 2 ** 31 + 99
    a = make_batch(wl["traffic"], seed, 3, "cpu")
    b = make_batch(wl["traffic"], seed, 3, "cpu")
    c = make_batch(wl["traffic"], seed, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["images"], c["images"])
    wa = make(ref.param_specs(cfg), seed, "cpu")
    wb = make(ref.param_specs(cfg), seed, "cpu")
    assert all(torch.equal(wa[k], wb[k]) for k in wa)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mae_hd_1280.pretrain",
                                  "r2gengpt_mimic.lora_b6"])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = run.run_cell(cell, 2 ** 31 + 5, 1.0, True)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0


def test_idle_share_and_gaps_from_a_trace():
    """The idle share is the steps' seconds covered by no device work (the
    union of overlapping events); a gap is named by the innermost host
    operation at its middle, or after the last one that had ended."""
    import profile_trace

    device = [("void k<float>(int)", 0.0, 300.0, "kernel"),
              ("k2", 100.0, 350.0, "kernel"),  # overlaps: 0 to 450 busy
              ("Memcpy HtoD", 600.0, 100.0, "gpu_memcpy")]
    assert profile_trace.busy_us(device) == 550.0
    idle = harness.load_module("metrics", "device_idle_pct.images")
    assert idle.read({"trace": {"seconds": 1e-3, "device": device}}) == \
        pytest.approx(45.0)
    assert idle.read({"trace": {"seconds": 1e-3, "device": []}}) is None
    labelled = {"t0": 0.0, "t1": 1000.0, "device": device,
                "host": [("aten::outer", 350.0, 300.0),
                         ("aten::inner", 450.0, 100.0),
                         ("aten::done", 700.0, 50.0)]}
    gaps = dict(profile_trace.idle_gaps(labelled))
    assert gaps == {"aten::inner": pytest.approx(150e-6),
                    "after aten::done": pytest.approx(300e-6)}
    assert profile_trace.device_ops(device)[0] == ["k2", 350e-6]
