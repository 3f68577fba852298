"""Tiny versions of the benchmark's cells, for the CPU tests.

Each keeps the cell's file and its configuration's, with the widths,
depths, sizes and batch cut until a run takes a second on the CPU (the
port's kernels run their plain versions there). The tests put the
benchmark's folder and the repository on ``sys.path`` as ``run.py`` does.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

import harness  # noqa: E402


def tiny_mae():
    cfg = copy.deepcopy(harness.load_json("configs", "mae_hd_1280"))
    wl = copy.deepcopy(harness.load_json("workloads", "mae_hd_1280.pretrain"))
    cfg["model"].update(image_size=64, patch_size=16, embed_dim=32, depth=2,
                        num_heads=2, decoder_embed_dim=16, decoder_depth=1,
                        decoder_num_heads=2)
    cfg["train"]["batch_size"] = 4
    wl["traffic"].update(batch=4, images={"size": 64, "channels": 1},
                         mask_noise={"patch": 16})
    return cfg, wl


def tiny_r2gengpt(llm_dtype="bfloat16"):
    cfg = copy.deepcopy(harness.load_json("configs", "r2gengpt_mimic"))
    wl = copy.deepcopy(harness.load_json("workloads",
                                         "r2gengpt_mimic.lora_b6"))
    m = cfg["model"]
    m["image_size"] = 32
    m["tower"].update(patch_size=8, embed_dim=16, depth=2, d_state=4)
    m["llm"].update(hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=4, vocab_size=2000, dtype=llm_dtype)
    m["lora"]["rank"] = 2
    tr = wl["traffic"]
    tr["batch"] = 4
    tr["images"]["size"] = 32
    tr["prompt"].update(vocab=2000, bos_id=1)
    tr["report"].update(max_len=16, median=8, min=2, vocab=2000)
    return cfg, wl


TINY = {"mae_hd_1280.pretrain": tiny_mae,
        "r2gengpt_mimic.lora_b6": tiny_r2gengpt}


@pytest.fixture
def tiny_cell(monkeypatch):
    """``use(cell)`` makes ``harness.load_json`` hand out the tiny version
    of ``cell`` and its configuration; returns (cfg, wl)."""

    def use(cell, **kw):
        cfg, wl = TINY[cell](**kw)
        real = harness.load_json

        def load(kind, name):
            if kind == "workloads" and name == cell:
                return wl
            if kind == "configs" and name == wl["config"]:
                return cfg
            return real(kind, name)

        monkeypatch.setattr(harness, "load_json", load)
        return cfg, wl

    return use


@pytest.fixture
def spec_without_rooflines():
    """``BENCHMARK.json`` without the roofline metrics, which read kernel
    launches that the CPU's plain versions do not make."""
    spec = harness.benchmark_spec()
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if not m["name"].startswith("roofline_pct.")]
    return spec
