"""``BENCHMARK.json`` against the benchmark's contract, and the files it
names."""

from __future__ import annotations

import json
import re

import pytest

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj",
               "head", "expand")


@pytest.fixture(scope="module")
def spec():
    return harness.benchmark_spec()


def test_top_level_keys_and_size(spec):
    assert set(spec) == TOP
    assert len((harness.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51
    assert isinstance(spec["run_seconds"], int)


def test_command_and_paths(spec):
    assert 1 <= len(spec["command"]) <= 32
    for word in spec["command"]:
        assert TEXT.match(word)
        assert not word.startswith("/") and ".." not in word.split("/")
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.REPO / p).is_dir()
        assert not p.endswith("_torch")
    assert spec["command"][1].startswith(spec["paths"][0] + "/")


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units_use_allowed_characters(spec, section):
    names = [e["name"] for e in spec[section]]
    assert len(names) == len(set(names))
    for e in spec[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and key != "source":
                assert TEXT.match(e[key]), e[key]


def test_entries_have_only_the_contract_keys(spec):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, allowed in keys.items():
        for e in spec[section]:
            assert set(e) - {"workloads"} == allowed, e["name"]


def test_configs_files_and_reductions(spec):
    used = {w["config"] for w in spec["workloads"]}
    files = set()
    for c in spec["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(spec["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(harness.REPO / c["file"]) as f:
            data = json.load(f)
        assert data["name"] == c["name"]
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTH_WORDS), key
        assert (harness.HERE / "flops" / f"{c['name']}.py").is_file()
        assert (harness.HERE / "families" / f"{data['family']}.py").is_file()


def test_cells_exist_as_files(spec):
    pairs = set()
    n4 = 0
    for w in spec["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
        n4 += w["chips"] == 4
        assert TEXT.match(w["why"])
        cell = harness.load_json("workloads", w["name"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert (harness.HERE / "drivers" / f"{cell['driver']}.py").is_file()
        assert set(cell["limits"]) == {"loss", "grad", "change"}
    assert n4 <= max(1, len(spec["workloads"]) // 4)


def test_end_to_end_bounds(spec):
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_metric_cell_exists(spec):
    cells = {w["name"] for w in spec["workloads"]}
    for section in ("end_to_end", "per_layer"):
        for m in spec[section]:
            assert set(m.get("workloads", [])) <= cells, m["name"]


def test_per_layer_moves_a_metric_each_of_its_cells_reports(spec):
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", [w["name"] for w in spec["workloads"]]):
            reported = {e["name"] for e in harness.cell_metrics(
                spec, cell, "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)


def test_every_cell_reports_enough(spec):
    for w in spec["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(spec, w["name"],
                                                       "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(spec, w["name"], "per_layer")


def test_layers_are_named_alike(spec):
    for m in spec["per_layer"]:
        assert TEXT.match(m["layer"])
    layers = {m["layer"] for m in spec["per_layer"]}
    lowered = {lay.lower() for lay in layers}
    assert len(lowered) == len(layers)
