"""The comparison that decides ``correct``: it passes the program at a tiny
size on the CPU, and fails a perturbed output, the planted faults and the
control (the reference one precision lower in the program's place)."""

from __future__ import annotations

import pytest

import calibrate
import correctness
import run
from reference import mae as ref_mae
from reference import r2gengpt as ref_r2g
from reference.train import follow
from traffic import make_batch
from weights import make

CELLS = ["mae_hd_1280.pretrain", "r2gengpt_mimic.lora_b6"]
SEED = 2 ** 31 + 12345
# the cells' limits are set at their real widths; at a tiny width the
# bf16 LLM's rounding is another size, so the tiny R2GenGPT computes its
# LLM in fp32, where the two sides differ by rounding alone
EXACT = {CELLS[0]: {}, CELLS[1]: {"llm_dtype": "float32"}}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell, tiny_cell, spec_without_rooflines):
    tiny_cell(cell, **EXACT[cell])
    res = run.run_cell(cell, SEED, 0.2, False, device="cpu",
                       spec=spec_without_rooflines)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault, tiny_cell,
                                      spec_without_rooflines):
    cfg, _ = tiny_cell(cell, **EXACT[cell])
    res = run.run_cell(cell, SEED, 0.2, False, device="cpu",
                       tamper=calibrate.fault(fault,
                                              cfg["train"]["accum_steps"]),
                       spec=spec_without_rooflines)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell,ref", [(CELLS[0], ref_mae),
                                      (CELLS[1], ref_r2g)])
def test_control_is_not_correct(cell, ref, tiny_cell):
    cfg, wl = tiny_cell(cell, **EXACT[cell])

    def batch(i):
        return make_batch(wl["traffic"], SEED, i, "cpu")

    steps = wl["follow_steps"]
    exact = follow(ref, cfg, make(ref.param_specs(cfg), SEED, "cpu"), batch,
                   steps)
    lower = follow(ref, cfg, make(ref.param_specs(cfg), SEED, "cpu"), batch,
                   steps, precision="lower")
    ok, checks = correctness.judge(correctness.gaps(lower, exact),
                                   wl["limits"])
    assert not ok, checks


def test_r2gengpt_program_equals_reference_in_fp32(tiny_cell,
                                                   spec_without_rooflines):
    """With the LLM built in fp32 the two sides compute the same
    arithmetic: any gap past rounding is a difference of semantics."""
    tiny_cell(CELLS[1], llm_dtype="float32")
    res = run.run_cell(CELLS[1], SEED, 0.1, False, device="cpu",
                       spec=spec_without_rooflines)
    checks = res["checks"]
    assert checks["loss"]["value"] < 1e-6
    assert checks["grad"]["value"] < 1e-5
    assert checks["change"]["value"] < 1e-3


def _readings():
    names = [f"t{i}" for i in range(5)]
    ref = {"loss": [2.0, 1.9, 1.8],
           "grad1": {n: 1.0 + i for i, n in enumerate(names)},
           "grad_norms": [{n: 1.0 + i for i, n in enumerate(names)}] * 3,
           "change": {n: 0.1 * (1 + i) for i, n in enumerate(names)}}
    prog = {"loss": list(ref["loss"]), "grad1": dict(ref["grad1"]),
            "change": dict(ref["change"])}
    return prog, ref


@pytest.mark.parametrize("part", ["loss", "grad1", "change"])
def test_a_perturbed_reading_fails(part):
    prog, ref = _readings()
    limits = {"loss": 1e-3, "grad": 1e-3, "change": 1e-3}
    assert correctness.judge(correctness.gaps(prog, ref), limits)[0]
    if part == "loss":
        prog["loss"][1] *= 1.01
    else:
        prog[part]["t2"] *= 1.01
    ok, _ = correctness.judge(correctness.gaps(prog, ref), limits)
    assert not ok
    prog[part if part != "loss" else "grad1"]["t0"] = float("nan")
    assert not correctness.judge(correctness.gaps(prog, ref), limits)[0]


def test_a_tensor_nought_to_rounding_is_left_out_of_the_change():
    prog, ref = _readings()
    for step in ref["grad_norms"]:
        step["t0"] = 1e-6
    prog["change"]["t0"] = 10.0  # moved by round-off alone
    numbers = correctness.gaps(prog, ref)
    assert numbers["change"] == 0.0
    assert "t0" not in correctness.moved(ref)
