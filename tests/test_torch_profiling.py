"""``utils/profiling.py``, ``--throughput`` and ``train.debug_nans`` in the
port, on CPU.

(a) ``check_finite`` raises ``FloatingPointError`` on a NaN or an infinity
    and names the tensor; ``check_nan`` and ``enable_debug_nans`` raise on a
    NaN only, as JAX's ``jax_debug_nans``, naming the tensor or the
    innermost module whose output holds it; the hooks come off again.
(b) ``train.debug_nans`` through ``cli.train`` (a tiny ``r2gengpt`` run
    with its validation, so greedy decoding runs under the hooks): a NaN
    put into one weight raises, naming the module, and so does a NaN that
    only the validation's forward makes; without it the losses and the
    validation scores equal a run without the flag's, exactly.
(c) ``--throughput`` prints the JAX function's keys and builds its tower
    family (``vit`` an ARM, as the JAX function does); ``throughput``,
    ``trace``, ``device_memory_stats`` on the CPU.
(d) ``flops_of`` counts a product as ``FlopCounterMode`` does, and raises
    where one of the port's kernels launched during the call.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from medical_image_analysis_tpu.cli import throughput as jax_throughput
from medical_image_analysis_tpu.configs.config import (
    make_config as jax_make_config,
)
from medical_image_analysis_tpu.models import mamba as jax_mamba
from medical_image_analysis_tpu.models import swin as jax_swin
from medical_image_analysis_tpu.models import vmamba as jax_vmamba
from medical_image_analysis_tpu_torch.cli import throughput
from medical_image_analysis_tpu_torch.cli import train as cli_train
from medical_image_analysis_tpu_torch.configs.config import make_config
from medical_image_analysis_tpu_torch.models.mamba import ARM
from medical_image_analysis_tpu_torch.models.swin import SwinTransformer
from medical_image_analysis_tpu_torch.models.vmamba import VSSM
from medical_image_analysis_tpu_torch.ops import attention
from medical_image_analysis_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# (a) the checks
# --------------------------------------------------------------------------


def test_check_finite_names_the_tensor():
    profiling.check_finite("x", torch.ones(3))
    profiling.check_finite("ids", torch.tensor([1, 2]))  # not floating
    with pytest.raises(FloatingPointError, match=r"non-finite value in y"):
        profiling.check_finite("y", torch.tensor([1.0, float("inf")]))
    with pytest.raises(FloatingPointError, match=r"out\[1\]\['b'\]"):
        profiling.check_finite("out", (torch.ones(1), {"b": torch.tensor(
            [float("nan")])}))


def test_check_nan_passes_an_infinity():
    profiling.check_nan("y", torch.tensor([1.0, float("inf")]))
    with pytest.raises(FloatingPointError, match=r"NaN in out\[0\]"):
        profiling.check_nan("out", [torch.tensor([float("nan")])])


def test_enable_debug_nans_names_the_innermost_module():
    model = nn.Sequential(nn.Linear(4, 6), nn.Sequential(nn.ReLU(),
                                                         nn.Linear(6, 3)))
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(0))
    want = model(x)
    remove = profiling.enable_debug_nans(model)
    assert torch.equal(model(x), want)  # the hooks change nothing
    with torch.no_grad():
        model[1][1].bias[0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"module 1\.1 output"):
        model(x)
    with torch.no_grad():
        model[1][1].bias[0] = float("inf")
    model(x)  # an infinity alone passes, as under JAX's flag
    remove()
    with torch.no_grad():
        model[1][1].bias[0] = float("nan")
    assert torch.isnan(model(x)).any()  # no hook left


# --------------------------------------------------------------------------
# (b) train.debug_nans in fit_mrg
# --------------------------------------------------------------------------

TINY = ["data.dataset=synthetic", "data.input_size=32", "data.batch_size=8",
        "data.max_len=12", "data.vocab_min_freq=1", "data.num_workers=1",
        "model.vision=arm",
        "model.vision_kwargs={patch_size: 8, embed_dim: 16, depth: 1, "
        "d_state: 4}",
        "model.llm_kwargs={dim: 32, n_layers: 1, n_heads: 4, n_kv_heads: 4, "
        "hidden_dim: 64}",
        "train.lora_llm=true", "train.lora_rank=2", "train.epochs=1",
        "train.val_every_epochs=2", "train.log_every=100"]


VALIDATED = ("train.val_every_epochs=1", "generate.max_new_tokens=4",
             "generate.min_new_tokens=1")


def _run(save_dir, *sets, on_start=None):
    argv = ["--device", "cpu"]
    for item in (*TINY, f"train.save_dir={save_dir}", *sets):
        argv += ["--set", item]
    cli_train.main(argv, on_start=on_start)
    with open(save_dir / "log.txt") as f:
        records = [json.loads(line) for line in f]
    return ([r["loss"] for r in records if "step" in r],
            [{k: v for k, v in r.items() if k != "val_s"}
             for r in records if "val_score" in r])


def test_debug_nans_in_fit_mrg(tmp_path):
    plain = _run(tmp_path / "plain", *VALIDATED)
    losses, vals = plain
    assert len(losses) == 4 and np.all(np.isfinite(losses)) and len(vals) == 1
    assert _run(tmp_path / "flag", *VALIDATED, "train.debug_nans=true") == plain

    def poison(model, _state):
        with torch.no_grad():
            model.vision.arm.norm_f.weight[0] = float("nan")

    with pytest.raises(FloatingPointError,
                       match=r"module vision\.arm\.norm_f output"):
        _run(tmp_path / "nan", "train.debug_nans=true", on_start=poison)

    def poison_validation(model, _state):  # NaN only without a gradient
        model.vision.arm.norm_f.register_forward_hook(
            lambda _m, _i, out: out if torch.is_grad_enabled()
            else torch.full_like(out, float("nan")))

    with pytest.raises(FloatingPointError,
                       match=r"module vision\.arm\.norm_f output"):
        _run(tmp_path / "val", *VALIDATED, "train.debug_nans=true",
             on_start=poison_validation)
    with open(tmp_path / "val" / "log.txt") as f:  # all 4 steps ran first
        assert sum("step" in json.loads(line) for line in f) == 4


# --------------------------------------------------------------------------
# (c) --throughput and the timers
# --------------------------------------------------------------------------

TOWERS = {
    "swin": ("{embed_dim: 8, depths: [1, 1], num_heads: [2, 2], "
             "window_size: 4}", SwinTransformer),
    "vssm": ("{depths: [1, 1, 1, 1], dims: [8, 16, 32, 64], d_state: 1}",
             VSSM),
    "arm": ("{patch_size: 8, embed_dim: 16, depth: 1, d_state: 4}", ARM),
    # the JAX function's fault, copied: vit builds an ARM
    "vit": ("{patch_size: 8, embed_dim: 16, depth: 1, d_state: 4}", ARM),
}


@pytest.mark.parametrize("vision", list(TOWERS))
def test_throughput_cli(vision, capsys, monkeypatch):
    kwargs, family = TOWERS[vision]
    sets = [f"model.vision={vision}", "model.vision_size=tiny"
            if vision in ("swin", "vssm") else "model.vision_size=base",
            f"model.vision_kwargs={kwargs}", "data.batch_size=2",
            "data.input_size=32"]
    cfg = make_config({}, sets)
    tower = throughput.build_tower(cfg, torch.device("cpu"))
    assert type(tower) is family
    assert all(p.dtype == torch.bfloat16 for p in tower.parameters())
    argv = ["--device", "cpu", "--throughput"]
    for item in sets:
        argv += ["--set", item]
    out = cli_train.main(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert (out["vision"], out["batch"], out["input"]) == (vision, 2, 32)
    assert out["ms_per_iter"] > 0 and out["items_per_sec"] > 0
    # the JAX function on the same config, its towers and timer stubbed:
    # the tower class it builds and the keys it returns
    built = []

    def spy(name):
        class Spy:
            def __init__(self, **_):
                built.append(name)

            def init(self, _key, _x):
                return {"w": jnp.zeros(())}

        return Spy

    for module, name in ((jax_swin, "SwinTransformer"), (jax_vmamba, "VSSM"),
                         (jax_mamba, "ARM")):
        monkeypatch.setattr(module, name, spy(name))
    monkeypatch.setattr(jax_throughput, "throughput", lambda *a, **k: {
        "ms_per_iter": 1.0, "items_per_sec": 2.0})
    want = jax_throughput.run_throughput(jax_make_config({}, sets))
    assert built == [family.__name__]
    assert list(want) == list(out)


def test_timers_on_cpu(tmp_path):
    lin = nn.Linear(8, 4)
    x = torch.randn(3, 8)
    stats = profiling.throughput(lin, (x,), batch_size=3, iters=2, warmup=1)
    assert set(stats) == {"ms_per_iter", "items_per_sec"}
    with profiling.trace(str(tmp_path)):
        lin(x)
    assert json.loads((tmp_path / "trace.json").read_text())
    assert profiling.device_memory_stats() == ({} if not
                                               torch.cuda.is_available()
                                               else torch.cuda.memory_stats())


# --------------------------------------------------------------------------
# (d) flops_of
# --------------------------------------------------------------------------


def test_flops_of_counts_products_and_refuses_kernels():
    lin = nn.Linear(8, 4, bias=False)
    x = torch.randn(3, 8)
    assert profiling.flops_of(lin, x) == 2 * 3 * 8 * 4

    def through_a_kernel(t):
        attention.launches["fused_attention"] += 1  # as a CUDA launch does
        return lin(t)

    try:
        with pytest.raises(ValueError, match="fused_attention"):
            profiling.flops_of(through_a_kernel, x)
    finally:
        attention.launches["fused_attention"] -= 1


def test_scan_n1_x_dbl_stays_fp32_under_autocast():
    """``--throughput`` runs the towers under bf16 autocast; the d_state=1
    scan's kernel takes an fp32 ``x_dbl`` (its products summed in fp32)."""
    from medical_image_analysis_tpu_torch.ops.scan_n1 import _x_dbl

    gen = torch.Generator().manual_seed(0)
    xr, xc = (torch.randn(2, 5, 8, generator=gen).bfloat16()
              for _ in range(2))
    w = torch.randn(4, 3, 8, generator=gen)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = _x_dbl(xr, xc, w)
    assert got.dtype == torch.float32
    assert torch.equal(got, _x_dbl(xr, xc, w))
