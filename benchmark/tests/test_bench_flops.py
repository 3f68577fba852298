"""The model FLOPs and the frozen work counts against hand counts, and the
roofline's arithmetic."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import harness
from conftest import tiny_mae, tiny_r2gengpt
from harness import BenchError
from reference import mae as ref_mae
from reference import r2gengpt as ref_r2g
from reference.common import Products
from traffic import make_batch
from weights import make

VIT = harness.load_module("metrics", "roofline_pct.vit_block")
MAMBA = harness.load_module("metrics", "roofline_pct.mamba_fused")


def _cell(config, cell):
    return (harness.load_json("configs", config),
            harness.load_json("workloads", cell))


def test_mae_step_is_1_98e12_at_the_real_shape():
    cfg, wl = _cell("mae_hd_1280", "mae_hd_1280.pretrain")
    parts = harness.load_module("flops", "mae_hd_1280").step_parts(cfg, wl)
    total = sum(f for _, f, _ in parts)
    # 16 images of 400 patches of 64 x 64 x 1; the encoder 12 layers over
    # 1 + 86 tokens of 768, the decoder 8 over 1 + 400 of 512
    enc = 12 * (2 * 16 * 87 * 768 * (4 * 768 + 2 * 3072)
                + 4 * 16 * 87 * 87 * 768)
    dec = 8 * (2 * 16 * 401 * 512 * (4 * 512 + 2 * 2048)
               + 4 * 16 * 401 * 401 * 512)
    patch = 2 * 16 * 400 * 4096 * 768
    fwd = enc + dec + patch + 2 * 16 * 87 * 768 * 512 \
        + 2 * 16 * 401 * 512 * 4096
    assert total == 3 * fwd - patch
    assert abs(total - 1.98e12) / 1.98e12 < 0.01
    assert {p for _, _, p in parts} == {"fp32"}


@pytest.mark.parametrize("patches,keeps", [(400, 86), (6400, 1400)])
def test_mae_region_masking_keeps(patches, keeps):
    f = harness.load_module("flops", "mae_hd_1280")
    assert f.kept(patches, 0.75, 0.85) == keeps
    noise = torch.rand(2, patches,
                       generator=torch.Generator().manual_seed(0))
    keep, mask, _ = ref_mae.region_ids(noise, 0.75, 0.85)
    assert keep.shape == (2, keeps)
    assert int(mask.sum()) == 2 * (patches - keeps)


def test_mae_forward_products_match_the_reference_at_a_small_shape():
    cfg, wl = tiny_mae()
    f = harness.load_module("flops", "mae_hd_1280")
    fwd = dict((n, v) for n, v, _ in f.step_parts(cfg, wl))["forward"]
    w = make(ref_mae.param_specs(cfg), 3, "cpu")
    batch = make_batch(wl["traffic"], 3, 0, "cpu")
    keep, mask, restore = ref_mae.region_ids(batch["mask_noise"], 0.75, 0.85)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        for i in range(wl["traffic"]["batch"]):
            ref_mae._image_loss(cfg, Products(), w, batch["images"][i:i + 1],
                                keep[i:i + 1], mask[i:i + 1],
                                restore[i:i + 1])
    assert counter.get_total_flops() == fwd


def test_r2gengpt_forward_products_match_the_reference_at_a_small_shape():
    cfg, wl = tiny_r2gengpt(llm_dtype="float32")
    cfg["model"]["lora"]["targets"] = []  # the merged kernel: no adapter
    cfg["train"]["accum_steps"] = 1
    f = harness.load_module("flops", "r2gengpt_mimic").forward_parts(cfg, wl)
    w = make(ref_r2g.param_specs(cfg), 4, "cpu")
    batch = make_batch(wl["traffic"], 4, 0, "cpu")
    counter = FlopCounterMode(display=False)
    P = Products()
    with torch.no_grad(), counter:
        img = ref_r2g.tower(P, w, cfg, batch["images"])
        ref_r2g.llm_loss_sum(P, w, cfg, img, batch,
                             slice(0, wl["traffic"]["batch"]))
    products = f["patch"] + f["tower"] + f["projector"] + f["llm"] + f["head"]
    assert counter.get_total_flops() == products


def test_r2gengpt_real_step_parts():
    cfg, wl = _cell("r2gengpt_mimic", "r2gengpt_mimic.lora_b6")
    flops = harness.load_module("flops", "r2gengpt_mimic")
    parts = dict((n, (v, p)) for n, v, p in flops.step_parts(cfg, wl))
    # 6 studies of 16 + 197 + 2 + 100 tokens through 24 layers
    per_tok = 2 * (4 * 2048 ** 2 + 3 * 2048 * 5504) + 4 * 315 * 2048
    lora = 2 * 2 * 2 * 2048 * 16
    assert parts["llm"][0] == 2 * 24 * 6 * 315 * (per_tok + lora) \
        + 24 * 6 * 315 * lora
    assert parts["llm"][1] == "bf16"
    assert parts["head"][0] == 2 * 2 * 6 * 100 * 2048 * 151936
    calls = flops.mamba_fused_calls(cfg, wl)
    assert [(k, n) for k, n, _ in calls] == [("xdbl", 48), ("scan", 48),
                                             ("scan_bwd", 24)]
    # micro-batches of 3 studies, 6 images
    assert calls[0][2] == dict(b=6, k=4, l=197, d=768, n=16, rank=48,
                               taps=4)


def test_vit_work_by_hand():
    # one row pair, width 4, one head: qkv 2*2*4*12, out 2*2*4*4, scores
    # and p.v 2 * 2*2*2*4; softmax 4 per score
    assert VIT.work("attn_fwd", 1, 2, 4, 1, 16) == (2 * 2 * 4 * 16 + 64, 16)
    assert VIT.work("mlp_fwd", 1, 2, 4, 1, 16) == (4 * 2 * 4 * 16, 10 * 32)
    # decoder's real shape: 16 x 401 rows of 512
    prod, other = VIT.work("attn_bwd", 16, 401, 512, 16, 2048)
    rows = 16 * 401
    assert prod == 2 * rows * 512 * 11 * 512 + 12 * 16 * 401 ** 2 * 512
    assert other == 7 * 16 * 16 * 401 ** 2
    assert VIT.nbytes("attn_fwd", 1, 2, 4, 1, 16) == 4 * (16 + 4 * 16 + 24)


def test_mamba_work_by_hand():
    shape = dict(b=32, k=4, l=197, d=768, n=16, rank=48, taps=4)
    elems = 32 * 4 * 197 * 768
    assert MAMBA.work("xdbl", **shape) == (2.0 * elems * 80, 13.0 * elems)
    assert MAMBA.work("scan", **shape) == (0.0, elems * 227)
    assert MAMBA.work("scan_bwd", **shape) == (0.0,
                                               elems * (454 + 96 + 160))
    tiny = dict(b=1, k=1, l=1, d=1, n=1, rank=1, taps=1)
    # xr, xc; conv 2; x_proj 3; x_dbl 3
    assert MAMBA.nbytes("xdbl", **tiny) == 4 * (2 + 2 + 3 + 3)


def _ctx(counted, kernel_us):
    cfg, wl = _cell("mae_hd_1280", "mae_hd_1280.pretrain")
    trace = {"steps": 2, "counters": counted, "seconds": 1.0,
             "device": [("void gemm_tc_kernel<float>(TcGemmArgs<float>)",
                         0.0, kernel_us, "kernel"),
                        ("other_kernel", 0.0, 1e9, "kernel")]}
    return {"trace": trace, "config": cfg, "workload": wl,
            "peaks": harness.peaks(),
            "flops": harness.load_module("flops", "mae_hd_1280")}


def test_roofline_reads_the_family_and_checks_launches():
    right = {"vit_attn_fwd": 40, "vit_mlp_fwd": 40, "vit_attn_bwd": 40,
             "vit_mlp_bwd": 40}
    low = VIT.read(_ctx(right, 1e12))
    assert 0 < low < 1e-3
    assert VIT.read(_ctx(right, 2e4)) > 1.0
    with pytest.raises(BenchError):
        VIT.read(_ctx(dict(right, vit_mlp_bwd=39), 1e6))
