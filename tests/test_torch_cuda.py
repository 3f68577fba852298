"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Without a card every test here skips. On a machine with one (JAX is not
needed there, so ``tests/conftest.py`` is left out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances, relative to max(1, max |plain|): x_dbl is fp32 from identical
inputs, so only the order of the sum over D differs (1e-4). y from fp32
sources likewise (1e-4); from bf16 sources both sides compute in fp32 and
round to bf16, where they may land one bf16 step apart: 2^-7 of the
largest value.
The backward's outputs are fp32 on both sides from the same inputs, for
either source dtype: the sums over D and over L run in another order, so
1e-4. Gradients of a layer or a tower through the kernels against the
plain versions, fp32: 1e-4 relative to the largest plain gradient. The
d_state=1 scan's kernels are held to the same bounds: y from fp32
sources 1e-4; from bf16 sources, where both sides round each direction to
bf16 and add the pair in bf16, one bf16 step; its backward's outputs
1e-4.
"""

import re

import numpy as np
import pytest
import torch

from medical_image_analysis_tpu_torch.models import vit
from medical_image_analysis_tpu_torch.models.common import init_params, set_fused
from medical_image_analysis_tpu_torch.models.mamba import ARM, set_scan_backend
from medical_image_analysis_tpu_torch.models.vmamba import SS2D, build_vssm
from medical_image_analysis_tpu_torch.ops import attention as att
from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
from medical_image_analysis_tpu_torch.ops import scan_n1 as sn
from medical_image_analysis_tpu_torch.ops import selective_scan_pallas as ssp

Y_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7}
BWD_RTOL = 1e-4
GRAD_RTOL = 1e-4
BWD_OUTPUTS = ("du", "u", "dsilu", "dxdbl", "dA", "dD", "ddt_bias",
               "ddt_proj_w")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _inputs(dev, dtype, k_dirs, b, l, d, n, r, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.5):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    xr = t(b, l, d).to(dtype)
    xc = t(b, l, d).to(dtype) if k_dirs == 4 else None
    w = dict(conv_w=t(k_dirs, 4, d), conv_b=t(k_dirs, d),
             x_proj_w=t(k_dirs, r + 2 * n, d), dt_proj_w=t(k_dirs, d, r),
             dt_bias=t(k_dirs, d), A=-torch.exp(t(k_dirs, d, n, scale=0.3)),
             D=t(k_dirs, d))
    return xr, xc, w


def _err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err, max(1.0, want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("k_dirs,b,l,d,n,r,use_conv", [
    (1, 2, 10, 8, 4, 4, True),
    (2, 2, 10, 8, 4, 4, True),
    (4, 2, 10, 8, 4, 4, True),
    (4, 2, 10, 8, 4, 4, False),
    (4, 2, 197, 768, 16, 48, True),  # an ARM-B layer
    (4, 2, 3136, 192, 16, 6, False),  # vssm_tiny stage 0 at a small batch
    (2, 3, 197, 70, 16, 8, True),  # a ragged last chunk; D not a multiple
    # vssm_tiny stage 3's shape on each side of fwd_chunk's threshold: the
    # single pass from B=1 on, chunks with 2 directions at B=1
    # (tests/test_torch_work.py)
    (4, 1, 49, 1536, 16, 48, False),
    (2, 1, 49, 1536, 16, 48, False),
    # fwd_chunk cuts these into chunks: ARM-B serving one image, a ragged
    # one at B=1, and N=4 with a ragged last chunk
    (4, 1, 197, 768, 16, 48, True),
    (2, 1, 197, 70, 16, 8, True),
    (2, 3, 70, 40, 4, 3, True),
    # AR pretraining's one direction at full width (8 clusters of 16)
    (1, 2, 128, 768, 16, 48, True),
    # the Mamba LM's (mamba_lm_sft: d_model 768, expand 2) training step
    # and its validation of 8
    (1, 16, 128, 1536, 16, 48, True),
    (1, 8, 128, 1536, 16, 48, True),
], ids=["k1", "k2", "k4", "k4-noconv", "arm-b", "vssm-tiny-s0", "ragged",
        "s3-single", "s3-chunks", "arm-b-b1", "ragged-b1", "n4-chunks",
        "k1-full", "lm-sft", "lm-sft-val"])
def test_kernels_match_plain(cuda, dtype, k_dirs, b, l, d, n, r, use_conv):
    xr, xc, w = _inputs(cuda, dtype, k_dirs, b, l, d, n, r, seed=k_dirs + l)
    xargs = (xr, xc, w["conv_w"], w["conv_b"], w["x_proj_w"], use_conv)
    before = dict(mf.launches)
    want_x = mf.xdbl_plain(*xargs)
    got_x = mf.xdbl_fwd(*xargs)
    # the scan gets the plain x_dbl, so each kernel is held alone
    sargs = (xr, xc, want_x, w["conv_w"], w["conv_b"], w["dt_proj_w"],
             w["dt_bias"], w["A"], w["D"], True, use_conv)
    want_y = mf.scan_plain(*sargs)
    got_y = mf.scan_fwd(*sargs)
    torch.cuda.synchronize()
    assert mf.launches["mamba_xdbl"] == before["mamba_xdbl"] + 1
    assert mf.launches["mamba_scan"] == before["mamba_scan"] + 1
    assert got_y.dtype == dtype and got_y.shape == (b, k_dirs, l, d)
    err, scale = _err(got_x, want_x)
    assert err <= 1e-4 * scale
    err, scale = _err(got_y, want_y)
    assert err <= Y_RTOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("k_dirs,b,l,d,n,r,use_conv", [
    (1, 2, 10, 8, 4, 4, True),
    (2, 2, 10, 8, 4, 4, True),
    (4, 2, 10, 8, 4, 4, True),
    (4, 2, 10, 8, 4, 4, False),
    (4, 2, 197, 768, 16, 48, True),  # an ARM-B layer
    (4, 2, 3136, 192, 16, 6, False),  # vssm_tiny stage 0 at a small batch
    (2, 3, 197, 70, 16, 8, True),  # a ragged last chunk; D not a multiple
    (1, 2, 128, 768, 16, 48, True),  # AR pretraining's one direction
    (1, 16, 128, 1536, 16, 48, True),  # the Mamba LM's training step
], ids=["k1", "k2", "k4", "k4-noconv", "arm-b", "vssm-tiny-s0", "ragged",
        "k1-full", "lm-sft"])
def test_scan_bwd_matches_plain(cuda, dtype, k_dirs, b, l, d, n, r,
                                use_conv):
    xr, xc, w = _inputs(cuda, dtype, k_dirs, b, l, d, n, r, seed=k_dirs + l)
    x_dbl = mf.xdbl_plain(xr, xc, w["conv_w"], w["conv_b"], w["x_proj_w"],
                          use_conv)
    dy = torch.randn(b, k_dirs, l, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(l))
    args = (xr, xc, x_dbl, w["conv_w"], w["conv_b"], w["dt_proj_w"],
            w["dt_bias"], w["A"], w["D"], dy.to(dtype), True, use_conv)
    before = mf.launches["mamba_scan_bwd"]
    want = mf.scan_bwd_plain(*args)
    got = mf.scan_bwd(*args)
    torch.cuda.synchronize()
    assert mf.launches["mamba_scan_bwd"] == before + 1
    for name, g, wv in zip(BWD_OUTPUTS, got, want):
        assert g.shape == wv.shape and g.dtype == torch.float32, name
        err, scale = _err(g, wv)
        assert err <= BWD_RTOL * scale, (name, err, scale)


def _grads(module, loss_fn):
    module.zero_grad(set_to_none=True)
    loss_fn().backward()
    return {k: p.grad.detach().clone() for k, p in module.named_parameters()
            if p.grad is not None}


def _assert_grads_close(got, want):
    assert got.keys() == want.keys()
    for name in want:
        err = (got[name] - want[name]).abs().max().item()
        scale = want[name].abs().max().item()
        assert err <= GRAD_RTOL * max(scale, 1e-30), (name, err, scale)


@pytest.mark.cuda
def test_mixer_grads_through_kernels_match_plain(cuda):
    """Every mixer parameter gets its gradient through the kernels, equal
    to the plain path's (the kernel path once returned y without a
    grad_fn, and only the z half of in_proj and out_proj got one)."""
    gen = torch.Generator(cuda).manual_seed(1)
    arm = ARM(patch_size=16, embed_dim=64, depth=1, img_size=64,
              device=cuda)
    init_params(arm, gen)
    mixer = arm.layers[0].mixer
    x = torch.randn(2, 17, 64, device=cuda, generator=gen)
    w = torch.randn(2, 17, 64, device=cuda, generator=gen)

    def loss():
        return (mixer(x, 8) * w).sum()

    got = _grads(mixer, loss)
    set_scan_backend(mixer, "plain")
    want = _grads(mixer, loss)
    assert set(want) == {name for name, _ in mixer.named_parameters()}
    _assert_grads_close(got, want)


@pytest.mark.cuda
def test_tiny_arm_remat_grads_match_plain(cuda):
    """ARM(remat=True): each layer runs both forward kernels twice (the
    checkpointed forward and its recompute) and the backward once."""
    gen = torch.Generator(cuda).manual_seed(2)
    arm = ARM(patch_size=16, embed_dim=64, depth=3, img_size=64,
              remat=True, device=cuda)
    init_params(arm, gen)
    x = torch.randn(2, 64, 64, 3, device=cuda, generator=gen)
    w = torch.randn(2, 17, 64, device=cuda, generator=gen)

    def loss():
        return (arm(x) * w).sum()

    mf.reset_launches()
    got = _grads(arm, loss)
    torch.cuda.synchronize()
    assert mf.launches == {"mamba_xdbl": 6, "mamba_scan": 6,
                           "mamba_scan_bwd": 3}
    set_scan_backend(arm, "plain")
    want = _grads(arm, loss)
    assert mf.launches["mamba_scan_bwd"] == 3
    _assert_grads_close(got, want)


@pytest.mark.cuda
def test_tiny_arm_through_kernels_matches_plain(cuda):
    """Every layer launches both kernels; the tower agrees with the plain
    versions in fp32 within reordered-sum error."""
    gen = torch.Generator(cuda).manual_seed(0)
    arm = ARM(patch_size=16, embed_dim=64, depth=3, img_size=64,
              device=cuda).eval()
    init_params(arm, gen)
    x = torch.randn(2, 64, 64, 3, device=cuda, generator=gen)
    mf.reset_launches()
    with torch.no_grad():
        got = arm(x)
        torch.cuda.synchronize()
        assert mf.launches == {"mamba_xdbl": 3, "mamba_scan": 3,
                               "mamba_scan_bwd": 0}
        set_scan_backend(arm, "plain")
        want = arm(x)
    assert mf.launches == {"mamba_xdbl": 3, "mamba_scan": 3,
                           "mamba_scan_bwd": 0}
    err, scale = _err(got, want)
    assert err <= 1e-4 * scale


@pytest.mark.cuda
def test_fit_ar_launches_the_fused_kernels(cuda, tmp_path):
    """``fit_ar`` on the card (a tiny ``VisionMambaAR``, one scan direction,
    no remat, no validation) launches each of the fused layer's three
    kernels once a layer a step, and its losses are finite."""
    from medical_image_analysis_tpu_torch.configs.config import make_config
    from medical_image_analysis_tpu_torch.train import loop

    cfg = make_config({
        "data": {"dataset": "synthetic", "batch_size": 8, "input_size": 32,
                 "num_views": 1, "num_workers": 2},
        "model": {"task": "ar", "vision_kwargs": dict(
            patch_size=4, embed_dim=64, depth=3, d_state=16,
            dec_embed_dim=32, dec_heads=2)},
        "train": {"epochs": 1, "lr": 1e-3, "warmup_steps": 1,
                  "log_every": 100, "save_dir": str(tmp_path)},
    })
    mf.reset_launches()
    out = loop.fit(cfg, "cuda")
    steps = 32 // 8  # the synthetic train split
    assert mf.launches == dict.fromkeys(mf.launches, 3 * steps)
    assert np.isfinite(out["loss"])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [3, 12], ids=["chunks", "single"])
def test_scan_fwd_is_deterministic(cuda, b):
    """No float atomics: two calls give the same bits, in chunks (with the
    summaries and carries: 48 blocks a chunk) and in one pass (192)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (mf.fwd_chunk(b, 4, 300, 100, sms) < 300) == (b == 3)
    xr, xc, w = _inputs(cuda, torch.float32, 4, b, 300, 100, 16, 8, seed=7)
    x_dbl = mf.xdbl_plain(xr, xc, w["conv_w"], w["conv_b"], w["x_proj_w"])
    args = (xr, xc, x_dbl, w["conv_w"], w["conv_b"], w["dt_proj_w"],
            w["dt_bias"], w["A"], w["D"], True, True)
    assert torch.equal(mf.scan_fwd(*args), mf.scan_fwd(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rank", [6, 48], ids=["vssm-tiny-s0", "arm-b"])
def test_scan_fwd_occupancy(cuda, dtype, rank):
    """At N=16 and vssm_tiny stage 0's rank (6) and ARM-B's (48) the scan
    kernel keeps at least ``_FWD_BLOCKS`` blocks of 64 threads resident on
    an SM (its register cap), the summaries kernel at least as many, and
    the scan takes at most 28 KB of shared memory a block (two buffers of
    16 rows)."""
    occupancy = mf.fwd_occupancy(16, rank, dtype)
    assert set(occupancy) == set(mf.FWD_KERNELS)
    blocks, smem = occupancy["mamba_scan_kernel"]
    assert blocks >= mf._FWD_BLOCKS and smem <= 28 * 1024, (blocks, smem)
    assert occupancy["mamba_scan_sums_kernel"][0] >= mf._FWD_BLOCKS, occupancy


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    xr, xc, w = _inputs(cuda, torch.float32, 4, 2, 10, 8, 4, 4, seed=0)
    with pytest.raises(TypeError, match="not f32/bf16"):
        mf.xdbl_fwd(xr.half(), xc.half(), w["conv_w"], w["conv_b"],
                    w["x_proj_w"])
    with pytest.raises(ValueError, match="contiguous"):
        mf.xdbl_fwd(xr.transpose(0, 1).contiguous().transpose(0, 1), xc,
                    w["conv_w"], w["conv_b"], w["x_proj_w"])
    with pytest.raises(ValueError, match="xc is required"):
        mf.xdbl_fwd(xr, None, w["conv_w"], w["conv_b"], w["x_proj_w"])
    with pytest.raises(ValueError, match="fp32 tensor"):
        mf.xdbl_fwd(xr, xc, w["conv_w"].cpu(), w["conv_b"], w["x_proj_w"])
    with pytest.raises(ValueError, match="taps=5"):
        mf.xdbl_fwd(xr, xc, torch.zeros(4, 5, 8, device=cuda), w["conv_b"],
                    w["x_proj_w"])


# (K, B, L, D, C, conv): ARM-B serving one image, vssm_tiny stage 3's and
# stage 2's widths (10 and 7 n8 tiles a warp with both directions a block),
# D and C ragged (D = 70 takes the kernel's plain loads, not 16-byte
# copies), C past a block's columns at 128 rows and at any tile (more
# blocks along z), 7 n8 tiles a warp with one direction a block (C = 100),
# one and two directions, a tile shorter than L's last, and AR
# pretraining's one direction at full width.
XDBL_SHAPES = [(4, 1, 197, 768, 80, True), (4, 2, 49, 1536, 80, False),
               (4, 2, 196, 768, 56, False),
               (2, 3, 70, 70, 11, True), (2, 2, 130, 40, 44, False),
               (1, 2, 10, 8, 12, True), (4, 1, 300, 64, 38, False),
               (4, 1, 30, 64, 190, True), (2, 2, 70, 64, 100, True),
               (1, 2, 128, 768, 80, True)]
XDBL_IDS = ["arm-b-b1", "s3-like", "s2-like", "ragged", "two-col-blocks",
            "k1", "s0-like", "wide-c", "one-dir-7-tiles", "k1-full"]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(64, 2, 1), (64, 1, 1), (128, 2, 1),
                                  (128, 1, 1), (64, 1, 3), (128, 2, 2)],
                         ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("k_dirs,b,l,d,c,use_conv", XDBL_SHAPES,
                         ids=XDBL_IDS)
def test_xdbl_matches_plain_at_every_tile(cuda, monkeypatch, tile, dtype,
                                          k_dirs, b, l, d, c, use_conv):
    """The tensor-core x_dbl at every (rows, directions a block) that
    ``xdbl_tile`` can pick, forced, and with D in 2 or 3 ranges (their
    partials summed by the second kernel; ranges past D's last slice
    empty), against ``xdbl_plain`` within 1e-4 of max(1, max |plain|)
    (3xTF32 keeps about 21 bits of each operand; the sums over D run in
    another order)."""
    rows, dirs, _ = tile
    if dirs > k_dirs:
        pytest.skip("one direction: one direction a block only")
    monkeypatch.setattr(mf, "xdbl_tile", lambda *a, **kw: tile)
    n = min(16, (c - 1) // 2)  # C = R + 2N with R >= 1
    xr, xc, w = _inputs(cuda, dtype, k_dirs, b, l, d, n, c - 2 * n,
                        seed=l + c)
    xargs = (xr, xc, w["conv_w"], w["conv_b"], w["x_proj_w"], use_conv)
    got = mf.xdbl_fwd(*xargs)
    want = mf.xdbl_plain(*xargs)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b * k_dirs, l, c)
    err, scale = _err(got, want)
    assert err <= 1e-4 * scale, (err, scale)


@pytest.mark.cuda
def test_xdbl_is_deterministic(cuda):
    """No atomics: two calls give the same bits (vssm_tiny stage 0's
    widths, 128-row tiles of both directions; ARM-B at one image, its
    ranges of D summed in a fixed order)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert mf.xdbl_tile(8, 4, 3136, 192, 38, sms) == (128, 2, 1)
    xr, xc, w = _inputs(cuda, torch.float32, 4, 8, 3136, 192, 16, 6, seed=9)
    xargs = (xr, xc, w["conv_w"], w["conv_b"], w["x_proj_w"], False)
    assert torch.equal(mf.xdbl_fwd(*xargs), mf.xdbl_fwd(*xargs))
    assert mf.xdbl_tile(1, 4, 197, 768, 80, sms)[2] > 1
    xr, xc, w = _inputs(cuda, torch.float32, 4, 1, 197, 768, 16, 48, seed=8)
    xargs = (xr, xc, w["conv_w"], w["conv_b"], w["x_proj_w"], True)
    assert torch.equal(mf.xdbl_fwd(*xargs), mf.xdbl_fwd(*xargs))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,dirs,dtype,use_conv,c", [
    (128, 2, torch.float32, False, 38),  # vssm_tiny stage 0
    (64, 2, torch.float32, False, 44),   # stage 1
    (64, 2, torch.float32, False, 80),   # stage 3
    (64, 1, torch.float32, True, 80),    # ARM-B at one image
    (64, 1, torch.bfloat16, True, 80),
    (128, 1, torch.float32, True, 80),   # ARM-B from 4 images
    (128, 1, torch.bfloat16, True, 80),
    (64, 1, torch.float32, True, 96),    # ARM-L (AM-MRG)
], ids=["s0", "s1", "s3", "arm-b", "arm-b-bf16", "arm-b-128",
        "arm-b-128-bf16", "arm-l"])
def test_xdbl_occupancy(cuda, rows, dirs, dtype, use_conv, c):
    """At the tiles ``xdbl_tile`` picks on the main paths the kernel keeps
    at least its ``_XDBL_BLOCKS`` blocks an SM (its register cap), within
    112 KB of shared memory a block."""
    blocks, smem = mf.xdbl_occupancy(rows, dirs, dtype, use_conv, 4, c)
    assert blocks >= mf._XDBL_BLOCKS and smem <= 112 * 1024, (blocks, smem)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("k_dirs,b,l,d,n,r,use_conv", [
    (4, 2, 197, 96, 16, 48, True),   # chunks of an ARM-B layer
    (4, 1, 3136, 64, 16, 6, False),  # vssm_tiny stage 0's 49 chunks
    (2, 3, 70, 40, 4, 3, True),      # N=4, a ragged last chunk
], ids=["arm-b", "vssm-tiny-s0", "n4"])
def test_scan_bwd_carries_match_the_plain_walk(cuda, dtype, k_dirs, b, l, d,
                                               n, r, use_conv):
    """The backward's chunk summaries composed by its carry kernel: the
    state entering every chunk and the adjoint entering its last row from
    the rows after it, every direction, against the sequential walks of
    the plain version, within 1e-5 of max(1, max |plain|)."""
    xr, xc, w = _inputs(cuda, dtype, k_dirs, b, l, d, n, r, seed=l + d)
    x_dbl = mf.xdbl_plain(xr, xc, w["conv_w"], w["conv_b"], w["x_proj_w"],
                          use_conv)
    dy = torch.randn(b, k_dirs, l, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(l))
    args = (xr, xc, x_dbl, w["conv_w"], w["conv_b"], w["dt_proj_w"],
            w["dt_bias"], w["A"], w["D"], dy.to(dtype), True, use_conv)
    want = mf.mamba_carries_plain(*args)
    got = mf.scan_bwd_carries(*args)
    torch.cuda.synchronize()
    for name, g, wv in zip(("h_in", "g_in"), got, want):
        assert g.shape == wv.shape == (b * k_dirs, -(-l // mf._BWD_CHUNK),
                                       n, d), name
        err, scale = _err(g, wv)
        assert err <= 1e-5 * scale, (name, err, scale)


@pytest.mark.cuda
def test_scan_bwd_is_deterministic(cuda):
    """Per-block and per-(b*k, chunk) partials summed in a fixed order, no
    float atomics: two calls give the same bits."""
    xr, xc, w = _inputs(cuda, torch.float32, 4, 3, 300, 100, 16, 8, seed=5)
    x_dbl = mf.xdbl_plain(xr, xc, w["conv_w"], w["conv_b"], w["x_proj_w"])
    dy = torch.randn(3, 4, 300, 100, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(6))
    args = (xr, xc, x_dbl, w["conv_w"], w["conv_b"], w["dt_proj_w"],
            w["dt_bias"], w["A"], w["D"], dy)
    first = mf.scan_bwd(*args)
    second = mf.scan_bwd(*args)
    for name, a, b in zip(BWD_OUTPUTS, first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rank", [6, 48], ids=["vssm-tiny-s0", "arm-b"])
def test_scan_bwd_occupancy(cuda, dtype, rank):
    """At N=16 and vssm_tiny stage 0's rank (6) and ARM-B's (48) the
    gradients kernel keeps at least 4 blocks of 64 threads resident on an
    SM, its shared memory within 45 KB a block; the summaries kernel at
    least as many."""
    occupancy = mf.bwd_occupancy(16, rank, dtype)
    assert set(occupancy) == set(mf.BWD_KERNELS)
    blocks, smem = occupancy["mamba_scan_bwd_grad_kernel"]
    assert smem <= 45 * 1024 and blocks >= 4, (blocks, smem)
    assert occupancy["mamba_scan_bwd_sums_kernel"][0] >= blocks, occupancy


@pytest.mark.cuda
def test_scan_bwd_refuses_what_the_kernel_does_not_take(cuda):
    xr, xc, w = _inputs(cuda, torch.float32, 4, 2, 10, 8, 4, 4, seed=0)
    x_dbl = mf.xdbl_plain(xr, xc, w["conv_w"], w["conv_b"], w["x_proj_w"])
    dy = torch.zeros(2, 4, 10, 8, device=cuda)
    rest = (w["conv_w"], w["conv_b"], w["dt_proj_w"], w["dt_bias"], w["A"],
            w["D"])
    with pytest.raises(ValueError, match="dy must be"):
        mf.scan_bwd(xr, xc, x_dbl, *rest, dy.bfloat16())
    with pytest.raises(ValueError, match="dy must be"):
        mf.scan_bwd(xr, xc, x_dbl, *rest, dy[:, :2])
    with pytest.raises(ValueError, match="fp32 tensor"):
        mf.scan_bwd(xr, xc, x_dbl[:, :5], *rest, dy)
    with pytest.raises(ValueError, match="d_state"):
        a3 = w["A"][..., :3].contiguous()
        x3 = x_dbl[..., :10].contiguous()
        mf.scan_bwd(xr, xc, x3, *rest[:4], a3, w["D"], dy)
    with pytest.raises(TypeError, match="not f32/bf16"):
        mf.scan_bwd(xr.half(), xc.half(), x_dbl, *rest, dy.half())


# --------------------------------------------------------------------------
# The d_state=1 scan (ops/scan_n1.py): forward and backward kernels
# --------------------------------------------------------------------------

N1_OUTPUTS = ("du", "dxdbl", "dA", "dD", "ddt_bias", "ddt_proj_w")
N1_SHAPES = [  # (B, L, D, R)
    (5, 33, 24, 3),      # odd L, B not a multiple of 8
    (3, 1, 16, 2),       # L = 1
    (2, 20, 70, 1),      # rank 1; D not a multiple of the block's 64
    (12, 196, 1024, 32),  # stage 2 of vssm1_base at the training batch
    (3, 1000, 70, 4),    # many chunks of the backward, L not a multiple
    (2, 3136, 256, 8),   # stage 0 of vssm1_base at a small batch
]
N1_IDS = ["odd-l", "l1", "r1", "stage2", "chunks", "stage0-b2"]
# The forward also at the context tower's 36 images, stages 0 and 3 (grids
# that fill the card), and at an odd D (bf16 rows staged without channel
# pairs).
N1_FWD_SHAPES = N1_SHAPES + [(36, 3136, 256, 8), (36, 49, 2048, 64),
                             (2, 40, 33, 2)]
N1_FWD_IDS = N1_IDS + ["stage0-b36", "stage3-b36", "odd-d"]


def _n1_inputs(dev, dtype, b, l, d, r, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.5):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    xr, xc = t(b, l, d).to(dtype), t(b, l, d).to(dtype)
    w = dict(x_proj_w=t(4, r + 2, d, scale=d**-0.5),
             dt_proj_w=t(4, d, r, scale=r**-0.5),
             dt_bias=t(4, d, scale=0.2), A=-torch.exp(t(4, d, scale=0.3)),
             D=t(4, d))
    x_dbl = sn._x_dbl(xr, xc, w["x_proj_w"])
    return xr, xc, x_dbl, w


def _n1_args(xr, xc, x_dbl, w):
    return (xr, xc, x_dbl, w["dt_proj_w"], w["dt_bias"], w["A"], w["D"])


def _n1_regime(monkeypatch, regime):
    """``scan_n1_fwd`` in ``regime``: as ``fwd_chunk`` picks it ("rule"),
    or forced to chunks of ``_CHUNK`` rows ("chunks") or to one pass over L
    ("one-pass")."""
    if regime == "chunks":
        monkeypatch.setattr(sn, "fwd_chunk",
                            lambda b, l, d, sms=0: min(sn._CHUNK, l))
    elif regime == "one-pass":
        monkeypatch.setattr(sn, "fwd_chunk", lambda b, l, d, sms=0: l)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["rule", "chunks", "one-pass"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,l,d,r", N1_FWD_SHAPES, ids=N1_FWD_IDS)
def test_scan_n1_fwd_matches_plain(cuda, monkeypatch, dtype, b, l, d, r,
                                   regime):
    """Both regimes, and the one the rule picks, at every shape; the rule
    cuts stage 0 at 2 images into chunks and takes stage 3 at 36 in one
    pass."""
    args = _n1_args(*_n1_inputs(cuda, dtype, b, l, d, r, seed=l + d))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if (b, l) == (2, 3136):
        assert sn.fwd_chunk(b, l, d, sms) == sn._CHUNK
    if (b, l) == (36, 49):
        assert sn.fwd_chunk(b, l, d, sms) == l
    _n1_regime(monkeypatch, regime)
    before = sn.launches["scan_n1_fwd"]
    want = sn.scan_n1_fwd_plain(*args)
    got = sn.scan_n1_fwd(*args)
    torch.cuda.synchronize()
    assert sn.launches["scan_n1_fwd"] == before + 1
    assert got.dtype == dtype and got.shape == (2, b, l, d)
    err, scale = _err(got, want)
    assert err <= Y_RTOL[dtype] * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["chunks", "one-pass"])
def test_scan_n1_fwd_is_deterministic(cuda, monkeypatch, regime):
    """No float atomics, nothing that depends on the blocks' order: two
    calls give the same bits."""
    args = _n1_args(*_n1_inputs(cuda, torch.float32, 6, 100, 200, 8, 3))
    _n1_regime(monkeypatch, regime)
    assert torch.equal(sn.scan_n1_fwd(*args), sn.scan_n1_fwd(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_scan_n1_fwd_occupancy(cuda, dtype):
    """At vssm1_base stage 0's rank (8), in chunks, the scan kernel keeps
    its cap of ``_FWD_BLOCKS`` blocks of 64 threads resident on an SM
    (shared memory within 32 KB a block), the summaries kernel as many;
    in one pass the scan kernel's shared memory is 8 KB less (no outputs
    of the forward direction kept)."""
    occupancy = sn.fwd_occupancy(8, dtype)
    assert set(occupancy) == set(sn.FWD_KERNELS)
    blocks, smem = occupancy["scan_n1_fwd_kernel"]
    assert smem <= 32 * 1024 and blocks >= sn._FWD_BLOCKS, (blocks, smem)
    assert occupancy["scan_n1_fwd_sums_kernel"][0] >= blocks, occupancy
    one_pass = sn.fwd_occupancy(8, dtype, cut=False)["scan_n1_fwd_kernel"]
    elt = torch.tensor([], dtype=dtype).element_size()
    assert one_pass[1] == smem - 32 * 64 * elt, (one_pass, smem)
    assert one_pass[0] >= blocks, (one_pass, blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,l,d,r", N1_SHAPES, ids=N1_IDS)
def test_scan_n1_bwd_matches_plain(cuda, dtype, b, l, d, r):
    args = _n1_args(*_n1_inputs(cuda, dtype, b, l, d, r, seed=l + d))
    dy = torch.randn(2, b, l, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(l))
    before = sn.launches["scan_n1_bwd"]
    want = sn.scan_n1_bwd_plain(*args, dy.to(dtype))
    got = sn.scan_n1_bwd(*args, dy.to(dtype))
    torch.cuda.synchronize()
    assert sn.launches["scan_n1_bwd"] == before + 1
    for name, g, wv in zip(N1_OUTPUTS, got, want):
        assert g.shape == wv.shape and g.dtype == torch.float32, name
        err, scale = _err(g, wv)
        assert err <= BWD_RTOL * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,l,d,r", [N1_SHAPES[0], N1_SHAPES[4],
                                     N1_SHAPES[5]],
                         ids=["odd-l", "chunks", "stage0-b2"])
def test_scan_n1_bwd_carries_match_the_plain_walk(cuda, dtype, b, l, d, r):
    """The backward's piece summaries composed by its carry kernel: the
    state entering every piece and the adjoint entering it from the rows
    after, every direction, against the sequential walks of the plain
    version, within 1e-5 of max(1, max |plain|)."""
    args = _n1_args(*_n1_inputs(cuda, dtype, b, l, d, r, seed=l + d))
    dy = torch.randn(2, b, l, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(l)).to(dtype)
    want = sn.scan_n1_carries_plain(*args, dy)
    got = sn.scan_n1_bwd_carries(*args, dy)
    torch.cuda.synchronize()
    for name, g, wv in zip(("h_in", "g_in"), got, want):
        slots = -(-l // sn._CHUNK) * (sn._CHUNK // sn._PIECE)
        assert g.shape == wv.shape == (4, b, slots, d), name
        err, scale = _err(g, wv)
        assert err <= 1e-5 * scale, (name, err, scale)


@pytest.mark.cuda
def test_scan_n1_bwd_is_deterministic(cuda):
    """Per-block and per-image partials summed in a fixed order, no float
    atomics: two runs give the same bits."""
    args = _n1_args(*_n1_inputs(cuda, torch.float32, 6, 100, 200, 8, 3))
    dy = torch.randn(2, 6, 100, 200, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(4))
    first = sn.scan_n1_bwd(*args, dy)
    second = sn.scan_n1_bwd(*args, dy)
    for name, a, b in zip(N1_OUTPUTS, first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_scan_n1_bwd_occupancy(cuda, dtype):
    """At vssm1_base stage 0's rank (8) the gradients kernel keeps 6 blocks
    of 64 threads resident on an SM (its registers capped for 6, its shared
    memory within 36 KB a block), the summaries kernel at least as many."""
    occupancy = sn.bwd_occupancy(8, dtype)
    assert set(occupancy) == set(sn.BWD_KERNELS)
    blocks, smem = occupancy["scan_n1_bwd_grad_kernel"]
    assert smem <= 36 * 1024 and blocks >= 6, (blocks, smem)
    assert occupancy["scan_n1_bwd_sums_kernel"][0] >= blocks, occupancy


@pytest.mark.cuda
def test_scan_n1_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    xr, xc, x_dbl, w = _n1_inputs(cuda, torch.float32, 2, 10, 8, 2, seed=0)
    rest = (w["dt_proj_w"], w["dt_bias"], w["A"], w["D"])
    with pytest.raises(TypeError, match="not f32/bf16"):
        sn.scan_n1_fwd(xr.half(), xc.half(), x_dbl, *rest)
    with pytest.raises(ValueError, match="contiguous"):
        sn.scan_n1_fwd(xr.transpose(0, 1).contiguous().transpose(0, 1), xc,
                       x_dbl, *rest)
    with pytest.raises(ValueError, match="xc must match"):
        sn.scan_n1_fwd(xr, xc.bfloat16(), x_dbl, *rest)
    with pytest.raises(ValueError, match="x_dbl must be"):
        sn.scan_n1_fwd(xr, xc, x_dbl[:, :, :5], *rest)
    with pytest.raises(ValueError, match="dt_proj_w must be"):
        sn.scan_n1_fwd(xr, xc, x_dbl, w["dt_proj_w"].double(), *rest[1:])
    dy = torch.zeros(2, 2, 10, 8, device=cuda)
    with pytest.raises(ValueError, match="dy must be"):
        sn.scan_n1_bwd(xr, xc, x_dbl, *rest, dy.bfloat16())
    with pytest.raises(ValueError, match="dy must be"):
        sn.scan_n1_bwd(xr, xc, x_dbl, *rest, dy[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("d_state,disable_z,conv_bias", [
    (1, True, False),   # scan_n1_sources
    (16, False, True),  # mamba_fused_dirs with conv_w=None (no conv)
], ids=["n1", "n16-noconv"])
def test_ss2d_through_kernels_matches_plain(cuda, d_state, disable_z,
                                            conv_bias):
    """Forward and every parameter's gradient of an SS2D layer; the n16
    case drives the fused layer's use_conv=False path, which the ARM never
    launches."""
    gen = torch.Generator(cuda).manual_seed(5)
    m = SS2D(32, d_state=d_state, disable_z=disable_z, conv_bias=conv_bias,
             device=cuda)
    init_params(m, gen)
    x = torch.randn(3, 7, 9, 32, device=cuda, generator=gen)
    w = torch.randn(3, 7, 9, 32, device=cuda, generator=gen)
    mf.reset_launches()
    sn.reset_launches()
    got_y = m(x)
    got = _grads(m, lambda: (m(x) * w).sum())
    torch.cuda.synchronize()
    if d_state == 1:
        assert sn.launches == {"scan_n1_fwd": 2, "scan_n1_bwd": 1}
        assert mf.launches["mamba_scan"] == 0
    else:
        assert mf.launches == {"mamba_xdbl": 2, "mamba_scan": 2,
                               "mamba_scan_bwd": 1}
        assert sn.launches["scan_n1_fwd"] == 0
    set_scan_backend(m, "plain")
    want_y = m(x)
    want = _grads(m, lambda: (m(x) * w).sum())
    err, scale = _err(got_y, want_y)
    assert err <= 1e-4 * scale
    assert set(want) == {name for name, _ in m.named_parameters()}
    _assert_grads_close(got, want)


@pytest.mark.cuda
def test_tiny_vssm1_through_kernels_matches_plain(cuda):
    """Every SS2D of a tiny vssm1 launches the forward kernel once without
    a gradient; the feature map agrees with the plain versions."""
    gen = torch.Generator(cuda).manual_seed(6)
    m = build_vssm("vssm1_tiny", depths=(1, 1, 2, 1), dims=(16, 32, 64, 128),
                   device=cuda).eval()
    init_params(m, gen)
    x = torch.randn(2, 64, 64, 3, device=cuda, generator=gen)
    sn.reset_launches()
    with torch.no_grad():
        got = m(x, pool=False)
        torch.cuda.synchronize()
        assert sn.launches == {"scan_n1_fwd": 5, "scan_n1_bwd": 0}
        set_scan_backend(m, "plain")
        want = m(x, pool=False)
    err, scale = _err(got, want)
    assert err <= 1e-4 * scale


# --------------------------------------------------------------------------
# The ViT block's sub-layers (ops/vit_block.py): forward and backward
# --------------------------------------------------------------------------

VIT_SHAPES = [  # (B, L, d, heads)
    (2, 13, 64, 4),     # ragged L, head width 16
    (3, 70, 128, 4),    # L past one 64-row tile, head width 32
    (2, 50, 768, 12),   # the 224^2 MAE encoder, head width 64
    (1, 197, 512, 16),  # the 224^2 MAE decoder
    (1, 33, 256, 2),    # head width 128
    (2, 200, 256, 8),   # head width 32, L ragged past three 64-row tiles
    (1, 150, 512, 4),   # head width 128, L ragged past four 32-row tiles
]
# fp32: reordered sums, 1e-4 of max(1, max |plain|). bf16: both sides round
# h, q/k/v, p, the head outputs and the sub-layer's output; the kernel
# rounds p before the softmax's division and the plain version after, so
# the outputs may land two bf16 steps apart.
VIT_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}
ATTN_GRADS = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dg", "db")
MLP_GRADS = ("dx", "dw1", "db1", "dw2", "db2", "dg", "db")


def _vit_inputs(dev, dtype, b, l, d, seed, hidden=None):
    rng = np.random.default_rng(seed)
    hidden = hidden or 4 * d

    def t(*shape, scale=0.5, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                                .astype(np.float32)).to(dev).to(dtype)

    x = t(b, l, d, scale=1.0)
    attn = (t(d, 3 * d, scale=d**-0.5), t(3 * d, scale=0.1),
            t(d, d, scale=d**-0.5), t(d, scale=0.1), t(d, scale=0.1,
                                                        shift=1.0),
            t(d, scale=0.1))
    mlp = (t(d, hidden, scale=d**-0.5), t(hidden, scale=0.1),
           t(hidden, d, scale=hidden**-0.5), t(d, scale=0.1),
           t(d, scale=0.1, shift=1.0), t(d, scale=0.1))
    dy = t(b, l, d, scale=1.0)
    return x, attn, mlp, dy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,l,d,heads", VIT_SHAPES,
                         ids=["hd16", "hd32", "enc224", "dec224", "hd128",
                              "hd32-ragged", "hd128-ragged"])
def test_vit_fwd_kernels_match_plain(cuda, dtype, b, l, d, heads):
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    x, attn, mlp, _ = _vit_inputs(cuda, dtype, b, l, d, seed=l + d)
    before = dict(vb.launches)
    for name, plain, kernel, args in (
        ("vit_attn_fwd", vb.attn_block_plain, vb.attn_block_fwd,
         (x, *attn, heads)),
        ("vit_mlp_fwd", vb.mlp_block_plain, vb.mlp_block_fwd, (x, *mlp)),
    ):
        want = plain(*args)
        got = kernel(*args)
        torch.cuda.synchronize()
        assert vb.launches[name] == before[name] + 1
        assert got.dtype == dtype and got.shape == x.shape
        err, scale = _err(got, want)
        assert err <= VIT_RTOL[dtype] * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,heads", VIT_SHAPES,
                         ids=["hd16", "hd32", "enc224", "dec224", "hd128",
                              "hd32-ragged", "hd128-ragged"])
def test_vit_bwd_kernels_match_plain(cuda, b, l, d, heads):
    """Every output of both backward kernels against the plain backward,
    and the plain backward against autograd of the plain forward."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    x, attn, mlp, dy = _vit_inputs(cuda, torch.float32, b, l, d, seed=l)
    for name, plain_fwd, plain, kernel, args, names in (
        ("vit_attn_bwd", vb.attn_block_plain, vb.attn_block_bwd_plain,
         vb.attn_block_bwd, (x, *attn, heads), ATTN_GRADS),
        ("vit_mlp_bwd", vb.mlp_block_plain, vb.mlp_block_bwd_plain,
         vb.mlp_block_bwd, (x, *mlp), MLP_GRADS),
    ):
        before = vb.launches[name]
        want = plain(*args, dy)
        got = kernel(*args, dy)
        torch.cuda.synchronize()
        assert vb.launches[name] == before + 1
        leaves = [a.clone().requires_grad_() if torch.is_tensor(a) else a
                  for a in args]
        auto = torch.autograd.grad(
            plain_fwd(*leaves), [a for a in leaves if torch.is_tensor(a)], dy)
        for n, g, wv, av in zip(names, got, want, auto):
            assert g.shape == wv.shape and g.dtype == torch.float32, n
            err, scale = _err(g, wv)
            assert err <= BWD_RTOL * scale, (name, n, err, scale)
            err, scale = _err(wv, av)
            assert err <= BWD_RTOL * scale, (name, n, "autograd", err, scale)


@pytest.mark.cuda
def test_vit_bwd_is_deterministic(cuda):
    """Split-K partials and per-block sums in a fixed order: two runs give
    the same bits."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    x, attn, mlp, dy = _vit_inputs(cuda, torch.float32, 4, 333, 256, seed=3)
    for fn, args in ((vb.attn_block_bwd, (x, *attn, 8)),
                     (vb.mlp_block_bwd, (x, *mlp))):
        first = fn(*args, dy)
        second = fn(*args, dy)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_vit_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    x, attn, mlp, dy = _vit_inputs(cuda, torch.float32, 2, 10, 64, seed=0)
    with pytest.raises(ValueError, match="head width"):
        vb.attn_block_fwd(x, *attn, 8)  # head width 8
    with pytest.raises(TypeError, match="dtype"):
        vb.mlp_block_fwd(x.half(), *(w.half() for w in mlp))
    with pytest.raises(ValueError, match="w1 must be"):
        vb.mlp_block_fwd(x, mlp[0].t(), *mlp[1:])
    with pytest.raises(ValueError, match="contiguous"):
        vb.mlp_block_fwd(x.transpose(0, 1), *mlp)
    xb = x.bfloat16()
    with pytest.raises(TypeError, match="dtype"):
        vb.mlp_block_bwd(xb, *(w.bfloat16() for w in mlp), dy.bfloat16())
    with pytest.raises(ValueError, match="dy must be"):
        vb.attn_block_bwd(x, *attn, 4, dy[:1])


# The tensor-core GEMM's epilogues, by ``EPI_*`` name, and its tolerance
# against an fp64 product of the same operands, by output dtype: fp32 out of
# 3xTF32 (about 22 bits of each operand) or of exact bf16 products, summed
# in fp32, 1e-5 of max(1, max |fp64|); bf16 outputs rounded at the kernel's
# points, where an fp32 sum and an fp64 one may round to neighbouring bf16
# values once at each of the two rounding points: 2^-6 of the scale.
GEMM_EPIS = ("F32", "BIAS", "BIAS_GELU", "BIAS_RESID", "DGELU", "STORE",
             "BIAS_F32_GELU")
GEMM_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-6}


@pytest.mark.cuda
@pytest.mark.parametrize("epi", GEMM_EPIS)
@pytest.mark.parametrize("a_trans,b_trans", [(False, False), (True, False),
                                             (False, True), (True, True)],
                         ids=["nn", "tn", "nt", "tt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_gemm_tc_matches_fp64(cuda, dtype, a_trans, b_trans, epi):
    """The tensor-core GEMM against an fp64 product of its operands at
    ragged M, N and K (past whole 128 x 128 tiles and 32-deep slices),
    either operand stored either way round, every epilogue rounded where
    the kernel rounds; the fp32 epilogue at K = 2,056 in two split-K
    chunks."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    m, n = 200, 136
    k = 2056 if epi == "F32" else 72
    rng = np.random.default_rng(k + 7 * a_trans + 3 * b_trans)

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(cuda)

    a = (t(k, m) if a_trans else t(m, k)).to(dtype)
    b = (t(n, k) if b_trans else t(k, n)).to(dtype)
    bias, resid, aux = t(n).to(dtype), t(m, n).to(dtype), t(m, n)
    acc = ((a.double().t() if a_trans else a.double())
           @ (b.double().t() if b_trans else b.double()))
    pre = acc + bias.double()
    run = vb._Launcher(a)
    code = getattr(vb, f"EPI_{epi}")
    kw = dict(a_trans=a_trans, b_trans=b_trans, epi=code, bias=bias,
              resid=resid, aux=aux)
    scale = None
    if epi == "F32":
        pairs = [(run.gemm(a, b, m, n, k, a_trans=a_trans, b_trans=b_trans),
                  acc)]
    elif epi == "BIAS_F32_GELU":
        out, out2 = run.f32(m, n), run.like(m, n)
        run.gemm(a, b, m, n, k, out=out, out2=out2, **kw)
        pairs = [(out, pre), (out2, vb.gelu_tanh(pre).to(dtype))]
    else:
        out = run.gemm(a, b, m, n, k, out=run.like(m, n), **kw)
        want = {"BIAS": pre, "STORE": acc, "BIAS_GELU": vb.gelu_tanh(pre),
                "BIAS_RESID": resid.double() + pre.to(dtype).double(),
                "DGELU": acc * vb._gelu_tanh_grad(aux.double())}[epi]
        pairs = [(out, want.to(dtype))]
        if epi == "BIAS_RESID":  # the inner rounding at its own scale
            scale = max(1.0, pre.abs().max().item(),
                        want.abs().max().item())
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.shape == (m, n)
        err, s = _err(got.double(), want.double())
        assert err <= GEMM_RTOL[got.dtype] * (scale or s), (epi, err, s)


@pytest.mark.cuda
def test_gemm_tc_refuses_what_it_does_not_take(cuda):
    """16-byte copies: a bf16 operand whose contiguous extent is not a
    multiple of 8 elements is refused (4 fp32 elements are 16 bytes and
    pass); so are an epilogue code outside ``enum Epi`` and a split of K
    under a rounding epilogue."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    a = torch.randn(64, 44, device=cuda)
    b = torch.randn(44, 64, device=cuda)
    run = vb._Launcher(a)
    run.gemm(a, b, 64, 64, 44, epi=vb.EPI_STORE, out=run.f32(64, 64))
    ab, bb = a.bfloat16(), b.bfloat16()
    runb = vb._Launcher(ab)
    with pytest.raises(RuntimeError, match="vit_gemm_tc"):
        runb.gemm(ab, bb, 64, 64, 44, epi=vb.EPI_STORE, out=runb.like(64, 64))
    with pytest.raises(RuntimeError, match="vit_gemm_tc"):
        run.gemm(a, b, 64, 64, 44, epi=7, bias=torch.zeros(64, device=cuda),
                 out=run.f32(64, 64))
    lib = run.lib
    out = run.f32(64, 64)
    assert lib.mia_vit_gemm_tc(0, a.data_ptr(), 0, 44, b.data_ptr(), 0, 64,
                               64, 64, 44, 32, vb.EPI_STORE, None, None,
                               None, 64, out.data_ptr(), None, 64,
                               run.stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_vit_attn_fwd_bf16_at_every_head_width(cuda, hd):
    """``vit_attn_fwd`` in bf16 (both products bf16-direct on the tensor
    cores, the tensor-core core reading q, k, v in place) against the
    plain version at each head width, over L = 333 (five whole 64-key
    tiles and a ragged one)."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    d = 256
    x, attn, _, _ = _vit_inputs(cuda, torch.bfloat16, 2, 333, d, seed=hd)
    before = vb.launches["vit_attn_fwd"]
    want = vb.attn_block_plain(x, *attn, d // hd)
    got = vb.attn_block_fwd(x, *attn, d // hd)
    torch.cuda.synchronize()
    assert vb.launches["vit_attn_fwd"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    err, scale = _err(got, want)
    assert err <= VIT_RTOL[torch.bfloat16] * scale, (err, scale)


@pytest.mark.cuda
def test_vit_mlp_fwd_bf16_at_a_ragged_length(cuda):
    """``vit_mlp_fwd`` in bf16 (LN(x), then both products bf16-direct on the
    tensor cores with the bias + GELU and bias + residual epilogues)
    against the plain version over L = 333: rows past whole 128-row
    tiles."""
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    x, _, mlp, _ = _vit_inputs(cuda, torch.bfloat16, 2, 333, 256, seed=5)
    before = vb.launches["vit_mlp_fwd"]
    want = vb.mlp_block_plain(x, *mlp)
    got = vb.mlp_block_fwd(x, *mlp)
    torch.cuda.synchronize()
    assert vb.launches["vit_mlp_fwd"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    err, scale = _err(got, want)
    assert err <= VIT_RTOL[torch.bfloat16] * scale, (err, scale)


def _kernel_names(fn):
    """The names of the CUDA kernels one call of ``fn`` launches, from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if e.self_device_time_total > 0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mlp-fp32", "mlp-bf16", "swin-fp32"])
def test_moved_sublayers_run_on_the_tensor_core_gemm(cuda, case):
    """``vit_mlp_fwd`` (fp32 and bf16) and ``swin_attn_fwd`` launch the
    tensor-core ``gemm_tc_kernel`` and no kernel named ``gemm_kernel``."""
    from medical_image_analysis_tpu_torch.ops import swin_block as sb
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    if case == "swin-fp32":
        x, w, bias, mask = _swin_inputs(cuda, torch.float32, 128, 192, 6, 64,
                                        2)
        names = _kernel_names(lambda: sb.swin_attn_fwd(x, *w, bias, mask, 6))
    else:
        dtype = torch.float32 if case == "mlp-fp32" else torch.bfloat16
        x, _, mlp, _ = _vit_inputs(cuda, dtype, 2, 70, 128, seed=2)
        names = _kernel_names(lambda: vb.mlp_block_fwd(x, *mlp))
    named = [re.search(r"(?<!\w)(gemm_tc_kernel|gemm_kernel)(?!\w)", n)
             for n in names]
    assert any(m and m.group(1) == "gemm_tc_kernel" for m in named), names
    assert not any(m and m.group(1) == "gemm_kernel" for m in named), names


@pytest.mark.cuda
@pytest.mark.parametrize("mask_type", ["random", "region"])
def test_tiny_mae_through_kernels_matches_plain(cuda, mask_type):
    """Each TransformerBlock launches the four kernels once a step; the
    loss and every parameter's gradient agree with the plain versions
    (``set_fused(model, False)``)."""
    from medical_image_analysis_tpu_torch.models.common import set_fused
    from medical_image_analysis_tpu_torch.models.vit import MAE
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    gen = torch.Generator(cuda).manual_seed(4)
    model = MAE(embed_dim=64, depth=2, num_heads=4, decoder_embed_dim=64,
                decoder_depth=1, decoder_num_heads=2, device=cuda)
    init_params(model, gen)
    imgs = torch.randn(2, 128, 128, 3, device=cuda, generator=gen)
    noise = torch.rand(2, 64, device=cuda, generator=gen)

    def loss():
        return model(imgs, noise, mask_type, 0.75, 0.85,
                     deterministic=False)[0]

    vb.reset_launches()
    got_loss = loss().item()
    got = _grads(model, loss)
    torch.cuda.synchronize()
    assert vb.launches == {"vit_attn_fwd": 6, "vit_mlp_fwd": 6,
                           "vit_attn_bwd": 3, "vit_mlp_bwd": 3}
    set_fused(model, False)
    want_loss = loss().item()
    want = _grads(model, loss)
    assert vb.launches["vit_attn_fwd"] == 6
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    _assert_grads_close(got, want)


@pytest.mark.cuda
def test_block_with_drop_path_trains_through_kernels(cuda):
    """Stochastic depth in training stays on the kernels: the branch is
    dropped around the wrappers' output, and the gradients agree with the
    plain versions under the same keep masks."""
    from medical_image_analysis_tpu_torch.models.common import set_fused
    from medical_image_analysis_tpu_torch.models.vit import TransformerBlock
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    gen = torch.Generator(cuda).manual_seed(6)
    block = TransformerBlock(64, 4, drop_path=0.5, device=cuda)
    init_params(block, gen)
    x = torch.randn(8, 13, 64, device=cuda, generator=gen)

    def loss():
        torch.manual_seed(0)  # the same keep masks on both paths
        return (block(x, deterministic=False) ** 2).sum()

    vb.reset_launches()
    got = _grads(block, loss)
    torch.cuda.synchronize()
    assert vb.launches == dict.fromkeys(vb.launches, 1)
    set_fused(block, False)
    want = _grads(block, loss)
    assert vb.launches == dict.fromkeys(vb.launches, 1)
    _assert_grads_close(got, want)


# The Swin window-attention sub-layer at two swin_large stage shapes (B=2
# images: stage 0 with 128 windows, C=192, 6 heads, shifted nW=64; stage 3
# with 2 windows, C=1536, 48 heads, unshifted). fp32: reordered sums, 1e-4
# of max(1, max |plain|); bf16: the plain version rounds p after the
# softmax's division as the kernel does, but the sums run in another order,
# so two bf16 steps.
SWIN_SHAPES = ((128, 192, 6, 64), (2, 1536, 48, 1))
SWIN_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}


def _swin_inputs(dev, dtype, bn, d, heads, nw, seed):
    from medical_image_analysis_tpu_torch.models.swin import _shift_attn_mask

    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                                .astype(np.float32)).to(dev)

    x = t(bn, 49, d).to(dtype)
    w = [t(d, 3 * d, scale=d**-0.5), t(3 * d, scale=0.1),
         t(d, d, scale=d**-0.5), t(d, scale=0.1), t(d, scale=0.1, shift=1.0),
         t(d, scale=0.1)]
    bias = t(heads, 49, 49, scale=0.5)
    mask = (torch.from_numpy(_shift_attn_mask(56, 56, 7, 3)).to(dev)
            if nw > 1 else torch.zeros(1, 49, 49, device=dev))
    return x, [a.to(dtype) for a in w], bias, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("bn,d,heads,nw", SWIN_SHAPES,
                         ids=["stage0-shifted", "stage3-unshifted"])
def test_swin_attn_kernel_matches_plain(cuda, dtype, bn, d, heads, nw):
    from medical_image_analysis_tpu_torch.ops import swin_block as sb

    x, w, bias, mask = _swin_inputs(cuda, dtype, bn, d, heads, nw, bn)
    sb.reset_launches()
    got = sb.swin_attn_fwd(x, *w, bias, mask, heads)
    torch.cuda.synchronize()
    assert sb.launches["swin_attn_fwd"] == 1
    want = sb.swin_attn_block_plain(x, *w, bias, mask, heads)
    assert got.shape == x.shape and got.dtype == dtype
    assert got.data_ptr() != x.data_ptr()
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= SWIN_RTOL[dtype] * scale, (err, scale)


@pytest.mark.cuda
def test_swinchex_through_kernel_matches_plain(cuda):
    """A two-stage SwinCheX at 112^2 under no_grad: one kernel call per
    block, logits within 1e-4 of the plain versions' (``set_fused(model,
    False)``); with a gradient no call at all."""
    from medical_image_analysis_tpu_torch.models.common import set_fused
    from medical_image_analysis_tpu_torch.models.swin import (
        SwinCheX,
        SwinTransformer,
    )
    from medical_image_analysis_tpu_torch.ops import swin_block as sb

    gen = torch.Generator(cuda).manual_seed(8)
    model = SwinCheX(SwinTransformer(embed_dim=64, depths=(2, 2),
                                     num_heads=(2, 4), img_size=112,
                                     device=cuda), 14, device=cuda)
    init_params(model, gen)
    x = torch.randn(4, 112, 112, 3, device=cuda, generator=gen)
    sb.reset_launches()
    with torch.no_grad():
        got = model(x)
        torch.cuda.synchronize()
        assert sb.launches["swin_attn_fwd"] == 4
        set_fused(model, False)
        want = model(x)
    assert sb.launches["swin_attn_fwd"] == 4
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-4 * scale
    set_fused(model, True)
    model(x).sum().backward()
    assert sb.launches["swin_attn_fwd"] == 4


@pytest.mark.cuda
def test_swin_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from medical_image_analysis_tpu_torch.ops import swin_block as sb

    x, w, bias, mask = _swin_inputs(cuda, torch.float32, 128, 192, 6, 64, 1)
    with pytest.raises(ValueError, match="head width"):
        sb.swin_attn_fwd(x, *w, bias, mask, 8)
    with pytest.raises(ValueError, match="contiguous"):
        sb.swin_attn_fwd(x.transpose(0, 1), *w, bias, mask, 6)
    with pytest.raises(ValueError, match="mask"):
        sb.swin_attn_fwd(x, *w, bias, mask[:, :, :48], 6)
    with pytest.raises(ValueError, match="multiple"):
        sb.swin_attn_fwd(x[:100].contiguous(), *w, bias, mask, 6)
    with pytest.raises(TypeError, match="dtype"):
        sb.swin_attn_fwd(x.double(), *w, bias, mask, 6)


# AM-MRG's bank chain: the small SwinCheX (embed 16, heads (2, 2), window 4)
# whose stage 0 has heads of 8, over 224^2 images (196 windows of 16 tokens
# an image at stage 0, 49 at stage 1).
BANK_SWIN = dict(embed_dim=16, depths=(1, 1), num_heads=(2, 2),
                 window_size=4, drop_path_rate=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("nw", [196, 1], ids=["shifted", "unshifted"])
def test_swin_attn_kernel_at_head_width_8_matches_plain(cuda, dtype, nw):
    """Two images of the bank chain's stage 0 (392 windows of 16 tokens,
    C = 16, 2 heads of 8), with the shift mask of a 56^2 map or none."""
    from medical_image_analysis_tpu_torch.models.swin import _shift_attn_mask
    from medical_image_analysis_tpu_torch.ops import swin_block as sb

    gen = torch.Generator(cuda).manual_seed(nw)

    def t(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, device=cuda, generator=gen) * scale
                + shift)

    d, heads = 16, 2
    x = t(392, 16, d).to(dtype)
    w = [a.to(dtype) for a in (t(d, 3 * d, scale=d**-0.5), t(3 * d, scale=0.1),
                               t(d, d, scale=d**-0.5), t(d, scale=0.1),
                               t(d, scale=0.1, shift=1.0), t(d, scale=0.1))]
    bias = t(heads, 16, 16, scale=0.5)
    mask = (torch.from_numpy(_shift_attn_mask(56, 56, 4, 2)).to(cuda)
            if nw > 1 else torch.zeros(1, 16, 16, device=cuda))
    sb.reset_launches()
    got = sb.swin_attn_fwd(x, *w, bias, mask, heads)
    torch.cuda.synchronize()
    assert sb.launches["swin_attn_fwd"] == 1
    want = sb.swin_attn_block_plain(x, *w, bias, mask, heads)
    assert got.shape == x.shape and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= SWIN_RTOL[dtype] * scale, (err, scale)


@pytest.mark.cuda
def test_bank_chain_grad_cam_through_kernel_matches_plain(cuda):
    """``swin_grad_cam`` over the bank chain's SwinCheX at 224^2: its
    tokens (no gradient) through the kernel, one call a block, against
    ``set_fused(model, False)``; the cam within 1e-4 likewise."""
    from medical_image_analysis_tpu_torch.models.swin import (
        SwinCheX,
        SwinTransformer,
    )
    from medical_image_analysis_tpu_torch.ops import swin_block as sb
    from medical_image_analysis_tpu_torch.utils.cam import swin_grad_cam

    gen = torch.Generator(cuda).manual_seed(3)
    model = SwinCheX(SwinTransformer(**BANK_SWIN, img_size=224, device=cuda),
                     14, device=cuda)
    init_params(model, gen)
    x = torch.randn(4, 224, 224, 3, device=cuda, generator=gen)
    sb.reset_launches()
    got = swin_grad_cam(model, x, 5)
    torch.cuda.synchronize()
    assert sb.launches["swin_attn_fwd"] == 2
    set_fused(model, False)
    want = swin_grad_cam(model, x, 5)
    set_fused(model, True)
    assert sb.launches["swin_attn_fwd"] == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err, scale = _err(g, w)
        assert err <= 1e-4 * scale, (err, scale)


@pytest.mark.cuda
def test_rgcn_conv_is_deterministic(cuda):
    """R2GenKG's largest scale (40 nodes and the dummy row, 768 wide, 64
    edges of which 20 pads): two forwards and two backwards give the same
    bits (one-hot products, no atomics)."""
    from medical_image_analysis_tpu_torch.models.rgcn import rgcn_conv

    gen = torch.Generator(cuda).manual_seed(4)
    h = torch.randn(41, 768, device=cuda, generator=gen)
    h[40] = 0.0
    ei = torch.full((2, 64), 40, dtype=torch.int32, device=cuda)
    ei[:, :44] = torch.randint(0, 40, (2, 44), device=cuda, generator=gen,
                               dtype=torch.int32)
    et = torch.zeros(64, dtype=torch.int32, device=cuda)
    et[:44] = torch.randint(0, 3, (44,), device=cuda, generator=gen,
                            dtype=torch.int32)
    w_rel = (torch.randn(3, 768, 768, device=cuda, generator=gen)
             / 48).requires_grad_()
    w_self = (torch.randn(768, 768, device=cuda, generator=gen)
              / 28).requires_grad_()
    x = h.requires_grad_()
    cot = torch.randn(41, 768, device=cuda, generator=gen)
    runs = []
    for _ in range(2):
        y = rgcn_conv(torch.relu(rgcn_conv(x, ei, et, w_rel, w_self)), ei, et,
                      w_rel, w_self)
        runs.append((y, *torch.autograd.grad(y, (x, w_rel, w_self), cot)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ARM-L's fused layer in AM-MRG: K=4, D=1024, N=16, dt rank 64 (C = 96),
# at a short L with the x_dbl tile that xdbl_tile picks at L=197 for the
# serving image (B=1) and the training step's 12 images.
ARM_L = dict(k_dirs=4, d=1024, n=16, r=64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b", [1, 12], ids=["b1", "b12"])
def test_arm_large_kernels_match_plain(cuda, monkeypatch, dtype, b):
    k, d, n, r = ARM_L.values()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tile = mf.xdbl_tile(b, k, 197, d, r + 2 * n, sms)
    monkeypatch.setattr(mf, "xdbl_tile", lambda *a, **kw: tile)
    l = 37
    xr, xc, w = _inputs(cuda, dtype, k, b, l, d, n, r, seed=b)
    xargs = (xr, xc, w["conv_w"], w["conv_b"], w["x_proj_w"], True)
    got_x, want_x = mf.xdbl_fwd(*xargs), mf.xdbl_plain(*xargs)
    err, scale = _err(got_x, want_x)
    assert got_x.shape == (b * k, l, r + 2 * n) and err <= 1e-4 * scale
    sargs = (xr, xc, want_x, w["conv_w"], w["conv_b"], w["dt_proj_w"],
             w["dt_bias"], w["A"], w["D"], True, True)
    err, scale = _err(mf.scan_fwd(*sargs), mf.scan_plain(*sargs))
    assert err <= Y_RTOL[dtype] * scale, (err, scale)
    dy = torch.randn(b, k, l, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(b))
    bargs = (*sargs[:9], dy.to(dtype), True, True)
    for name, g, wv in zip(BWD_OUTPUTS, mf.scan_bwd(*bargs),
                           mf.scan_bwd_plain(*bargs)):
        err, scale = _err(g, wv)
        assert err <= BWD_RTOL * scale, (name, err, scale)


# --------------------------------------------------------------------------
# The general selective scan (ops/selective_scan_pallas.py) and the fused
# short-sequence attention (ops/attention.py). Tolerances as above: fp32
# outputs 1e-4 of max(1, max |plain|); an output rounded to bf16 on both
# sides (y, du, ddelta, dB, dC from bf16 sources) one bf16 step; the
# attention in bf16 two steps (p rounded before the product, the output
# after it).
# --------------------------------------------------------------------------

SS_NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "ddelta_bias")
# rows, L, D, N, G, B and C read in place from a wider x_dbl
SS_CASES = [(8, 37, 24, 1, 4, False), (8, 37, 24, 4, 2, True),
            (6, 40, 70, 8, 1, False), (8, 197, 96, 16, 4, True)]


def _ss_inputs(dev, dtype, rows, l, d, n, g, strided, seed):
    gen = torch.Generator(dev).manual_seed(seed)

    def t(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    if strided:  # B and C as slices of a (rows, L, R + 2N) x_dbl, R = 3
        x_dbl = t(rows, l, 3 + 2 * n).to(dtype)
        bm, cm = x_dbl[..., 3 : 3 + n], x_dbl[..., 3 + n :]
    else:
        bm, cm = t(rows, l, n).to(dtype), t(rows, l, n).to(dtype)
    return (t(rows, l, d).to(dtype), t(rows, l, d, scale=0.5).to(dtype),
            -torch.exp(t(g, d, n, scale=0.3)), bm, cm, t(g, d),
            t(g, d, scale=0.2))


def _ss_tol(dtype, out_dtype):
    return 2.0**-7 if out_dtype == torch.bfloat16 else 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,l,d,n,g,strided", SS_CASES,
                         ids=["n1", "n4-strided", "n8-g1", "n16-strided"])
def test_selective_scan_kernels_match_plain(cuda, dtype, rows, l, d, n, g,
                                            strided):
    args = _ss_inputs(cuda, dtype, rows, l, d, n, g, strided, seed=l + n)
    dy = torch.randn(rows, l, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(n)).to(dtype)
    before = dict(ssp.launches)
    want_y = ssp.selective_scan_fwd_plain(*args, delta_softplus=True)
    got_y = ssp.selective_scan_fwd(*args, delta_softplus=True)
    want = ssp.selective_scan_bwd_plain(*args, dy, delta_softplus=True)
    got = ssp.selective_scan_bwd(*args, dy, delta_softplus=True)
    torch.cuda.synchronize()
    assert ssp.launches == {"selective_scan_fwd": before[
        "selective_scan_fwd"] + 1, "selective_scan_bwd": before[
        "selective_scan_bwd"] + 1}
    assert got_y.dtype == dtype
    err, scale = _err(got_y, want_y)
    assert err <= _ss_tol(dtype, dtype) * scale
    for name, gv, wv in zip(SS_NAMES, got, want):
        assert gv.shape == wv.shape and gv.dtype == wv.dtype, name
        err, scale = _err(gv, wv)
        assert err <= _ss_tol(dtype, gv.dtype) * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,l,d,n,g,strided", [SS_CASES[0], SS_CASES[3]],
                         ids=["n1", "n16-strided"])
def test_selective_scan_bwd_is_deterministic(cuda, dtype, rows, l, d, n, g,
                                             strided):
    """Two calls of the backward give the same seven outputs to the bit:
    the sums over channels and over L run in a fixed order, no atomics."""
    args = _ss_inputs(cuda, dtype, rows, l, d, n, g, strided, seed=l * n)
    dy = torch.randn(rows, l, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(l)).to(dtype)
    first = ssp.selective_scan_bwd(*args, dy, delta_softplus=True)
    second = ssp.selective_scan_bwd(*args, dy, delta_softplus=True)
    for name, a, b in zip(SS_NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_selective_scan_bwd_occupancy(cuda, dtype):
    """At d_state 16 the backward keeps at least 5 blocks of 64 threads
    resident on an SM: its shared memory stays within 44 KB a block."""
    blocks, smem = ssp.bwd_occupancy(16, dtype)
    assert smem <= 44 * 1024
    assert blocks >= 5, (blocks, smem)


# SS_CASES and the edges of the forward's 4-row tiles: L = 1, L under a
# tile with D = 70 (staged by plain loads), a ragged second tile past two
# channel blocks.
SS_FWD_CASES = SS_CASES + [(4, 1, 64, 16, 2, True), (4, 3, 70, 4, 1, False),
                           (4, 6, 130, 16, 2, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,l,d,n,g,strided", SS_FWD_CASES,
                         ids=["n1", "n4-strided", "n8-g1", "n16-strided",
                              "l1", "l3-d70", "l6-d130"])
def test_selective_scan_fwd_matches_plain(cuda, dtype, rows, l, d, n, g,
                                          strided):
    """The forward at d_state 1, 4, 8 and 16 and at its tiles' edges, one
    launch counted a call."""
    args = _ss_inputs(cuda, dtype, rows, l, d, n, g, strided, seed=l + d + n)
    before = ssp.launches["selective_scan_fwd"]
    want = ssp.selective_scan_fwd_plain(*args, delta_softplus=True)
    got = ssp.selective_scan_fwd(*args, delta_softplus=True)
    torch.cuda.synchronize()
    assert ssp.launches["selective_scan_fwd"] == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    err, scale = _err(got, want)
    assert err <= _ss_tol(dtype, dtype) * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_selective_scan_fwd_reads_b_and_c_at_misaligned_offsets(cuda, dtype):
    """B and C read in place from a (rows, L, R + 2N) x_dbl with R = 6, as
    at vssm_tiny stage 0: B starts 24 bytes into a 152-byte fp32 row (12
    into 76 in bf16), no 16-byte alignment; softplus on and off."""
    rows, l, d, n, r = 6, 197, 192, 16, 6
    gen = torch.Generator(cuda).manual_seed(6)
    x_dbl = torch.randn(rows, l, r + 2 * n, device=cuda, generator=gen)
    x_dbl = x_dbl.to(dtype)
    bm, cm = x_dbl[..., r : r + n], x_dbl[..., r + n :]
    assert bm.data_ptr() % 16 and cm.data_ptr() % 16
    u = torch.nn.functional.silu(
        torch.randn(rows, l, d, device=cuda, generator=gen)).to(dtype)
    delta = (torch.randn(rows, l, d, device=cuda, generator=gen)
             * 0.5).to(dtype)
    a = -torch.exp(torch.randn(2, d, n, device=cuda, generator=gen) * 0.3)
    dv = torch.randn(2, d, device=cuda, generator=gen)
    db = torch.randn(2, d, device=cuda, generator=gen) * 0.2
    for softplus in (True, False):
        # without softplus dt = |delta| + |bias| keeps the states decaying
        args = ((u, delta, a, bm, cm, dv, db) if softplus else
                (u, delta.abs(), a, bm, cm, dv, db.abs()))
        want = ssp.selective_scan_fwd_plain(*args, delta_softplus=softplus)
        got = ssp.selective_scan_fwd(*args, delta_softplus=softplus)
        err, scale = _err(got, want)
        assert err <= _ss_tol(dtype, dtype) * scale, (softplus, err, scale)


@pytest.mark.cuda
def test_selective_scan_fwd_is_deterministic(cuda):
    """No atomics: two calls give the same bits."""
    args = _ss_inputs(cuda, torch.float32, *SS_CASES[3], seed=5)
    assert torch.equal(ssp.selective_scan_fwd(*args, delta_softplus=True),
                       ssp.selective_scan_fwd(*args, delta_softplus=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_selective_scan_fwd_occupancy(cuda, dtype):
    """At d_state 16 the forward keeps its cap of ``_FWD_BLOCKS`` blocks of
    64 threads resident on an SM, with its shared memory of four staged
    tiles (4 rows of B and C in fp32, of u and delta in the source type);
    vssm_tiny stage 0 at B=128 (1,536 blocks) is then one wave."""
    blocks, smem = ssp.fwd_occupancy(16, dtype)
    elt = torch.tensor([], dtype=dtype).element_size()
    assert smem == 4 * (4 * 32 * 4 + 2 * 4 * 64 * elt), smem
    assert blocks >= ssp._FWD_BLOCKS, blocks
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ssp.fwd_grid_blocks(512, 192) == 3 * 512 <= sms * blocks


@pytest.mark.cuda
def test_selective_scan_fn_grads_match_plain(cuda):
    """``selective_scan_dirs`` with every input requiring grad: the kernels
    forward and backward against the plain pair, B and C slices of x_dbl,
    softplus off (so dt = delta + bias is kept positive: a decaying
    state)."""
    gen = torch.Generator(cuda).manual_seed(3)
    b, k, l, d, n = 2, 4, 50, 40, 16
    x_dbl = torch.randn(b, k, l, 2 + 2 * n, device=cuda, generator=gen)
    leaves = [torch.randn(b, k, l, d, device=cuda, generator=gen),
              torch.rand(b, k, l, d, device=cuda, generator=gen) * 0.1,
              -torch.exp(torch.randn(k, d, n, device=cuda, generator=gen)),
              x_dbl, torch.randn(k, d, device=cuda, generator=gen),
              torch.rand(k, d, device=cuda, generator=gen) * 0.1]
    w = torch.randn(b, k, l, d, device=cuda, generator=gen)
    grads = {}
    for plain in (False, True):
        ts = [t.clone().requires_grad_() for t in leaves]
        u, delta, a, xd, dv, db = ts
        y = ssp.selective_scan_dirs(u, delta, a, xd[..., 2 : 2 + n],
                                    xd[..., 2 + n :], dv, db, plain=plain)
        grads[plain] = torch.autograd.grad((y * w).sum(), ts)
    for gk, gp in zip(grads[False], grads[True]):
        err = (gk - gp).abs().max().item()
        assert err <= GRAD_RTOL * gp.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d_state", [1, 16])
def test_ss2d_pallas_matches_pallas_plain(cuda, d_state):
    """SS2D through ``scan_backend="pallas"``: one launch of each kernel a
    forward and backward, gradients of every parameter equal to the
    ``pallas_plain`` route's."""
    gen = torch.Generator(cuda).manual_seed(d_state)
    m = SS2D(32, d_state=d_state, scan_backend="pallas", device=cuda)
    init_params(m, gen)
    x = torch.randn(2, 6, 7, 32, device=cuda, generator=gen)
    w = torch.randn(2, 6, 7, 32, device=cuda, generator=gen)
    ssp.reset_launches()
    got = _grads(m, lambda: (m(x) * w).sum())
    torch.cuda.synchronize()
    assert ssp.launches == {"selective_scan_fwd": 1, "selective_scan_bwd": 1}
    set_scan_backend(m, "pallas_plain")
    want = _grads(m, lambda: (m(x) * w).sum())
    assert ssp.launches == {"selective_scan_fwd": 1, "selective_scan_bwd": 1}
    _assert_grads_close(got, want)


@pytest.mark.cuda
def test_tiny_arm_pallas_remat_grads_match_plain(cuda):
    """ARM(remat=True) through ``scan_backend="pallas"``: each layer runs
    the forward kernel twice (the checkpointed forward and its recompute)
    and the backward once; no fused-layer launch."""
    gen = torch.Generator(cuda).manual_seed(4)
    arm = ARM(patch_size=16, embed_dim=64, depth=3, img_size=64,
              remat=True, scan_backend="pallas", device=cuda)
    init_params(arm, gen)
    x = torch.randn(2, 64, 64, 3, device=cuda, generator=gen)
    w = torch.randn(2, 17, 64, device=cuda, generator=gen)
    ssp.reset_launches()
    mf.reset_launches()
    got = _grads(arm, lambda: (arm(x) * w).sum())
    torch.cuda.synchronize()
    assert ssp.launches == {"selective_scan_fwd": 6, "selective_scan_bwd": 3}
    assert mf.launches == dict.fromkeys(mf.launches, 0)
    set_scan_backend(arm, "pallas_plain")
    want = _grads(arm, lambda: (arm(x) * w).sum())
    _assert_grads_close(got, want)


@pytest.mark.cuda
def test_selective_scan_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    u, delta, a, bm, cm, dv, db = _ss_inputs(cuda, torch.float32, 8, 10, 24,
                                             4, 2, False, seed=0)
    with pytest.raises(TypeError, match="not f32/bf16"):
        ssp.selective_scan_fwd(u.half(), delta.half(), a, bm.half(),
                               cm.half(), dv, db)
    with pytest.raises(ValueError, match="delta must match"):
        ssp.selective_scan_fwd(u, delta[:, :5], a, bm, cm, dv, db)
    with pytest.raises(ValueError, match="d_state=3"):
        ssp.selective_scan_fwd(u, delta, a[..., :3].contiguous(),
                               bm[..., :3].contiguous(),
                               cm[..., :3].contiguous(), dv, db)
    with pytest.raises(ValueError, match="unit stride over N"):
        ssp.selective_scan_fwd(u, delta, a, bm.transpose(1, 2).contiguous()
                               .transpose(1, 2), cm, dv, db)
    with pytest.raises(ValueError, match="rows for 3 groups"):
        a3 = torch.cat([a, a[:1]]).contiguous()
        ssp.selective_scan_fwd(u, delta, a3, bm, cm, torch.cat([dv, dv[:1]]),
                               torch.cat([db, db[:1]]))
    with pytest.raises(ValueError, match="dy must match"):
        ssp.selective_scan_bwd(u, delta, a, bm, cm, dv, db, u.bfloat16())


ATTN_CASES = [(2, 16, 4, 16), (2, 100, 3, 32), (4, 197, 12, 64),
              (1, 70, 2, 128), (3, 77, 5, 16), (1, 1401, 2, 32),
              (2, 50, 12, 64), (1, 333, 2, 128)]  # B, L, H, hd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("b,l,h,hd", ATTN_CASES,
                         ids=["hd16", "hd32", "hd64", "hd128", "hd16-ragged",
                              "hd32-L1401", "hd64-L50", "hd128-ragged"])
def test_attention_kernel_matches_plain(cuda, dtype, masked, b, l, h, hd):
    """q, k, v as slices of one (B, L, 3, H, hd) product, read in place; a
    causal mask's rows come out finite."""
    gen = torch.Generator(cuda).manual_seed(l)
    qkv = torch.randn(b, l, 3, h, hd, device=cuda, generator=gen).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    mask = (torch.full((l, l), float("-inf"), device=cuda).triu(1)
            if masked else None)
    before = att.launches["fused_attention"]
    got = att.attention_fwd(q, k, v, mask)
    want = att.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert att.launches["fused_attention"] == before + 1
    assert got.dtype == dtype and got.shape == (b, l, h, hd)
    assert bool(torch.isfinite(got).all())
    err, scale = _err(got, want)
    tol = 2.0**-6 if dtype == torch.bfloat16 else 1e-4
    assert err <= tol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_attention_kernel_takes_rows_off_16_bytes(cuda, dtype):
    """q, k, v slices of a buffer whose token stride is one element past
    a 16-byte multiple: the wrapper copies them and the kernel agrees with
    the plain version."""
    b, l, h, hd = 2, 40, 3, 32
    gen = torch.Generator(cuda).manual_seed(11)
    buf = torch.randn(b, l, 3 * h * hd + 1, device=cuda, generator=gen)
    q, k, v = (buf.to(dtype)[..., i * h * hd + 1:(i + 1) * h * hd + 1]
               .unflatten(-1, (h, hd)) for i in range(3))
    assert q.stride(1) * q.element_size() % 16 != 0
    got = att.attention_fwd(q, k, v)
    want = att.attention_plain(q, k, v)
    torch.cuda.synchronize()
    err, scale = _err(got, want)
    tol = 2.0**-6 if dtype == torch.bfloat16 else 1e-4
    assert err <= tol * scale, (err, scale)


@pytest.mark.cuda
def test_attention_module_launches_only_without_a_gradient(cuda):
    gen = torch.Generator(cuda).manual_seed(5)
    m = vit.Attention(128, 4, device=cuda)
    init_params(m, gen)
    x = torch.randn(3, 40, 128, device=cuda, generator=gen)
    att.reset_launches()
    with torch.no_grad():
        got = m(x)
    assert att.launches["fused_attention"] == 1
    m(x).sum().backward()
    assert att.launches["fused_attention"] == 1
    assert m.qkv.weight.grad is not None
    set_fused(m, False)
    with torch.no_grad():
        want = m(x)
    assert att.launches["fused_attention"] == 1
    err, scale = _err(got, want)
    assert err <= 1e-4 * scale


@pytest.mark.cuda
def test_attention_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.randn(2, 16, 4, 32, device=cuda)
    with pytest.raises(TypeError, match="not f32/bf16"):
        att.attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head width 24"):
        q24 = q[..., :24].contiguous()
        att.attention_fwd(q24, q24, q24)
    with pytest.raises(ValueError, match="mask must be"):
        att.attention_fwd(q, q, q, torch.zeros(16, 15, device=cuda))
    with pytest.raises(ValueError, match="heads and head dims contiguous"):
        att.attention_fwd(q, q.transpose(2, 3).contiguous().transpose(2, 3),
                          q)


def _step_grads(model, loss_fn):
    """The loss and every parameter's gradient, by name."""
    named = dict(model.named_parameters())
    loss = loss_fn()
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.item(), dict(zip(named, grads))


def _micro_step_close(got, want, zero=r"$^"):
    """Loss within 1e-5 relative; each gradient within GRAD_RTOL of its
    tensor's largest, those of 0 in exact arithmetic (``zero``) within
    GRAD_RTOL of the largest gradient."""
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0]), (got[0], want[0])
    largest = max(g.abs().max().item() for g in want[1].values())
    for name, w in want[1].items():
        g = got[1][name]
        assert torch.isfinite(g).all(), name
        if re.search(zero, name):
            assert max(g.abs().max().item(), w.abs().max().item()) <= (
                GRAD_RTOL * largest), name
            continue
        err = (g - w).abs().max().item()
        assert err <= GRAD_RTOL * w.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_emrrg_micro_step_through_kernels_matches_plain(cuda):
    """A small EMRRG (ARM of 64 wide, 3 layers, 64^2 images; a 3-layer
    fp32 LLM of 64 wide with hybrid layers 0 and 2) on 2 studies x 2 views:
    the loss and every gradient through the fused kernels, each of the
    three launched once a layer, against ``scan_backend="plain"``."""
    from medical_image_analysis_tpu_torch.models.emrrg import EMRRG
    from medical_image_analysis_tpu_torch.models.llm import LLMConfig

    gen = torch.Generator(cuda).manual_seed(5)
    cfg = LLMConfig(vocab_size=64, dim=64, n_layers=3, n_heads=4,
                    n_kv_heads=2, hidden_dim=128, dtype=torch.float32)
    model = EMRRG(cfg, arm_kwargs=dict(patch_size=16, embed_dim=64, depth=3,
                                       img_size=64),
                  cross_every=2, device=cuda)
    init_params(model, gen)
    imgs = torch.randn(2, 2, 64, 64, 3, device=cuda, generator=gen)
    ids = [torch.randint(4, 64, (2, n), device=cuda, generator=gen)
           for n in (3, 2, 6)]
    mask = torch.ones(2, 6, device=cuda)
    mask[1, 4:] = 0.0

    def loss_fn():
        return model(imgs, *ids, mask)

    mf.reset_launches()
    got = _step_grads(model, loss_fn)
    torch.cuda.synchronize()
    assert mf.launches == {"mamba_xdbl": 3, "mamba_scan": 3,
                           "mamba_scan_bwd": 3}
    set_scan_backend(model, "plain")
    want = _step_grads(model, loss_fn)
    assert mf.launches["mamba_scan_bwd"] == 3
    _micro_step_close(got, want)


@pytest.mark.cuda
def test_r2gen_pipeline_micro_step_through_vit_kernels_matches_plain(cuda):
    """A small R2GenPipeline (a ViT of 64 wide, 2 blocks of 2 heads at
    64^2; R2Gen of 32, 2 layers, 3 memory slots) on 2 studies x 2 views,
    through the four ViT kernels, each launched once a block, against
    ``set_fused(model, False)``: the averaged patch tokens and the loss
    within 1e-5, and the ViT's gradients, driven by one cotangent at the
    tokens, within GRAD_RTOL. R2Gen is plain PyTorch on both paths, and
    its ReLUs switch on the tokens' rounding gap, so its gradients are not
    compared here."""
    from medical_image_analysis_tpu_torch.models.r2gen import R2GenPipeline
    from medical_image_analysis_tpu_torch.ops import vit_block as vb

    gen = torch.Generator(cuda).manual_seed(6)
    model = R2GenPipeline(
        48, "vit", dict(patch_size=16, embed_dim=64, depth=2, num_heads=2,
                        img_size=64),
        dict(d_model=32, d_ff=48, num_layers=2, num_heads=4, rm_num_slots=3,
             rm_num_heads=4), device=cuda)
    init_params(model, gen)
    imgs = torch.randn(2, 2, 64, 64, 3, device=cuda, generator=gen)
    tgt = torch.randint(3, 48, (2, 7), device=cuda, generator=gen)
    mask = torch.ones(2, 7, device=cuda)
    mask[0, 5:] = 0.0
    vit_named = dict(model.vision.named_parameters())

    set_fused(model, False)
    tokens = model.att_feats(imgs).detach().requires_grad_()
    (cotangent,) = torch.autograd.grad(model.report_loss(tokens, tgt, mask),
                                       tokens)
    got, want = {}, {}
    for fused, out in ((True, got), (False, want)):
        set_fused(model, fused)
        vb.reset_launches()
        feats = model.att_feats(imgs)
        grads = torch.autograd.grad(feats, list(vit_named.values()),
                                    cotangent)
        torch.cuda.synchronize()
        assert vb.launches == dict.fromkeys(vb.launches, 2 if fused else 0)
        out["feats"] = feats.detach()
        out["loss"] = model.report_loss(out["feats"], tgt, mask).item()
        out["grads"] = dict(zip(vit_named, grads))
    feat_err = (got["feats"] - want["feats"]).abs().max().item()
    assert feat_err <= 1e-5 * want["feats"].abs().max().item(), feat_err
    _micro_step_close((got["loss"], got["grads"]),
                      (want["loss"], want["grads"]))


@pytest.mark.cuda
def test_mamba_lm_step_decode_matches_the_kernel_forward(cuda):
    """A Mamba LM of 2 blocks (d_model 64, d_state 16) decoding 12 tokens
    one at a time through ``init_states``/``step`` (plain PyTorch) against
    its full forward through the fused kernels, each launched once a block,
    within 1e-4 of the largest logit, fp32."""
    from medical_image_analysis_tpu_torch.models.mamba_lm import MambaLM

    gen = torch.Generator(cuda).manual_seed(7)
    model = MambaLM(50, d_model=64, depth=2, device=cuda)
    init_params(model, gen)
    ids = torch.randint(1, 50, (3, 12), device=cuda, generator=gen)
    mf.reset_launches()
    with torch.no_grad():
        full = model(ids)
        torch.cuda.synchronize()
        assert mf.launches == {"mamba_xdbl": 2, "mamba_scan": 2,
                               "mamba_scan_bwd": 0}
        states = model.init_states(3)
        steps = []
        for t in range(ids.shape[1]):
            logits, states = model.step(ids[:, t], states)
            steps.append(logits)
    inc = torch.stack(steps, dim=1)
    assert mf.launches["mamba_scan"] == 2  # the step launches no kernel
    err = (inc - full).abs().max().item()
    assert err <= 1e-4 * full.abs().max().item(), err


@pytest.mark.cuda
def test_mac_rrg_encode_img_through_the_swin_kernel_matches_unfused(cuda):
    """A small MAC-RRG (a Swin of 64 wide, 2 stages of heads 2 and 4 at
    112^2; rag and concept rows 24 wide) on 2 studies x 2 views:
    ``encode_img`` through the Swin kernel, launched once a block, against
    ``set_fused(model, False)`` within 1e-4 of the largest value."""
    from medical_image_analysis_tpu_torch.models.llm import LLMConfig
    from medical_image_analysis_tpu_torch.models.mac_rrg import MACRRG
    from medical_image_analysis_tpu_torch.ops import swin_block as sb

    gen = torch.Generator(cuda).manual_seed(8)
    cfg = LLMConfig(vocab_size=64, dim=64, n_layers=1, n_heads=4,
                    n_kv_heads=2, hidden_dim=128, dtype=torch.float32)
    model = MACRRG(cfg, vision_kwargs=dict(embed_dim=64, depths=(2, 2),
                                           num_heads=(2, 4), img_size=112),
                   rag_dim=24, concept_dim=24, device=cuda)
    init_params(model, gen)
    imgs = torch.randn(2, 2, 112, 112, 3, device=cuda, generator=gen)
    rag = torch.randn(2, 5, 24, device=cuda, generator=gen)
    rag[1, 3:] = 0.0
    concept = torch.randn(2, 4, 24, device=cuda, generator=gen)
    out = {}
    for fused in (True, False):
        set_fused(model, fused)
        sb.reset_launches()
        with torch.no_grad():
            out[fused] = model.encode_img(imgs, rag, concept)
        torch.cuda.synchronize()
        assert sb.launches["swin_attn_fwd"] == (4 if fused else 0)
    assert out[True].shape == (2, 196 + 5 + 4, 64)
    err = (out[True] - out[False]).abs().max().item()
    assert err <= 1e-4 * out[False].abs().max().item(), err


# Real checkpoint files: the safetensors reader, QuantDense and the
# on-device preprocessing on the card against their CPU results.

def _write_safetensors(path, tensors):
    """A safetensors file written by hand (the card machine has no
    ``safetensors`` package): header length, JSON header, raw bytes."""
    import json
    import struct

    names = {torch.bfloat16: "BF16", torch.int8: "I8",
             torch.float32: "F32"}
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


@pytest.mark.cuda
def test_safetensors_reader_straight_to_the_card(cuda, tmp_path):
    from medical_image_analysis_tpu_torch.ckpt.safetensors import (
        SafetensorsIndex,
    )

    gen = torch.Generator().manual_seed(0)
    want = {"w_bf16": torch.randn(257, 33, generator=gen).bfloat16(),
            "q_int8": torch.randint(-127, 128, (64, 48), generator=gen,
                                    dtype=torch.int8),
            "s_f32": torch.rand(48, generator=gen)}
    _write_safetensors(tmp_path / "model.safetensors", want)
    sd = SafetensorsIndex(str(tmp_path))
    for name, t in want.items():
        got = sd.tensor(name, cuda)
        assert got.device.type == cuda.type and got.dtype == t.dtype
        assert torch.equal(got.cpu(), t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_dense_on_the_card_matches_cpu(cuda, dtype, monkeypatch):
    """fp32: 1e-5 of the largest output (the sums' order); bf16: one bf16
    step of it. The head's chunks (7 rows a piece here) likewise."""
    from medical_image_analysis_tpu_torch.models import llm

    gen = torch.Generator().manual_seed(1)
    q = llm.QuantDense(96, 200, bias=True, dtype=dtype)
    with torch.no_grad():
        q.kernel_q.copy_(torch.randint(-127, 128, (200, 96), generator=gen))
        q.scale.copy_(torch.rand(200, generator=gen) * 0.01)
        q.bias.copy_(torch.randn(200, generator=gen))
    x = torch.randn(5, 96, generator=gen)
    monkeypatch.setattr(llm, "CHUNK_ELEMS", 96 * 7)
    want = q(x).float()
    got = q.to(cuda)(x.to(cuda)).float().cpu()
    tol = (1e-5 if dtype == torch.float32 else 2.0**-7) * want.abs().max()
    assert (got - want).abs().max() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,size", [((1024, 1024), 224),
                                        ((128, 128), 224)])
def test_device_preprocess_on_the_card_matches_cpu(cuda, shape, size):
    """fp32 on both sides: 1e-4 of the normalised values (the bound of
    the JAX parity test and of chip_smoke's prep_dev)."""
    from medical_image_analysis_tpu_torch.data.preprocessing import (
        device_preprocess,
    )

    raw = torch.randint(0, 256, (4, *shape, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(2))
    want = device_preprocess(raw, size, torch.float32)
    got = device_preprocess(raw.to(cuda), size, torch.float32).cpu()
    assert (got - want).abs().max() <= 1e-4


@pytest.mark.cuda
def test_quantize_on_the_card_is_bit_equal_to_the_host(cuda):
    """``_quantize`` on the card: ``kernel_q`` and ``scale`` bit for bit
    the host's (the JAX package's numpy, by the CPU tests)."""
    from medical_image_analysis_tpu_torch.ckpt.hf_load import _quantize

    gen = torch.Generator().manual_seed(3)
    w = (torch.randn(512, 384, generator=gen)
         * torch.rand(384, generator=gen) * 3).bfloat16().float()
    want = _quantize(w)
    got = _quantize(w.to(cuda))
    assert torch.equal(got["kernel_q"].cpu(), want["kernel_q"])
    assert torch.equal(got["scale"].cpu(), want["scale"])


# --------------------------------------------------------------------------
# The reference's checkpoints and the JAX train states at full width
# --------------------------------------------------------------------------

REF_FILES = ("arm_b", "arm_b_stage1", "vssm1_base", "swin_b_hf",
             "vit_b_timm", "chexbert", "qformer_am_mrg", "hopfield_am_mrg",
             "cross_block_r2genkg", "r2gen")


def _chip_smoke():
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.cuda
@pytest.mark.parametrize("name", REF_FILES)
def test_reference_file_loads_onto_the_card(cuda, tmp_path, name):
    """Each reference layout at its preset's full width (``chip_smoke.py:
    _ref_cases``): written as its released file, read with
    ``weights_only``, mapped and loaded strictly onto the card, every
    tensor equal to the mapped file's; a tower through its kernels within
    1e-3 of its plain version on the card (``TOWER_RTOL``), a head
    finite."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import load_jax_params
    from medical_image_analysis_tpu_torch.ckpt.torch_import import (
        load_torch_state_dict,
    )

    cs = _chip_smoke()
    ref = cs._tests_module("ref_ckpt_files")
    case = {c[0]: c for c in cs._ref_cases()}[name]
    _, make, wrap, mapper, build, inputs, switch, kernels = case
    path = tmp_path / f"{name}.pth"
    ref.save_pth(path, make(np.random.default_rng(0)), wrap)
    tree = mapper(load_torch_state_dict(str(path)))
    model = load_jax_params(build(cuda).eval(), tree)
    equal, total = cs._equal_to_tree(model, tree)
    assert equal == total
    gen = torch.Generator(cuda).manual_seed(0)
    if switch is not None:
        cs._fused_vs_plain(model, inputs(cuda, gen), switch, kernels, name)
    elif inputs is not None:
        with torch.no_grad():
            assert torch.isfinite(model(*inputs(cuda, gen))).all()


@pytest.mark.cuda
def test_jax_layout_state_round_trips_at_full_width(cuda, tmp_path):
    """dp_finetune's ViT-B/16 classifier after one AdamW step on the card:
    its state written in the JAX package's msgpack layout
    (``tests/jax_state_files.py``) and read back by ``restore_train_state``
    equals the port's state, bit for bit (parameters, moments, EMA, count,
    step)."""
    from medical_image_analysis_tpu_torch.ckpt.checkpoint import (
        restore_train_state,
    )
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        flax_named_parameters,
    )
    from medical_image_analysis_tpu_torch.models.classifiers import (
        DPClassifier,
        weighted_bce_loss,
    )
    from medical_image_analysis_tpu_torch.models.vit import VIT_CONFIGS
    from medical_image_analysis_tpu_torch.train.optim import (
        make_adamw,
        warmup_cosine,
    )
    from medical_image_analysis_tpu_torch.train.train_state import (
        TrainState,
        make_train_step,
    )

    cs = _chip_smoke()
    jsf = cs._tests_module("jax_state_files")
    gen = torch.Generator(cuda).manual_seed(0)
    model = DPClassifier(14, vit_kwargs=dict(VIT_CONFIGS["vit_base"],
                                             img_size=224), device=cuda)
    init_params(model, gen)
    params = flax_named_parameters(model)
    state = TrainState(params, make_adamw(params, warmup_cosine(1e-3, 1, 4)),
                       ema=True)
    x = torch.randn(8, 224, 224, 3, device=cuda, generator=gen)
    y = (torch.rand(8, 14, device=cuda, generator=gen) > 0.5).float()
    make_train_step(lambda b: weighted_bce_loss(model(b["x"]), b["y"]),
                    ema_decay=0.999)(state, {"x": x, "y": y})
    saved = cs._state_snapshot(state)
    path = jsf.write_jax_state(str(tmp_path), saved, 3)
    back, epoch = restore_train_state(path)
    assert epoch == 3
    assert cs._same_state(saved, back, "round trip") == 4 * len(params)
