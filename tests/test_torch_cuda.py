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

import numpy as np
import pytest
import torch

from medical_image_analysis_tpu_torch.models.common import init_params
from medical_image_analysis_tpu_torch.models.mamba import ARM, set_scan_backend
from medical_image_analysis_tpu_torch.models.vmamba import SS2D, build_vssm
from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
from medical_image_analysis_tpu_torch.ops import scan_n1 as sn

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
], ids=["k1", "k2", "k4", "k4-noconv", "arm-b"])
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
], ids=["k1", "k2", "k4", "k4-noconv", "arm-b"])
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
]


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,l,d,r", N1_SHAPES,
                         ids=["odd-l", "l1", "r1", "stage2"])
def test_scan_n1_fwd_matches_plain(cuda, dtype, b, l, d, r):
    args = _n1_args(*_n1_inputs(cuda, dtype, b, l, d, r, seed=l + d))
    before = sn.launches["scan_n1_fwd"]
    want = sn.scan_n1_fwd_plain(*args)
    got = sn.scan_n1_fwd(*args)
    torch.cuda.synchronize()
    assert sn.launches["scan_n1_fwd"] == before + 1
    assert got.dtype == dtype and got.shape == (2, b, l, d)
    err, scale = _err(got, want)
    assert err <= Y_RTOL[dtype] * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,l,d,r", N1_SHAPES,
                         ids=["odd-l", "l1", "r1", "stage2"])
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
                         ids=["hd16", "hd32", "enc224", "dec224", "hd128"])
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
                         ids=["hd16", "hd32", "enc224", "dec224", "hd128"])
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


@pytest.mark.cuda
@pytest.mark.parametrize("mask_type", ["random", "region"])
def test_tiny_mae_through_kernels_matches_plain(cuda, mask_type):
    """Each TransformerBlock launches the four kernels once a step; the
    loss and every parameter's gradient agree with the plain versions
    (``set_fused(model, False)``)."""
    from medical_image_analysis_tpu_torch.models.vit import MAE, set_fused
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
    from medical_image_analysis_tpu_torch.models.vit import (
        TransformerBlock,
        set_fused,
    )
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
