"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Without a card every test here skips. On a machine with one (JAX is not
needed there, so ``tests/conftest.py`` is left out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances, relative to max(1, max |plain|): x_dbl is fp32 from identical
inputs, so only the order of the sum over D differs (1e-4). y from fp32
sources likewise (1e-4); from bf16 sources both sides compute in fp32 and
round once to bf16, where they may land one bf16 step (2^-8) apart (1e-2).
"""

import numpy as np
import pytest
import torch

from medical_image_analysis_tpu_torch.models.common import init_params
from medical_image_analysis_tpu_torch.models.mamba import ARM, set_scan_backend
from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

Y_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


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
        assert mf.launches == {"mamba_xdbl": 3, "mamba_scan": 3}
        set_scan_backend(arm, "plain")
        want = arm(x)
    assert mf.launches == {"mamba_xdbl": 3, "mamba_scan": 3}
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
