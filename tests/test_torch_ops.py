"""PyTorch port ops against the JAX package on CPU (the CUDA kernels
against their plain versions on a card are in test_torch_cuda.py).

Inputs are made with numpy from a seed and fed to both packages. The
JAX fused layer runs in Pallas interpret mode, as its own tests run it
on CPU. Tolerances: fp32 on both sides with the same formulas; the only
differences are summation order and libm ulps, so 1e-5 absolute on O(1)
values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.ops.causal_conv import (
    causal_conv1d as jax_causal_conv1d,
)
from medical_image_analysis_tpu.ops.mamba_fused import (
    mamba_fused_dirs as jax_mamba_fused_dirs,
)
from medical_image_analysis_tpu.ops.selective_scan import (
    selective_scan_ref as jax_selective_scan_ref,
)
from medical_image_analysis_tpu_torch.ops import mamba_fused
from medical_image_analysis_tpu_torch.ops.causal_conv import causal_conv1d
from medical_image_analysis_tpu_torch.ops.selective_scan import (
    selective_scan_ref,
)

ATOL = 1e-5  # fp32 both sides; summation order only


def _rand(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("with_bias", [True, False])
def test_causal_conv1d_matches_jax(with_bias):
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 2, 11, 6), _rand(rng, 4, 6), _rand(rng, 6)
    bias = b if with_bias else None
    want = jax_causal_conv1d(
        jnp.asarray(x), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias),
    )
    got = causal_conv1d(
        torch.from_numpy(x), torch.from_numpy(w),
        None if bias is None else torch.from_numpy(bias),
    )
    _close(got, want)


@pytest.mark.parametrize("groups", [0, 1, 2])
def test_selective_scan_ref_matches_jax(groups):
    """groups 0: (b, L, N) B/C; else (b, L, G, N) shared by D/G channels."""
    rng = np.random.default_rng(1)
    b, l, d, n = 2, 9, 6, 4
    bc_shape = (b, l, n) if groups == 0 else (b, l, groups, n)
    arrays = dict(
        u=_rand(rng, b, l, d), delta=_rand(rng, b, l, d),
        A=-np.exp(_rand(rng, d, n, scale=0.3)),
        B=_rand(rng, *bc_shape), C=_rand(rng, *bc_shape),
        D=_rand(rng, d), delta_bias=_rand(rng, d),
    )
    want, want_h = jax_selective_scan_ref(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        delta_softplus=True, return_last_state=True,
    )
    got, got_h = selective_scan_ref(
        **{k: torch.from_numpy(v) for k, v in arrays.items()},
        delta_softplus=True, return_last_state=True,
    )
    _close(got, want)
    _close(got_h, want_h)


def _fused_inputs(k_dirs, b=2, l=10, d=8, n=4, r=4, taps=4, seed=0):
    """The shapes of tests/test_mamba_fused.py."""
    rng = np.random.default_rng(seed)
    xr = _rand(rng, b, l, d)
    xc = _rand(rng, b, l, d) if k_dirs == 4 else None
    params = dict(
        conv_w=_rand(rng, k_dirs, taps, d), conv_b=_rand(rng, k_dirs, d),
        x_proj_w=_rand(rng, k_dirs, r + 2 * n, d),
        dt_proj_w=_rand(rng, k_dirs, d, r), dt_bias=_rand(rng, k_dirs, d),
        A=-np.exp(_rand(rng, k_dirs, d, n, scale=0.3)),
        D=_rand(rng, k_dirs, d),
    )
    return xr, xc, params


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize(
    "k_dirs,use_conv", [(1, True), (2, True), (4, True), (4, False)]
)
def test_mamba_fused_dirs_plain_matches_jax(k_dirs, use_conv):
    xr, xc, p = _fused_inputs(k_dirs)
    want = jax_mamba_fused_dirs(
        jnp.asarray(xr), None if xc is None else jnp.asarray(xc),
        **{k: jnp.asarray(v) for k, v in p.items()},
        chunk=4, block_d=8, interpret=True, use_conv=use_conv,
    )
    before = dict(mamba_fused.launches)
    got = mamba_fused.mamba_fused_dirs(
        _torch(xr), _torch(xc), **{k: _torch(v) for k, v in p.items()},
        use_conv=use_conv,
    )
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert mamba_fused.launches == before


def test_wrappers_on_cpu_equal_plain_versions():
    xr, xc, p = _fused_inputs(4, seed=3)
    t = {k: _torch(v) for k, v in p.items()}
    xr_t, xc_t = _torch(xr), _torch(xc)
    x_dbl = mamba_fused.xdbl_fwd(xr_t, xc_t, t["conv_w"], t["conv_b"],
                                 t["x_proj_w"])
    assert torch.equal(x_dbl, mamba_fused.xdbl_plain(
        xr_t, xc_t, t["conv_w"], t["conv_b"], t["x_proj_w"]))
    args = (xr_t, xc_t, x_dbl, t["conv_w"], t["conv_b"], t["dt_proj_w"],
            t["dt_bias"], t["A"], t["D"])
    assert torch.equal(mamba_fused.scan_fwd(*args),
                       mamba_fused.scan_plain(*args))


def test_wrappers_refuse_other_devices():
    """No silent path: a tensor that is neither CPU nor CUDA raises."""
    xr = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mamba_fused.xdbl_fwd(xr, None, torch.empty(1, 4, 8),
                             torch.empty(1, 8), torch.empty(1, 12, 8))
