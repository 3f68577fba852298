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


def _chunked_carries(dt, bx, cdy, A, chunk):
    """The backward kernels' algorithm on scan-order numpy arrays: dt (B,
    K, L, D), the input terms dt u B and C dy (B, K, L, D, N), A (K, D,
    N). Per chunk of ``chunk`` scan rows (the last one ragged): S, the sum
    of dt; H, the end state from a zero state; G, the sum over its rows of
    the decays up to and including the row times C dy. Then the chunks
    composed with the decays exp(A S) per state, in scan order for the
    state entering each (h = P h + H) and in reverse for the adjoint
    entering its last row (g = P g + G). Returns (h_in, g_in), each (B*K,
    nchunks, N, D)."""
    b, k, seq_len, d, n = bx.shape
    summaries = []
    for t0 in range(0, seq_len, chunk):
        s_dt = np.zeros((b, k, d))
        p = np.ones((b, k, d, n))
        h = np.zeros((b, k, d, n))
        g = np.zeros((b, k, d, n))
        for t in range(t0, min(t0 + chunk, seq_len)):
            a = np.exp(dt[:, :, t, :, None] * A[None])
            s_dt = s_dt + dt[:, :, t]
            p = p * a
            h = a * h + bx[:, :, t]
            g = g + p * cdy[:, :, t]
        summaries.append((np.exp(A[None] * s_dt[..., None]), h, g))
    h_in, g_in = [], []
    h = g = np.zeros((b, k, d, n))
    for decay, end, _ in summaries:
        h_in.append(h)
        h = decay * h + end
    for decay, _, adj in summaries[::-1]:
        g_in.append(g)
        g = decay * g + adj
    return tuple(np.stack(x, axis=2).transpose(0, 1, 2, 4, 3).reshape(
        b * k, len(summaries), n, d) for x in (h_in, g_in[::-1]))


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("use_conv", [True, False], ids=["conv", "noconv"])
@pytest.mark.parametrize("l,chunk", [(70, 32), (33, 8)])
def test_mamba_chunked_carries_match_the_walk(l, chunk, use_conv, n):
    """The chunk summaries composed as the backward's kernels compose them
    (decays exp(A S) per state) give the state entering every chunk and
    the adjoint entering its last row of the sequential walks
    (``mamba_carries_plain``), at K=4 with its reversed directions and a
    ragged last chunk, within 1e-5 of max(1, max |walk|); on the CPU
    ``scan_bwd_carries`` is that walk."""
    xr, xc, p = _fused_inputs(4, b=2, l=l, d=8, n=n, r=4, seed=l + n)
    t = {k: _torch(v) for k, v in p.items()}
    xr_t, xc_t = _torch(xr), _torch(xc)
    x_dbl = mamba_fused.xdbl_plain(xr_t, xc_t, t["conv_w"], t["conv_b"],
                                   t["x_proj_w"], use_conv)
    dy = torch.from_numpy(_rand(np.random.default_rng(l), 2, 4, l, 8))
    args = (xr_t, xc_t, x_dbl, t["conv_w"], t["conv_b"], t["dt_proj_w"],
            t["dt_bias"], t["A"], t["D"], dy, True, use_conv)
    want = mamba_fused.mamba_carries_plain(*args, chunk=chunk)
    u, _, dt, _, _, bmat, cmat, dys = mamba_fused._bwd_rows(
        *args[:8], dy, True, use_conv)
    got = _chunked_carries(
        dt.double().numpy(),
        ((dt * u)[..., None] * bmat[:, :, :, None, :]).double().numpy(),
        (cmat[:, :, :, None, :] * dys[..., None]).double().numpy(),
        t["A"].double().numpy(), chunk)
    for name, g, w in zip(("h_in", "g_in"), got, want):
        assert g.shape == tuple(w.shape) == (8, -(-l // chunk), n, 8), name
        scale = max(1.0, w.abs().max().item())
        assert np.abs(g - w.double().numpy()).max() <= 1e-5 * scale, name
    for g, w in zip(mamba_fused.scan_bwd_carries(*args),
                    mamba_fused.mamba_carries_plain(*args)):
        assert torch.equal(g, w)


def _chunked_forward(dt, dtu, bmat, cmat, u, dskip, A, chunk):
    """The forward kernels' algorithm on scan-order numpy arrays: dt, dt u
    and u (B, K, L, D), B and C (B, K, L, N), D (K, D), A (K, D, N). Per
    chunk of ``chunk`` scan rows (the last one ragged): S, the sum of dt,
    and H, the end state from a zero state. Then the chunks composed in
    scan order with the decays exp(A S) per state for the state entering
    each (h = exp(A S) h + H), and every chunk walked again from it for y =
    C.h + D u. Returns y (B, K, L, D) in scan order."""
    b, k, seq_len, d = dt.shape
    starts = range(0, seq_len, chunk)

    def walk(h, t0):
        ys = []
        for t in range(t0, min(t0 + chunk, seq_len)):
            h = (np.exp(dt[:, :, t, :, None] * A[None]) * h
                 + dtu[:, :, t, :, None] * bmat[:, :, t, None, :])
            ys.append(np.sum(cmat[:, :, t, None, :] * h, axis=-1))
        return h, ys

    h = np.zeros((b, k, d, A.shape[-1]))
    entering = []
    for t0 in starts:
        entering.append(h)
        s_dt = dt[:, :, t0 : t0 + chunk].sum(axis=2)
        end, _ = walk(np.zeros_like(h), t0)
        h = np.exp(A[None] * s_dt[..., None]) * h + end
    ys = [y for t0, h0 in zip(starts, entering) for y in walk(h0, t0)[1]]
    return np.stack(ys, axis=2) + u * dskip[None, :, None, :]


def _chunked_forward_y(xr_t, xc_t, x_dbl, t, use_conv, chunk):
    """``_chunked_forward`` on the port's per-row terms, in source order."""
    k_dirs, d_in = t["A"].shape[:2]
    b, seq_len = xr_t.shape[:2]
    dy = torch.zeros(b, k_dirs, seq_len, d_in)
    u, _, dt, _, _, bmat, cmat, _ = mamba_fused._bwd_rows(
        xr_t, xc_t, x_dbl, t["conv_w"], t["conv_b"], t["dt_proj_w"],
        t["dt_bias"], t["A"], dy, True, use_conv)
    y = _chunked_forward(*(a.double().numpy() for a in (
        dt, dt * u, bmat, cmat, u, t["D"], t["A"])), chunk)
    return mamba_fused._flip_reversed(torch.from_numpy(y)).numpy()


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("use_conv", [True, False], ids=["conv", "noconv"])
@pytest.mark.parametrize("l,chunk", [(70, 8), (70, 32), (70, 70), (33, 8),
                                     (33, 32), (33, 33)])
def test_mamba_chunked_forward_matches_the_walk(l, chunk, use_conv, n):
    """The chunked forward (summaries from a zero state, carries by exp(A
    S), y walked from each chunk's entering state) gives ``scan_plain``'s
    y, at K=4 with its reversed directions and a ragged last chunk, within
    1e-5 of max(1, max |y|); a chunk of L is the single pass from zero."""
    xr, xc, p = _fused_inputs(4, b=2, l=l, d=8, n=n, r=4, seed=l + n + chunk)
    t = {k: _torch(v) for k, v in p.items()}
    xr_t, xc_t = _torch(xr), _torch(xc)
    x_dbl = mamba_fused.xdbl_plain(xr_t, xc_t, t["conv_w"], t["conv_b"],
                                   t["x_proj_w"], use_conv)
    want = mamba_fused.scan_plain(
        xr_t, xc_t, x_dbl, t["conv_w"], t["conv_b"], t["dt_proj_w"],
        t["dt_bias"], t["A"], t["D"], True, use_conv).double().numpy()
    got = _chunked_forward_y(xr_t, xc_t, x_dbl, t, use_conv, chunk)
    assert got.shape == want.shape == (2, 4, l, 8)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_mamba_chunked_forward_matches_jax():
    """The same model against the JAX package's ``mamba_fused_dirs``
    forward (Pallas in interpret mode, its 4-row chunks), chunks of 8 over
    a ragged L with the conv, within 1e-5 of max(1, max |y|)."""
    xr, xc, p = _fused_inputs(4, b=2, l=21, d=8, n=4, r=4, seed=11)
    want = np.asarray(jax_mamba_fused_dirs(
        jnp.asarray(xr), jnp.asarray(xc),
        **{k: jnp.asarray(v) for k, v in p.items()},
        chunk=4, block_d=8, interpret=True, use_conv=True,
    ))
    t = {k: _torch(v) for k, v in p.items()}
    xr_t, xc_t = _torch(xr), _torch(xc)
    x_dbl = mamba_fused.xdbl_plain(xr_t, xc_t, t["conv_w"], t["conv_b"],
                                   t["x_proj_w"])
    got = _chunked_forward_y(xr_t, xc_t, x_dbl, t, True, 8)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_wrappers_refuse_other_devices():
    """No silent path: a tensor that is neither CPU nor CUDA raises."""
    xr = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mamba_fused.xdbl_fwd(xr, None, torch.empty(1, 4, 8),
                             torch.empty(1, 8), torch.empty(1, 12, 8))
