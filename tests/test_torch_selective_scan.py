"""The port's general selective scan against the JAX package on CPU.

The same numpy inputs go through the JAX function, its Pallas kernels in
interpret mode (jitted), and the port's wrappers, which run the kernels'
plain versions on CPU tensors. Tolerances:

- fp32 forward: both sides compute the same fp32 recurrence; only the
  order of the sums and libm ulps differ: 1e-5 of max(1, max |y|).
- bf16 sources: both sides read the same bf16 values, run the recurrence
  in fp32 and round y to bf16 once, where they may land one bf16 step
  apart: 2^-7 of max(1, max |y|).
- gradients: fp32 on both sides from the same inputs, sums in another
  order: 1e-4 of each tensor's largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.ops import selective_scan_pallas as jss
from medical_image_analysis_tpu_torch.ops import selective_scan as ss
from medical_image_analysis_tpu_torch.ops import selective_scan_pallas as ssp

Y_RTOL = {"fp32": 1e-5, "bf16": 2.0**-7}
GRAD_RTOL = 1e-4
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")


def _inputs(case, seed, batch=2, seq_len=12, d=8, n=4, k=4):
    """fp32 numpy inputs of ``case``: "plain" (B/C (batch, L, N)),
    "grouped" (G=4: (batch, L, 4, N)) or "dirs" (K directions)."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if case == "dirs":
        seq, par, bc = (batch, k, seq_len, d), (k, d), (batch, k, seq_len, n)
        a_shape = (k, d, n)
    else:
        seq, par, a_shape = (batch, seq_len, d), (d,), (d, n)
        bc = (batch, seq_len, n) if case == "plain" else (batch, seq_len, 4, n)
    return dict(u=t(*seq), delta=t(*seq, scale=0.5),
                A=-np.exp(t(*a_shape, scale=0.3)), B=t(*bc), C=t(*bc),
                D=t(*par), delta_bias=t(*par, scale=0.2))


def _jax_fn(case):
    fn = jss.selective_scan_dirs if case == "dirs" else jss.selective_scan_pallas
    return jax.jit(lambda u, delta, A, B, C, D, db, softplus: fn(
        u, delta, A, B, C, D, db, softplus, chunk=8, block_d=8,
        interpret=True), static_argnums=7)


def _port_fn(case):
    return ssp.selective_scan_dirs if case == "dirs" else ssp.selective_scan_pallas


def _err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max(), max(1.0, np.abs(want).max())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("extras", [True, False], ids=["d-bias-softplus",
                                                       "bare"])
@pytest.mark.parametrize("case", ["plain", "grouped", "dirs"])
def test_forward_matches_jax_kernel(case, extras, dtype):
    x = _inputs(case, seed=len(case) + extras)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    for name in ("u", "delta", "B", "C"):
        jx[name] = jx[name].astype(JNP[dtype])
        tx[name] = tx[name].to(TORCH[dtype])
    if not extras:
        for name in ("D", "delta_bias"):
            jx[name] = tx[name] = None
    want = _jax_fn(case)(*jx.values(), extras)
    got = _port_fn(case)(*tx.values(), delta_softplus=extras)
    assert got.dtype == TORCH[dtype]
    err, scale = _err(got.float(), want)
    assert err <= Y_RTOL[dtype] * scale, (err, scale)


def test_grads_match_jax_vjp():
    """All seven gradients of the K-direction scan (batch 2, K 2, L 16,
    D 8, N 4) against ``jax.vjp`` of the JAX function in interpret mode
    (its custom VJP, the Pallas ``_bwd_kernel``, chunk 8, block_d 8)."""
    x = _inputs("dirs", seed=7, seq_len=16, k=2)
    dy = np.random.default_rng(8).standard_normal(x["u"].shape).astype(
        np.float32)

    @jax.jit
    def jax_vjp(*args):
        _, pull = jax.vjp(lambda *a: jss.selective_scan_dirs(
            *a, True, chunk=8, block_d=8, interpret=True), *args)
        return pull(jnp.asarray(dy))

    want = jax_vjp(*(jnp.asarray(v) for v in x.values()))
    leaves = [torch.tensor(v, requires_grad=True) for v in x.values()]
    y = ssp.selective_scan_dirs(*leaves, delta_softplus=True)
    y.backward(torch.from_numpy(dy))
    for name, leaf, w in zip(NAMES, leaves, want):
        w = np.asarray(w)
        err = np.abs(leaf.grad.numpy() - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("softplus", [True, False])
def test_bwd_plain_matches_autograd_of_fwd_plain(softplus):
    """The explicit adjoint on the folded layout (6 rows of 3 groups, 21
    steps: the chunked rebuild crosses a chunk edge) against autograd
    through ``selective_scan_fwd_plain``."""
    rng = np.random.default_rng(9)
    rows, seq_len, d, n, g = 6, 21, 8, 4, 3

    def t(*shape, scale=1.0):
        return torch.tensor((rng.standard_normal(shape) * scale).astype(
            np.float32), requires_grad=True)

    leaves = [t(rows, seq_len, d), t(rows, seq_len, d, scale=0.5),
              (-torch.exp(t(g, d, n, scale=0.3))).detach().requires_grad_(),
              t(rows, seq_len, n), t(rows, seq_len, n), t(g, d),
              t(g, d, scale=0.2)]
    dy = torch.from_numpy(rng.standard_normal((rows, seq_len, d)).astype(
        np.float32))
    y = ss.selective_scan_fwd_plain(*leaves, delta_softplus=softplus)
    want = torch.autograd.grad(y, leaves, dy)
    old = ss.BWD_CHUNK
    ss.BWD_CHUNK = 8
    try:
        with torch.no_grad():
            got = ss.selective_scan_bwd_plain(
                *(v.detach() for v in leaves), dy, delta_softplus=softplus)
    finally:
        ss.BWD_CHUNK = old
    for name, g_, w in zip(NAMES, got, want):
        assert g_.shape == w.shape and g_.dtype == w.dtype, name
        err = (g_ - w).abs().max().item()
        assert err <= GRAD_RTOL * w.abs().max().item(), (name, err)


def test_dispatcher_on_cpu():
    """``auto`` on a CPU tensor is ``selective_scan_ref``; ``pallas`` the
    kernels' route (their plain versions here)."""
    x = {k: torch.from_numpy(v) for k, v in _inputs("grouped", 3).items()}
    ref = ss.selective_scan_ref(*x.values(), delta_softplus=True)
    auto = ss.selective_scan(*x.values(), delta_softplus=True)
    torch.testing.assert_close(auto, ref, rtol=0, atol=0)
    pallas = ss.selective_scan(*x.values(), delta_softplus=True,
                               backend="pallas")
    err, scale = _err(pallas, ref)
    assert err <= Y_RTOL["fp32"] * scale
    with pytest.raises(ValueError, match="unknown backend"):
        ss.selective_scan(*x.values(), backend="fused")


def test_work_counts():
    """Operations per (row, step, channel) at d_state 16: 117 a forward;
    329 a backward, one rebuild of the states (83) and the adjoint (246),
    not the kernel's second walk; linear in rows, steps and channels."""
    assert ssp.flops("fwd", 1, 1, 1, 16) == 117
    assert ssp.flops("bwd", 1, 1, 1, 16) == 329
    assert ssp.flops("bwd", 512, 3136, 192, 16) == 512 * 3136 * 192 * 329


# --------------------------------------------------------------------------
# The forward at the edges of the kernel's tiles (csrc/selective_scan.cu,
# "the forward": 4 rows staged at once, 64 channels a block)
# --------------------------------------------------------------------------


def _walk64(u, delta, A, B, C, D, delta_bias, softplus):
    """The S6 recurrence in float64 numpy on the folded layout (u, delta
    (rows, L, Dc); B, C (rows, L, N); A (G, Dc, N); D, delta_bias (G, Dc);
    row r takes group r % G), one step at a time from a zero state.
    Returns y (rows, L, Dc)."""
    u, delta, A, B, C, D, delta_bias = (np.asarray(x, np.float64) for x in (
        u, delta, A, B, C, D, delta_bias))
    grp = np.arange(u.shape[0]) % A.shape[0]
    a = A[grp]
    dt = delta + delta_bias[grp][:, None, :]
    if softplus:
        dt = np.logaddexp(dt, 0.0)
    h = np.zeros(a.shape)
    ys = []
    for t in range(u.shape[1]):
        h = (np.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :])
        ys.append(np.sum(C[:, t, None, :] * h, axis=-1))
    return np.stack(ys, axis=1) + u * D[grp][:, None, :]


# (rows, L, Dc, N, G): a ragged last tile; a last tile of one row; L
# shorter than a tile; L = 1; Dc not a multiple of 64 (the kernel's channel
# block) nor of 4 (its 16-byte staging) with G > 1; d_state 1 and 16.
EDGE_CASES = [(2, 21, 8, 4, 1), (2, 17, 8, 4, 1), (2, 3, 8, 4, 1),
              (2, 1, 8, 4, 1), (6, 19, 70, 4, 3), (4, 21, 8, 1, 2),
              (4, 21, 8, 16, 2)]
EDGE_IDS = ["ragged", "one-row-last", "short", "l1", "d70-g3", "n1", "n16"]


@pytest.mark.parametrize("rows,l,d,n,g", EDGE_CASES, ids=EDGE_IDS)
def test_forward_at_the_tile_edges_matches_jax(rows, l, d, n, g):
    """The port's ``selective_scan_fwd`` on the folded layout (its plain
    version on the CPU) and the JAX ``_fwd_kernel`` (``selective_scan_dirs``
    with K = G, in interpret mode, jitted) against a float64 walk, within
    1e-5 of max(1, max |y|)."""
    rng = np.random.default_rng(rows * l + d + n)

    def t(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = dict(u=t(rows, l, d), delta=t(rows, l, d, scale=0.5),
             A=-np.exp(t(g, d, n, scale=0.3)), B=t(rows, l, n),
             C=t(rows, l, n), D=t(g, d), delta_bias=t(g, d, scale=0.2))
    want = _walk64(*x.values(), True)
    port = ssp.selective_scan_fwd(
        *(torch.from_numpy(v) for v in x.values()), delta_softplus=True)
    batch = rows // g

    def dirs(v):  # (rows, ...) -> (batch, G, ...)
        return jnp.asarray(v.reshape(batch, g, *v.shape[1:]))

    jfn = jax.jit(lambda *a: jss.selective_scan_dirs(
        *a, True, chunk=8, block_d=8, interpret=True))
    jax_y = np.asarray(jfn(dirs(x["u"]), dirs(x["delta"]),
                           jnp.asarray(x["A"]), dirs(x["B"]), dirs(x["C"]),
                           jnp.asarray(x["D"]),
                           jnp.asarray(x["delta_bias"]))).reshape(rows, l, d)
    assert port.shape == jax_y.shape == want.shape == (rows, l, d)
    for got in (port.double().numpy(), jax_y):
        err, scale = _err(got, want)
        assert err <= 1e-5 * scale, (err, scale)


def test_fwd_grid_blocks():
    """A block of the forward kernel holds 64 channels of one row: ARM-B's
    layers at 6 images (24 rows, D 768) make 288 blocks, vssm_tiny's stage
    0 at B=128 (512 rows, D 192) 1,536, D = 70 two blocks a row."""
    assert ssp.fwd_grid_blocks(24, 768) == 288
    assert ssp.fwd_grid_blocks(512, 192) == 1536
    assert ssp.fwd_grid_blocks(6, 70) == 12


WIDTHS = (2, 5, 12, 17, 32, 40, 64)


def _launch_as_plain(monkeypatch):
    """Route the CUDA wrappers' launches to the plain versions on the CPU,
    checking that every launch is at a built width: the padding and the
    state groups run as they do on the card."""
    seen = []

    def fwd(u, delta, A, B, C, D, db, sp):
        assert A.shape[-1] in ssp.STATES and B.shape[-1] == A.shape[-1]
        seen.append(A.shape[-1])
        return ss.selective_scan_fwd_plain(u, delta, A, B, C, D, db, sp)

    def bwd(u, delta, A, B, C, D, db, dy, sp):
        assert A.shape[-1] in ssp.STATES and C.shape[-1] == A.shape[-1]
        seen.append(A.shape[-1])
        return ss.selective_scan_bwd_plain(u, delta, A, B, C, D, db, dy, sp)

    monkeypatch.setattr(ssp, "_on_cpu", lambda u: False)
    monkeypatch.setattr(ssp, "_fwd_launch", fwd)
    monkeypatch.setattr(ssp, "_bwd_launch", bwd)
    return seen


@pytest.mark.parametrize("n", WIDTHS)
def test_every_d_state_matches_jax(monkeypatch, n):
    """The K-direction scan at d_state ``n`` through the wrappers' padding
    and state groups (launches at the built widths, run by the plain
    versions here) against JAX ``selective_scan_dirs`` in interpret mode:
    y and all seven gradients (batch 2, K 2, L 12, D 8)."""
    x = _inputs("dirs", seed=n, n=n, k=2)
    dy = np.random.default_rng(n + 1).standard_normal(x["u"].shape).astype(
        np.float32)

    @jax.jit
    def jax_vjp(*args):
        y, pull = jax.vjp(lambda *a: jss.selective_scan_dirs(
            *a, True, chunk=8, block_d=8, interpret=True), *args)
        return y, pull(jnp.asarray(dy))

    y_want, g_want = jax_vjp(*(jnp.asarray(v) for v in x.values()))
    seen = _launch_as_plain(monkeypatch)
    leaves = [torch.tensor(v, requires_grad=True) for v in x.values()]
    y = ssp.selective_scan_dirs(*leaves, delta_softplus=True)
    y.backward(torch.from_numpy(dy))
    want_launches = 2 * len(ssp.state_groups(n))
    assert len(seen) == want_launches
    assert all(w == ssp.state_width(min(n - s0, 32))
               for w, s0 in zip(seen, [s for s, _ in ssp.state_groups(n)] * 2))
    err, scale = _err(y.detach(), y_want)
    assert err <= Y_RTOL["fp32"] * scale, (err, scale)
    for name, leaf, w in zip(NAMES, leaves, g_want):
        w = np.asarray(w)
        assert leaf.grad.shape == w.shape, name
        err = np.abs(leaf.grad.numpy() - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("n", (5, 40))
def test_every_d_state_bf16_forward(monkeypatch, n):
    """bf16 sources at a padded (5) and a grouped (40) d_state: y against
    the JAX kernel within the bf16 bound (the groups run in fp32, their y
    added and rounded once)."""
    x = _inputs("dirs", seed=3 * n, n=n, k=2)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    for name in ("u", "delta", "B", "C"):
        jx[name] = jx[name].astype(jnp.bfloat16)
        tx[name] = tx[name].to(torch.bfloat16)
    want = _jax_fn("dirs")(*jx.values(), True)
    _launch_as_plain(monkeypatch)
    got = ssp.selective_scan_dirs(*tx.values(), delta_softplus=True)
    assert got.dtype == torch.bfloat16
    err, scale = _err(got.float(), want)
    assert err <= Y_RTOL["bf16"] * scale, (err, scale)


def test_state_groups():
    assert ssp.state_groups(40) == [(0, 32), (32, 40)]
    assert ssp.state_groups(64) == [(0, 32), (32, 64)]
    assert ssp.state_groups(17) == [(0, 17)]
    assert [ssp.state_width(k) for k in (1, 2, 5, 12, 17, 32)] == [
        1, 4, 8, 16, 32, 32]


@pytest.mark.parametrize("n,taps", [(40, 4), (12, 5), (40, 5)],
                         ids=["n40", "taps5", "n40-taps5"])
def test_fused_layer_past_the_kernel_widths_matches_jax(monkeypatch, n, taps):
    """The fused Mamba layer past 32 states and past 4 taps (K = 4, B 2,
    L 10, D 8, R 3) against the JAX ``mamba_fused_dirs`` in interpret mode:
    y within 1e-5 of max(1, max |y|), every gradient within 1e-4 of its
    largest. Each launch of the pieces stays within the kernels' widths
    (at most 32 states and 4 taps; a wider conv runs in PyTorch first)."""
    from medical_image_analysis_tpu.ops.mamba_fused import (
        mamba_fused_dirs as jax_mamba_fused_dirs)
    from medical_image_analysis_tpu_torch.ops import mamba_fused

    k_dirs, b, l, d, r = 4, 2, 10, 8, 3
    rng = np.random.default_rng(n + taps)

    def rand(*shape, scale=0.5):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    xr, xc = rand(b, l, d), rand(b, l, d)
    p = dict(conv_w=rand(k_dirs, taps, d), conv_b=rand(k_dirs, d),
             x_proj_w=rand(k_dirs, r + 2 * n, d), dt_proj_w=rand(k_dirs, d, r),
             dt_bias=rand(k_dirs, d),
             A=-np.exp(rand(k_dirs, d, n, scale=0.3)), D=rand(k_dirs, d))
    cot = rand(b, k_dirs, l, d, scale=1.0)

    def objective(*args):
        y = jax_mamba_fused_dirs(*args, chunk=4, block_d=8, interpret=True)
        return jnp.sum(y * cot), y

    (_, want), grads = jax.jit(jax.value_and_grad(
        objective, argnums=tuple(range(9)), has_aux=True))(
        jnp.asarray(xr), jnp.asarray(xc), *map(jnp.asarray, p.values()))

    seen = []
    xdbl_fwd, scan_fwd = mamba_fused.xdbl_fwd, mamba_fused.scan_fwd

    def spy_xdbl(xr_, xc_, conv_w, conv_b, x_proj_w, use_conv=True):
        assert conv_w.shape[1] <= mamba_fused._MAX_TAPS or not use_conv
        return xdbl_fwd(xr_, xc_, conv_w, conv_b, x_proj_w, use_conv)

    def spy_scan(*args, **kw):
        seen.append(args[7].shape[-1])
        assert args[7].shape[-1] <= mamba_fused._MAX_STATE
        return scan_fwd(*args, **kw)

    monkeypatch.setattr(mamba_fused, "xdbl_fwd", spy_xdbl)
    monkeypatch.setattr(mamba_fused, "scan_fwd", spy_scan)
    t = [torch.from_numpy(a).requires_grad_() for a in (xr, xc, *p.values())]
    got = mamba_fused.mamba_fused_dirs(*t)
    groups = len(mamba_fused.state_groups(n))
    assert len(seen) == groups * (k_dirs if taps > 4 else 1)
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err
    (got * torch.from_numpy(cot)).sum().backward()
    for name, tt, g in zip(["xr", "xc", *p], t, grads):
        g = np.asarray(g)
        assert tt.grad.shape == g.shape, name
        err = float(np.abs(tt.grad.numpy() - g).max())
        assert err <= 1e-4 * float(np.abs(g).max()), (name, err)
