"""The port's VMamba path against the JAX package on CPU, at tiny sizes.

The same numpy inputs go through the JAX function and its port. Where the
JAX function reaches a Pallas kernel (``scan_n1_sources``, and the general
scan of ``scan_backend="pallas"``), it runs in interpret mode; the port
runs its plain versions (CPU tensors).
Tolerances, all fp32 on both sides with the same formulas, so only the
order of sums and libm ulps differ: the scan within 1e-5 of
max(1, max |y|); gradients within 1e-4 of each tensor's largest gradient;
modules 1e-5 per layer and 1e-4 through the four stages of a VSSM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.models import vmamba as jax_vmamba
from medical_image_analysis_tpu.ops import cross_scan as jax_cross_scan
from medical_image_analysis_tpu.ops import scan_n1 as jax_scan_n1
from medical_image_analysis_tpu.ops.selective_scan import (
    selective_scan_ref as jax_selective_scan_ref,
)
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    load_jax_params,
    state_dict_from_jax,
)
from medical_image_analysis_tpu_torch.models import vmamba
from medical_image_analysis_tpu_torch.ops import cross_scan, scan_n1

SCAN_RTOL = 1e-5
GRAD_RTOL = 1e-4
LAYER_ATOL = 1e-5
STAGES_ATOL = 1e-4
WEIGHTS = ("x_proj_w", "dt_proj_w", "dt_bias", "A", "D")


def _rand(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _scan_inputs(b, l, d, r, seed):
    rng = np.random.default_rng(seed)
    xr, xc = _rand(rng, b, l, d), _rand(rng, b, l, d)
    p = dict(x_proj_w=_rand(rng, 4, r + 2, d), dt_proj_w=_rand(rng, 4, d, r),
             dt_bias=_rand(rng, 4, d, scale=0.2),
             A=-np.exp(_rand(rng, 4, d, 1, scale=0.3)), D=_rand(rng, 4, d))
    w = (_rand(rng, b, l, d, scale=1.0), _rand(rng, b, l, d, scale=1.0))
    return xr, xc, p, w


def _oracle(xr, xc, p):
    """Per direction, x_proj/dt_proj in jnp and the JAX ``selective_scan_ref``
    (the oracle of ``tests/test_scan_n1.py``): (B, 4, L, D)."""
    rank = p["dt_proj_w"].shape[-1]
    ys = []
    for k, (src, rev) in enumerate(((xr, False), (xc, False), (xr, True),
                                    (xc, True))):
        u = jnp.flip(src, 1) if rev else src
        x_dbl = jnp.einsum("bld,cd->blc", u, p["x_proj_w"][k])
        dt = jnp.einsum("blr,dr->bld", x_dbl[..., :rank], p["dt_proj_w"][k])
        y = jax_selective_scan_ref(
            u, dt, p["A"][k], x_dbl[..., rank : rank + 1],
            x_dbl[..., rank + 1 :], p["D"][k], p["dt_bias"][k],
            delta_softplus=True)
        ys.append(jnp.flip(y, 1) if rev else y)
    return jnp.stack(ys, axis=1)


def _assert_close(got, want, rtol, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    scale = max(1.0, np.abs(want).max())
    assert err <= rtol * scale, (name, err, scale)


def _assert_grad_close(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= GRAD_RTOL * scale, name


@pytest.mark.parametrize("b,l,d,r", [(4, 33, 24, 3), (5, 1, 16, 1)])
def test_scan_n1_sources_matches_jax_and_oracle(b, l, d, r):
    xr, xc, p, _ = _scan_inputs(b, l, d, r, seed=l)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = jax_scan_n1.scan_n1_sources(jnp.asarray(xr), jnp.asarray(xc),
                                       **jp, interpret=True)
    oracle = _oracle(jnp.asarray(xr), jnp.asarray(xc), jp)
    got = scan_n1.scan_n1_sources(
        torch.from_numpy(xr), torch.from_numpy(xc),
        **{k: torch.from_numpy(v) for k, v in p.items()})
    for s in range(2):
        _assert_close(got[s], want[s], SCAN_RTOL, f"vs jax, source {s}")
        _assert_close(got[s], oracle[:, s] + oracle[:, s + 2], SCAN_RTOL,
                      f"vs oracle, source {s}")
    dirs = scan_n1.scan_n1_dirs(
        torch.from_numpy(xr), torch.from_numpy(xc),
        **{k: torch.from_numpy(v) for k, v in p.items()})
    _assert_close(dirs, oracle, SCAN_RTOL, "scan_n1_dirs")


def test_scan_n1_grads_match_jax():
    """Gradients of xr, xc and every weight against ``jax.grad`` of the
    JAX ``scan_n1_sources`` in interpret mode (its custom VJP, the Pallas
    ``_bwd_kernel``)."""
    xr, xc, p, (wr, wc) = _scan_inputs(5, 21, 16, 3, seed=6)

    def jax_loss(xr_, xc_, pp):
        y_row, y_col = jax_scan_n1.scan_n1_sources(xr_, xc_, **pp,
                                                   interpret=True)
        return jnp.sum(y_row * wr) + jnp.sum(y_col * wc)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(xr), jnp.asarray(xc),
        {k: jnp.asarray(v) for k, v in p.items()})
    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in dict(xr=xr, xc=xc, **p).items()}
    y_row, y_col = scan_n1.scan_n1_sources(**leaves)
    assert y_row.grad_fn is not None
    ((y_row * torch.from_numpy(wr)).sum()
     + (y_col * torch.from_numpy(wc)).sum()).backward()
    _assert_grad_close("xr", leaves["xr"].grad, want[0])
    _assert_grad_close("xc", leaves["xc"].grad, want[1])
    for k in WEIGHTS:
        _assert_grad_close(k, leaves[k].grad, want[2][k])


def test_scan_n1_bwd_plain_matches_autograd_of_fwd_plain():
    """The explicit adjoint against autograd through the plain forward,
    with x_dbl an input (so its gradient is compared directly)."""
    xr, xc, p, _ = _scan_inputs(3, 17, 8, 2, seed=11)
    rng = np.random.default_rng(12)
    t = {k: torch.tensor(v, requires_grad=True)
         for k, v in dict(xr=xr, xc=xc,
                          x_dbl=_rand(rng, 4, 3, 17, 4),
                          dt_proj_w=p["dt_proj_w"], dt_bias=p["dt_bias"],
                          A=p["A"][..., 0], D=p["D"]).items()}
    dy = torch.from_numpy(_rand(rng, 2, 3, 17, 8, scale=1.0))
    y = scan_n1.scan_n1_fwd_plain(*t.values())
    want = torch.autograd.grad(y, list(t.values()), dy)
    with torch.no_grad():
        du, dxdbl, d_a, d_d, ddb, ddtw = scan_n1.scan_n1_bwd_plain(
            *(v.detach() for v in t.values()), dy)
    for name, g, w in zip(("xr", "xc", "x_dbl", "dt_proj_w", "dt_bias", "A",
                           "D"),
                          (du[0], du[1], dxdbl, ddtw, ddb, d_a, d_d), want):
        _assert_grad_close(name, g, w)


def test_scan_n1_bf16_sources_bounded_by_fp32_oracle():
    """bf16 sources: ``x_proj_w`` is rounded to bf16 and x_dbl summed in
    fp32 (``scan_n1.py:729-737``), each direction is scanned in fp32 and
    rounded to bf16, and the pair is added in bf16 (``scan_n1.py:140-147``).
    Against the JAX function in interpret mode, which does the same, within
    one bf16 step (2^-7) of max(1, max |y|). Against the fp32 oracle on the
    same bf16-rounded operands the error is those three roundings, each at
    most half a step of its value: within 2^-7 as well."""
    xr, xc, p, _ = _scan_inputs(4, 33, 24, 3, seed=3)

    def bf16(a):
        return torch.from_numpy(a).bfloat16()

    got = scan_n1.scan_n1_sources(
        bf16(xr), bf16(xc), **{k: torch.from_numpy(v) for k, v in p.items()})
    assert got[0].dtype == torch.bfloat16
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = jax_scan_n1.scan_n1_sources(
        jnp.asarray(xr, jnp.bfloat16), jnp.asarray(xc, jnp.bfloat16), **jp,
        interpret=True)
    assert want[0].dtype == jnp.bfloat16
    rounded = {k: bf16(v).float().numpy() for k, v in
               dict(xr=xr, xc=xc, x_proj_w=p["x_proj_w"]).items()}
    jp["x_proj_w"] = jnp.asarray(rounded["x_proj_w"])
    oracle = _oracle(jnp.asarray(rounded["xr"]), jnp.asarray(rounded["xc"]),
                     jp)
    for s in range(2):
        _assert_close(got[s].float(), want[s], 2.0**-7, f"vs jax, source {s}")
        _assert_close(got[s].float(), oracle[:, s] + oracle[:, s + 2],
                      2.0**-7, f"vs oracle, source {s}")


def test_cross_scan_and_merge_exact():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    want = jax_cross_scan.cross_scan(jnp.asarray(x))
    got = cross_scan.cross_scan(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ys = np.random.default_rng(1).standard_normal((2, 4, 15, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        cross_scan.cross_merge(torch.from_numpy(ys), 3, 5).numpy(),
        np.asarray(jax_cross_scan.cross_merge(jnp.asarray(ys), 3, 5)))


def _random_params(jax_module, x, seed):
    """Parameters of the module's shapes, random from numpy (tracing the
    init is far cheaper than compiling it): norm scales near 1, the rest
    O(0.2)."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "scale":
            return jnp.asarray(1.0 + 0.1 * v)
        return jnp.asarray(0.2 * v)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _check_module(jax_module, port_module, x, atol, seed=0, **call):
    """Forward within ``atol``; gradients of sum(sin(y) * w) w.r.t. the
    input and every parameter within GRAD_RTOL."""
    params = _random_params(jax_module, x, seed)
    load_jax_params(port_module, params)
    out_shape = jax.eval_shape(
        lambda p, x_: jax_module.apply(p, x_, **call), params,
        jnp.asarray(x)).shape
    w = np.random.default_rng(seed + 1).standard_normal(out_shape).astype(
        np.float32)

    @jax.jit
    def value_and_grads(p, x_):
        y, vjp = jax.vjp(lambda p_, xx: jax_module.apply(p_, xx, **call), p,
                         x_)
        return y, vjp(jnp.cos(y) * w)  # the pullback of sum(sin(y) * w)

    want, (gp, gx) = value_and_grads(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = port_module(xt, **call)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)
    (torch.sin(got) * torch.from_numpy(w)).sum().backward()
    _assert_grad_close("x", xt.grad, gx)
    want_g = state_dict_from_jax(gp)
    named = dict(port_module.named_parameters())
    assert set(named) == set(want_g)
    for name, p in named.items():
        _assert_grad_close(name, p.grad, want_g[name])


@pytest.mark.parametrize("backend", ["auto", "ref", "pallas"])
@pytest.mark.parametrize("d_state,disable_z,conv_bias", [
    (1, True, False),   # vssm1: the scan_n1 path, no gate
    (16, False, True),  # vssm: the fused layer without a conv, gated
], ids=["n1-noz", "n16-z"])
def test_ss2d_matches_jax_ref(backend, d_state, disable_z, conv_bias):
    """``auto`` and ``ref`` against the JAX ``ref`` path; ``pallas`` (the
    general scan's route, its plain versions here) against the JAX
    ``pallas`` path, its kernels in interpret mode."""
    x = np.random.default_rng(2).standard_normal((2, 4, 5, 16)).astype(
        np.float32)
    kw = dict(d_state=d_state, disable_z=disable_z, conv_bias=conv_bias)
    jax_backend = "pallas" if backend == "pallas" else "ref"
    _check_module(jax_vmamba.SS2D(d_model=16, scan_backend=jax_backend, **kw),
                  vmamba.SS2D(16, scan_backend=backend, **kw), x, LAYER_ATOL)


def test_vssblock_matches_jax_ref():
    x = np.random.default_rng(3).standard_normal((2, 4, 4, 16)).astype(
        np.float32)
    kw = dict(d_state=1, disable_z=True, conv_bias=False, mlp_ratio=2.0)
    _check_module(jax_vmamba.VSSBlock(dim=16, scan_backend="ref", **kw),
                  vmamba.VSSBlock(16, **kw), x, LAYER_ATOL)


TINY_VSSM = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64))


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_vssm_matches_jax_ref(version):
    """vssm1 (v2 embed) and the d16 vssm (v1 embed), feature map out."""
    kw = dict(jax_vmamba._V1) if version == "v2" else dict(d_state=16)
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    _check_module(
        jax_vmamba.VSSM(**TINY_VSSM, **kw, scan_backend="ref"),
        vmamba.VSSM(**TINY_VSSM, **kw), x, STAGES_ATOL, seed=5, pool=False)


def test_pallas_backend_and_configs_match():
    """The ``pallas`` backends build (and an unknown one raises); the
    configurations equal the JAX package's."""
    for backend in ("pallas", "pallas_plain"):
        assert vmamba.SS2D(16, scan_backend=backend).scan_backend == backend
    with pytest.raises(ValueError, match="not in"):
        vmamba.SS2D(16, scan_backend="fused")
    assert vmamba.VSSM_CONFIGS == {
        k: {f: tuple(v) if isinstance(v, tuple) else v for f, v in c.items()}
        for k, c in jax_vmamba.VSSM_CONFIGS.items()}
    m = vmamba.build_vssm("vssm1_base", device="meta")
    j = jax_vmamba.build_vssm("vssm1_base")
    assert (m.depths, m.dims) == (j.depths, j.dims)
    ss2d = getattr(m, "stage2_block0").op
    assert (ss2d.d_inner, ss2d.rank, ss2d.n) == (1024, 32, 1)
