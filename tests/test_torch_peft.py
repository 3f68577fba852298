"""The weight-space MambaPEFT family in the port against the JAX package on
CPU, at tiny widths (V=64, d_model 16, depth 2, d_state 4, as
``tests/test_mamba_peft.py``).

(a) Every adapter of the JAX tests' ``WEIGHT_ADAPTERS`` and the v2 deltas:
    the JAX adapter tree is carried across by ``mamba_peft_from_jax`` and
    merged in both packages; every merged tensor equals JAX's bit for bit
    (the adapters' values are multiples of 1/64 of at most 8/64, so every
    product and sum of a delta is exact in fp32 and each merged tensor is
    one rounding of the same sum); the LM's logits within 1e-5 of max(1,
    the largest) and every adapter's gradient within 1e-5 of its largest
    (the bounds of ``tests/test_torch_mamba_lm.py``).
(b) ``additional_scan`` in suffix and prefix position (d_state 4 -> 6,
    which the port's fused path runs at 8, its two extra states zero):
    with ``zero_init_x_proj`` the widened model's logits equal the base
    model's within 1e-5; with random B and C rows the gradients reach
    ``A_log_addi`` and ``x_proj_addi`` and equal JAX's within 1e-5; the
    widened model's decode ``step`` against JAX's and its own forward.
(c) The ARM (four directions) with ``lora_patch_embed``,
    ``learnable_cls_token_v2``, ``learnable_pos_embed_v2``, ``lora_dt``
    and ``additional_scan`` (d_state 4 -> 5): merged tensors, tokens and
    adapter gradients as in (a).
(d) ``init_mamba_peft``'s keys and shapes against JAX's, its deterministic
    leaves equal; ``mamba_peft_trainable_mask`` equal to JAX's name for
    name.
(e) The port's fused layer at d_state 5, 6 and 17 (padded to 8, 8 and
    run at 17 off the plain path; the plain path at its own width) against
    the JAX package's ``mamba_fused_dirs`` in interpret mode: y within
    1e-5 of max(1, max |y|) and every gradient within 1e-4 of its largest
    (fp32 both sides, reordered sums over chunks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.models import mamba as jax_mamba
from medical_image_analysis_tpu.models import mamba_lm as jax_lm
from medical_image_analysis_tpu.ops.mamba_fused import (
    mamba_fused_dirs as jax_mamba_fused_dirs,
)
from medical_image_analysis_tpu.peft import mamba_peft as jax_peft
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    flax_named_parameters,
    load_jax_params,
    mamba_peft_from_jax,
    to_port_layout,
)
from medical_image_analysis_tpu_torch.models import mamba, mamba_lm
from medical_image_analysis_tpu_torch.ops import mamba_fused
from medical_image_analysis_tpu_torch.peft import mamba_peft

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-5
FUSED_GRAD_RTOL = 1e-4
DECODE_TOL = 2e-4  # the JAX package's own step-vs-forward bound
V, D, DEPTH, N = 64, 16, 2, 4
WEIGHT_ADAPTERS = [
    "lora_out_proj", "lora_in_proj", "lora_X", "lora_Z", "lora_x_proj",
    "lora_d", "lora_B", "lora_C", "lora_dt", "lora_conv1d",
]
V2_DELTAS = dict(learnable_A=True, learnable_A_v2=True, learnable_D=True,
                 learnable_D_v2=True, learnable_conv1d=True,
                 learnable_conv1d_v2=True, learnable_bias=True,
                 learnable_bias_v2=True)
ARM_KW = dict(patch_size=8, embed_dim=16, depth=2, d_state=N)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(shapes, seed):
    """Random parameters of the JAX tree's shapes: norm scales near 1,
    ``A_log`` as the mixer's init, matrices N(0, 1/fan-in), the rest N(0,
    0.1^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        key = path[-1].key
        if key == "scale":
            return jnp.asarray(1.0 + 0.1 * v)
        if key == "A_log":
            n = leaf.shape[-1]
            return jnp.asarray(np.broadcast_to(
                np.log(np.arange(1, n + 1, dtype=np.float32)), leaf.shape))
        if leaf.ndim >= 2 and "bias" not in key:
            return jnp.asarray(v / np.sqrt(np.prod(leaf.shape[:-1])))
        return jnp.asarray(0.1 * v)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _dyadic(tree, seed):
    """Every adapter leaf replaced by multiples of 1/64 in [-8/64, 8/64]:
    exact products and sums in fp32 (see the module's docstring)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.integers(-8, 9, x.shape).astype(
            np.float32) / 64), tree)


def _flat(tree):
    """A flax tree -> ``{flax name: numpy array}`` without ``params/``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out[name.removeprefix("params/")] = np.asarray(leaf)
    return out


def _close(got, want, rtol=OUT_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _check_merged(merged_p, merged_j):
    """Every merged tensor equal to JAX's, in the port's layout."""
    want = _flat(merged_j)
    assert set(merged_p) == set(want)
    for name, t in merged_p.items():
        w = to_port_layout(name.split("/"), torch.tensor(want[name]))
        assert t.shape == w.shape, name
        assert torch.equal(t.detach(), w), name


def _check_adapter_grads(peft_p, grads_j, rtol=GRAD_RTOL):
    want = {k.removeprefix("params/"): v for k, v in grads_j.items()}
    assert set(peft_p) == set(want)
    for key, val in peft_p.items():
        pairs = (val.items() if isinstance(val, dict) else [(None, val)])
        for part, t in pairs:
            w = np.asarray(want[key] if part is None else want[key][part])
            err = float(np.abs(t.grad.numpy() - w).max())
            assert np.abs(w).max() > 0, (key, part)
            assert err <= rtol * float(np.abs(w).max()), (key, part, err)


def _ids(seed, b=2, length=12):
    return np.random.default_rng(seed).integers(1, V, (b, length)).astype(
        np.int32)


def _jax_lm(d_state=N):
    return jax_lm.MambaLM(vocab_size=V, d_model=D, depth=DEPTH,
                          d_state=d_state, scan_backend="ref")


def _lm_params(seed):
    return _params(jax.eval_shape(_jax_lm().init, jax.random.PRNGKey(0),
                                  jnp.ones((2, 12), jnp.int32)), seed)


def _port_base(params, module):
    """The port module loaded from the JAX parameters, and its flat
    ``{flax name: tensor}`` base parameters."""
    load_jax_params(module, params)
    return {k: v.detach() for k, v in flax_named_parameters(module).items()}


def _lm_case(fields: dict, ids, seed, wide_state=N):
    """The JAX loss, logits, merged tree and adapter gradients of the LM
    with the adapters of ``fields`` (dyadic values from ``seed``), and the
    port's merged mapping and logits from the same trees; the port's loss
    is backpropagated into its adapter tree."""
    params = _lm_params(seed)
    cfg_j = jax_peft.MambaPEFTConfig(**fields)
    peft_j = _dyadic(jax_peft.init_mamba_peft(jax.random.PRNGKey(1), params,
                                              cfg_j), seed + 1)
    wide = _jax_lm(wide_state)
    mask = jnp.ones(ids.shape, jnp.int32)

    def loss(pf):
        logits = wide.apply(jax_peft.merge_mamba_peft(params, pf, cfg_j),
                            jnp.asarray(ids))
        return jax_lm.lm_loss(logits, jnp.asarray(ids), mask), logits

    (want_loss, want_logits), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(peft_j)
    merged_j = jax_peft.merge_mamba_peft(params, peft_j, cfg_j)
    base = _port_base(params, mamba_lm.MambaLM(V, d_model=D, depth=DEPTH,
                                               d_state=N))
    cfg_p = mamba_peft.MambaPEFTConfig(**fields)
    peft_p = mamba_peft_from_jax(peft_j)
    merged_p = mamba_peft.merge_mamba_peft(base, peft_p, cfg_p)
    model = mamba_lm.MambaLM(V, d_model=D, depth=DEPTH, d_state=wide_state,
                             device="meta")
    logits = mamba_peft.apply_merged(model, merged_p, torch.from_numpy(ids))
    got_loss = mamba_lm.lm_loss(logits, torch.from_numpy(ids),
                                torch.ones(ids.shape))
    np.testing.assert_allclose(got_loss.item(), float(want_loss),
                               rtol=OUT_RTOL)
    got_loss.backward()
    return dict(params=params, merged_j=merged_j, merged_p=merged_p,
                logits=logits, want_logits=want_logits, peft_p=peft_p,
                grads=grads, base=base, cfg_p=cfg_p, cfg_j=cfg_j)


# --------------------------------------------------------------------------
# (a) every weight-space adapter
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", WEIGHT_ADAPTERS + ["v2_deltas"])
def test_adapter_merge_logits_and_grads_match_jax(name):
    fields = V2_DELTAS if name == "v2_deltas" else {name: True}
    r = _lm_case(fields, _ids(3), 4)
    keys = {k.split("|")[1] for k in r["peft_p"]}
    assert keys == ({"learnable_A", "learnable_D", "learnable_conv1d",
                     "learnable_bias"} if name == "v2_deltas" else {name})
    assert len(r["peft_p"]) == DEPTH * len(keys)
    _check_merged(r["merged_p"], r["merged_j"])
    _close(r["logits"].detach().numpy(), r["want_logits"])
    _check_adapter_grads(r["peft_p"], r["grads"])
    # the merge is pure: the base mapping is unchanged
    assert all(torch.equal(r["base"][k], v) for k, v in _port_base(
        r["params"], mamba_lm.MambaLM(V, d_model=D, depth=DEPTH,
                                      d_state=N)).items())


# --------------------------------------------------------------------------
# (b) additional_scan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pos", ["suffix", "prefix"])
def test_additional_scan_matches_jax(pos):
    cfg = dict(additional_scan=True, scan_addition_num=2,
               scan_addition_pos=pos)
    ids = _ids(5)
    wide = mamba_peft.effective_d_state(mamba_peft.MambaPEFTConfig(**cfg), N)
    assert wide == 6 and mamba_fused.state_width(wide) == 16
    # zero B and C rows: the two extra states carry nothing
    params = _lm_params(6)
    cfg_z = mamba_peft.MambaPEFTConfig(**cfg, zero_init_x_proj=True)
    base_model = mamba_lm.MambaLM(V, d_model=D, depth=DEPTH, d_state=N)
    base = _port_base(params, base_model)
    peft = mamba_peft.init_mamba_peft(torch.Generator().manual_seed(0), base,
                                      cfg_z)
    merged = mamba_peft.merge_mamba_peft(base, peft, cfg_z)
    assert merged["layers_0/mixer/A_log"].shape == (1, 2 * D, wide)
    model = mamba_lm.MambaLM(V, d_model=D, depth=DEPTH, d_state=wide,
                             device="meta")
    with torch.no_grad():
        _close(mamba_peft.apply_merged(model, merged, torch.from_numpy(ids)),
               base_model(torch.from_numpy(ids)).numpy())
    # random B and C rows (the reference's default): against JAX
    r = _lm_case(cfg, ids, 7, wide_state=wide)
    _check_merged(r["merged_p"], r["merged_j"])
    _close(r["logits"].detach().numpy(), r["want_logits"])
    _check_adapter_grads(r["peft_p"], r["grads"])
    g = r["peft_p"]["layers_0/mixer/|scan_addi"]
    assert g["A_log_addi"].grad.abs().sum() > 0
    assert g["x_proj_addi"].grad.abs().sum() > 0


def test_widened_lm_steps_as_jax_and_as_its_forward():
    """``MambaMixer.step`` at the widened state: the LM merged with
    ``additional_scan`` (4 -> 6) and ``lora_dt`` loaded into a model of
    d_state 6 (``load_merged``) decodes token by token as JAX's ``step``
    and as its own forward."""
    fields = dict(additional_scan=True, scan_addition_num=2, lora_dt=True)
    ids = _ids(8, length=8)
    r = _lm_case(fields, ids, 9, wide_state=6)
    jm = _jax_lm(6)
    merged_j = r["merged_j"]
    model = mamba_peft.load_merged(
        mamba_lm.MambaLM(V, d_model=D, depth=DEPTH, d_state=6), {
            k: v.detach() for k, v in r["merged_p"].items()})
    step = jax.jit(lambda p, tok, s: jm.apply(p, tok, s,
                                              method=jax_lm.MambaLM.step))
    jstates = jm.apply(merged_j, 2, method=jax_lm.MambaLM.init_states)
    states = model.init_states(2)
    assert states[0][1].shape == (2, 2 * D, 6)
    outs = []
    with torch.no_grad():
        for t in range(ids.shape[1]):
            want, jstates = step(merged_j, jnp.asarray(ids[:, t]), jstates)
            got, states = model.step(torch.from_numpy(ids[:, t]), states)
            _close(got.numpy(), want)
            outs.append(got)
        full = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full,
                               rtol=DECODE_TOL, atol=DECODE_TOL)


# --------------------------------------------------------------------------
# (c) the ARM
# --------------------------------------------------------------------------


def test_arm_merge_tokens_and_grads_match_jax():
    fields = dict(lora_patch_embed=True, dim_patch_embed=4,
                  learnable_cls_token_v2=True, learnable_pos_embed_v2=True,
                  lora_dt=True, additional_scan=True)
    images = np.random.default_rng(10).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    jm = jax_mamba.ARM(**ARM_KW, scan_backend="ref")
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    jnp.asarray(images)), 11)
    cfg_j = jax_peft.MambaPEFTConfig(**fields)
    peft_j = _dyadic(jax_peft.init_mamba_peft(jax.random.PRNGKey(1), params,
                                              cfg_j), 12)
    wide = jax_mamba.ARM(**dict(ARM_KW, d_state=N + 1), scan_backend="ref")
    cot = np.random.default_rng(13).standard_normal((2, 17, 16)).astype(
        np.float32)

    def objective(pf):
        y = wide.apply(jax_peft.merge_mamba_peft(params, pf, cfg_j),
                       jnp.asarray(images))
        return jnp.sum(y * cot), y

    (_, want), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        peft_j)
    base = _port_base(params, mamba.ARM(**ARM_KW, img_size=32))
    cfg_p = mamba_peft.MambaPEFTConfig(**fields)
    peft_p = mamba_peft_from_jax(peft_j)
    assert {k.split("|")[1] for k in peft_p} == {
        "lora_patch_embed", "learnable", "lora_dt", "scan_addi"}
    assert peft_p["layers_0/mixer/|lora_dt"]["a"].shape[0] == 4  # directions
    merged = mamba_peft.merge_mamba_peft(base, peft_p, cfg_p)
    _check_merged(merged, jax_peft.merge_mamba_peft(params, peft_j, cfg_j))
    model = mamba.ARM(**dict(ARM_KW, d_state=N + 1), img_size=32,
                      device="meta")
    y = mamba_peft.apply_merged(model, merged, torch.from_numpy(images))
    _close(y.detach().numpy(), want)
    (y * torch.from_numpy(cot)).sum().backward()
    _check_adapter_grads(peft_p, grads)


# --------------------------------------------------------------------------
# (d) init and the trainable mask
# --------------------------------------------------------------------------

EVERYTHING = dict(
    {name: True for name in WEIGHT_ADAPTERS}, **V2_DELTAS,
    additional_scan=True, scan_addition_num=3, scan_A_copy_from_last=True,
    learnable_cls_token_v2=True, learnable_pos_embed_v2=True,
    lora_patch_embed=True)


@pytest.mark.parametrize("model", ["lm", "arm"])
@pytest.mark.parametrize("scan_a", ["arange", "constant", "copy_from_last"])
def test_init_matches_jax_keys_shapes_and_fixed_leaves(model, scan_a):
    """Every key and shape of JAX's tree; zero ``b`` factors and v2 deltas;
    ``A_log_addi`` equal (log 1..a_num, log of the constant, or the last
    state's); one generator seed gives one tree."""
    fields = dict(EVERYTHING, scan_A_copy_from_last=scan_a == "copy_from_last",
                  scan_A_constant=0.5 if scan_a == "constant" else None)
    if model == "lm":
        params = _lm_params(14)
        module = mamba_lm.MambaLM(V, d_model=D, depth=DEPTH, d_state=N)
    else:
        jm = jax_mamba.ARM(**ARM_KW, scan_backend="ref")
        params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                        jnp.ones((2, 32, 32, 3))), 15)
        module = mamba.ARM(**ARM_KW, img_size=32)
    want = jax_peft.init_mamba_peft(jax.random.PRNGKey(1), params,
                                    jax_peft.MambaPEFTConfig(**fields))
    base = _port_base(params, module)
    cfg = mamba_peft.MambaPEFTConfig(**fields)
    got = mamba_peft.init_mamba_peft(torch.Generator().manual_seed(2), base,
                                     cfg)
    again = mamba_peft.init_mamba_peft(torch.Generator().manual_seed(2), base,
                                       cfg)
    want = {k.removeprefix("params/"): v for k, v in want.items()}
    assert set(got) == set(want)
    for key, val in got.items():
        w = want[key]
        parts = val.items() if isinstance(val, dict) else [(None, val)]
        for part, t in parts:
            wv = np.asarray(w if part is None else w[part])
            assert t.shape == wv.shape and t.requires_grad, (key, part)
            a2 = again[key] if part is None else again[key][part]
            assert torch.equal(t, a2), (key, part)
            if part in (None, "b", "A_log_addi"):
                np.testing.assert_array_equal(t.detach().numpy(), wv)
            else:  # a, and x_proj_addi: drawn, not zero
                assert t.abs().sum() > 0, (key, part)


@pytest.mark.parametrize("fields", [
    dict(learnable_A=True, learnable_D=True),
    dict(learnable_conv1d=True, learnable_bias=True),
    dict(learnable_A=True, learnable_A_v2=True, learnable_bias=True),
    dict(learnable_cls_token=True, learnable_pos_embed=True),
    dict(learnable_cls_token=True, learnable_cls_token_v2=True,
         learnable_conv1d=True),
], ids=["a-d", "conv-bias", "a-v2", "cls-pos", "cls-v2"])
def test_trainable_mask_matches_jax(fields):
    jm = jax_mamba.ARM(**ARM_KW, scan_backend="ref")
    trained = 0
    for params, module in (
            (_lm_params(16), mamba_lm.MambaLM(V, d_model=D, depth=DEPTH,
                                              d_state=N)),
            (_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    jnp.ones((2, 32, 32, 3))), 17),
             mamba.ARM(**ARM_KW, img_size=32))):
        want = _flat(jax_peft.mamba_peft_trainable_mask(
            params, jax_peft.MambaPEFTConfig(**fields)))
        got = mamba_peft.mamba_peft_trainable_mask(
            _port_base(params, module), mamba_peft.MambaPEFTConfig(**fields))
        assert got == {k: bool(v) for k, v in want.items()}
        trained += sum(got.values())
    assert trained


# --------------------------------------------------------------------------
# (e) the fused layer at odd widths
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [5, 6, 17])
@pytest.mark.parametrize("plain", [False, True], ids=["padded", "plain"])
def test_fused_layer_at_odd_widths_matches_jax(n, plain):
    k_dirs, b, l, d, r = 4, 2, 10, 8, 3
    rng = np.random.default_rng(n)

    def rand(*shape, scale=0.5):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    xr, xc = rand(b, l, d), rand(b, l, d)
    p = dict(conv_w=rand(k_dirs, 4, d), conv_b=rand(k_dirs, d),
             x_proj_w=rand(k_dirs, r + 2 * n, d), dt_proj_w=rand(k_dirs, d, r),
             dt_bias=rand(k_dirs, d),
             A=-np.exp(rand(k_dirs, d, n, scale=0.3)), D=rand(k_dirs, d))
    cot = rand(b, k_dirs, l, d, scale=1.0)
    names = ["xr", "xc", *p]

    def objective(*args):
        y = jax_mamba_fused_dirs(*args, chunk=4, block_d=8, interpret=True)
        return jnp.sum(y * cot), y

    (_, want), grads = jax.value_and_grad(
        objective, argnums=tuple(range(9)), has_aux=True)(
        jnp.asarray(xr), jnp.asarray(xc), *map(jnp.asarray, p.values()))
    t = [torch.from_numpy(a).requires_grad_() for a in (xr, xc, *p.values())]
    args = list(t)
    if not plain:
        # the layer at the kernels' width: B and C rows and A padded with
        # zero states, whose gradients the padding's autograd drops
        width, (i_w, i_a) = mamba_fused.state_width(n), (4, 7)
        args[i_w] = mamba_fused.widen_states(
            t[i_w].transpose(1, 2), r, n, width).transpose(1, 2)
        args[i_a] = torch.nn.functional.pad(t[i_a], (0, width - n))
    got = mamba_fused.mamba_fused_dirs(*args, plain=plain)
    _close(got.detach().numpy(), want)
    (got * torch.from_numpy(cot)).sum().backward()
    for name, tt, g in zip(names, t, grads):
        g = np.asarray(g)
        assert tt.grad.shape == g.shape, name
        err = float(np.abs(tt.grad.numpy() - g).max())
        assert err <= FUSED_GRAD_RTOL * float(np.abs(g).max()), (name, err)


def test_effective_d_state_and_config_are_the_jax_packages():
    for cfg in (dict(), dict(additional_scan=True),
                dict(additional_scan=True, scan_addition_num=16)):
        assert mamba_peft.effective_d_state(
            mamba_peft.MambaPEFTConfig(**cfg), 16) == \
            jax_peft.effective_d_state(jax_peft.MambaPEFTConfig(**cfg), 16)
    assert mamba_fused.state_width(17) == 17
    assert mamba_fused.state_width(32) == 32
    with pytest.raises(ValueError, match="1 <= d_state <= 32"):
        mamba_fused.state_width(33)
    assert [f.name for f in dataclasses.fields(mamba_peft.MambaPEFTConfig)] \
        == [f.name for f in dataclasses.fields(jax_peft.MambaPEFTConfig)]
