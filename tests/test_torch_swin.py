"""The Swin tower of the port against the JAX package on CPU, at a tiny size
(56^2 images, patch 4, embed 16, depths (2, 2), heads (2, 4), window 7:
stage 0 is 14x14 with 4 windows and a shift of 3, stage 1 is 7x7 and
unshifted).

(a) The window-attention sub-layer's plain version
    (``swin_attn_block_plain``, what ``swin_attn_fwd`` runs on a CPU tensor)
    against ``fused_swin_attn_block`` in Pallas interpret mode and against
    ``_swin_attn_unfused``: shifted (nW = 4, the mask cycling over the
    rows) and unshifted; fp32 within 1e-5 of max(1, max |y|), bf16 within
    one bf16 step of the interpret kernel's largest output.
(b) ``WindowAttention``, ``SwinBlock`` and ``SwinTransformer`` against the
    flax modules, from one parameter tree carried across by
    ``ckpt.from_jax`` (strict loads): forward without a gradient (the
    kernel path, its plain version here) and with one (the unfused route),
    and the gradients of the input and every parameter through the unfused
    route; 1e-5 per module, 1e-4 through the tower.
(c) ``SwinCheX`` logits and ``swinchex_loss`` with soft labels; R2GenCSR
    with ``vision=swin``: ``encode_img`` against JAX.
(d) The gate: no kernel-path call under a gradient, the plain switch.
(e) A non-square input through the tower (each block derives its window,
    shift and mask per call), and the MRG models' default tower.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.models import classifiers as jax_cls
from medical_image_analysis_tpu.models import swin as jax_swin
from medical_image_analysis_tpu.ops import swin_block as jsb
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    load_jax_params,
    state_dict_from_jax,
)
from medical_image_analysis_tpu_torch.models import classifiers, swin
from medical_image_analysis_tpu_torch.models.common import set_fused
from medical_image_analysis_tpu_torch.ops import swin_block as sb

TINY = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=7)
SIZE = 56
L, D, HEADS = 49, 32, 2
OP_RTOL = 1e-5  # one module, relative to max(1, max |want|)
TOWER_RTOL = 1e-4  # through the tower


def _err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max(), max(1.0, np.abs(want).max())


def _sublayer_inputs(seed, bn, nw):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    x = t(bn, L, D)
    w = [t(D, 3 * D, scale=0.2), t(3 * D, scale=0.1), t(D, D, scale=0.2),
         t(D, scale=0.1), t(D, scale=0.1, shift=1.0), t(D, scale=0.1)]
    bias = t(HEADS, L, L, scale=0.5)
    mask = (jax_swin._shift_attn_mask(14, 14, 7, 3) if nw > 1
            else np.zeros((1, L, L), np.float32))
    return x, w, bias, mask


@jax.jit
def _jax_interpret(x, wqkv, bqkv, wo, bo, g, b, bias, mask):
    return jsb.fused_swin_attn_block(x, wqkv, bqkv, wo, bo, g, b, bias, mask,
                                     HEADS, 1e-5, 4, True)


@pytest.mark.parametrize("nw", [4, 1], ids=["shifted", "unshifted"])
def test_sublayer_plain_fp32_matches_jax(nw):
    x, w, bias, mask = _sublayer_inputs(nw, 8, nw)
    got = sb.swin_attn_block_plain(
        torch.from_numpy(x), *map(torch.from_numpy, w),
        torch.from_numpy(bias), torch.from_numpy(mask), HEADS)
    jargs = [jnp.asarray(a) for a in (x, *w, bias, mask)]
    for want in (_jax_interpret(*jargs),
                 jsb._swin_attn_unfused(*jargs, HEADS)):
        err, scale = _err(got, want)
        assert err <= OP_RTOL * scale, (err, scale)
    # the wrapper takes the plain version on a CPU tensor
    again = sb.swin_attn_fwd(torch.from_numpy(x), *map(torch.from_numpy, w),
                             torch.from_numpy(bias), torch.from_numpy(mask),
                             HEADS)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("nw", [4, 1], ids=["shifted", "unshifted"])
def test_sublayer_plain_bf16_within_a_step_of_jax_interpret(nw):
    x, w, bias, mask = _sublayer_inputs(nw + 10, 8, nw)
    jx = jnp.asarray(x, jnp.bfloat16)
    jw = [jnp.asarray(a, jnp.bfloat16) for a in w]
    want = np.asarray(_jax_interpret(jx, *jw, jnp.asarray(bias),
                                     jnp.asarray(mask)).astype(jnp.float32))

    def bf16(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()

    got = sb.swin_attn_block_plain(bf16(jx), *map(bf16, jw),
                                   torch.from_numpy(bias),
                                   torch.from_numpy(mask), HEADS)
    assert got.dtype == torch.bfloat16
    err, _ = _err(got.float(), want)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert err <= step, (err, step)


# --------------------------------------------------------------------------
# (b) modules
# --------------------------------------------------------------------------


def _params(shapes, seed):
    """A parameter tree of ``shapes`` filled from numpy: norm scales near 1,
    the rest O(0.2), the bias tables O(0.5)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "scale":
            return jnp.asarray(1.0 + 0.1 * v)
        return jnp.asarray((0.5 if name.startswith("relative") else 0.2) * v)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _assert_close(name, got, want, rtol):
    err, scale = _err(got, want)
    if np.ndim(want) and name != "y":  # gradients: relative to the largest
        scale = max(np.abs(np.asarray(want)).max(), 1e-30)
    assert err <= rtol * scale, (name, err, scale)


def _check_module(jax_fn, params, port, x, rtol, seed):
    """``port(x)`` without a gradient and with one against ``jax_fn(params,
    x)``; the gradients of sum(sin(y) * w) w.r.t. x and every parameter."""
    load_jax_params(port, params)
    y_shape = jax.eval_shape(jax_fn, params, jnp.asarray(x)).shape
    w = np.random.default_rng(seed).standard_normal(y_shape).astype(
        np.float32)

    @jax.jit
    def value_and_grads(p, x_):
        y, vjp = jax.vjp(jax_fn, p, x_)
        return y, vjp(jnp.cos(y) * w)

    want, (gp, gx) = value_and_grads(params, jnp.asarray(x))
    with torch.no_grad():
        _assert_close("y", port(torch.from_numpy(x)), want, rtol)
    xt = torch.tensor(x, requires_grad=True)
    got = port(xt)
    _assert_close("y", got.detach(), want, rtol)
    (torch.sin(got) * torch.from_numpy(w)).sum().backward()
    _assert_close("x", xt.grad, gx, rtol)
    want_g = state_dict_from_jax(gp)
    named = dict(port.named_parameters())
    assert set(named) == set(want_g)
    for name, p in named.items():
        _assert_close(name, p.grad, want_g[name], rtol)


def test_window_attention_matches_jax():
    x, _, _, mask = _sublayer_inputs(3, 8, 4)
    jm = jax_swin.WindowAttention(D, HEADS, 7)
    rng = np.random.default_rng(4)
    ln = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32), (
        0.1 * rng.standard_normal(D)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(mask), ln)
    params = {"attn": _params(shapes, 5)["params"],
              "norm1": {"scale": jnp.asarray(ln[0]),
                        "bias": jnp.asarray(ln[1])}}

    def jax_fn(p, x_):
        return jm.apply({"params": p["attn"]}, x_, jnp.asarray(mask),
                        (p["norm1"]["scale"], p["norm1"]["bias"]))

    class Pair(torch.nn.Module):  # the attention and the norm it is handed
        def __init__(self):
            super().__init__()
            self.attn = swin.WindowAttention(D, HEADS, 7)
            self.norm1 = torch.nn.LayerNorm(D, eps=1e-5)
            self.mask = torch.from_numpy(mask)

        def forward(self, x_):
            fused = not torch.is_grad_enabled()
            return self.attn(x_, self.mask, self.norm1, fused)

    _check_module(jax_fn, params, Pair(), x, OP_RTOL, 6)


@pytest.mark.parametrize("shift", [3, 0], ids=["shifted", "unshifted"])
def test_swin_block_matches_jax(shift):
    x = np.random.default_rng(7).standard_normal((2, 14, 14, 16)).astype(
        np.float32)
    jm = jax_swin.SwinBlock(16, 2, 7, shift)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = _params(shapes, 8)

    def jax_fn(p, x_):
        return jm.apply(p, x_)

    port = swin.SwinBlock(16, 2, 14, 7, shift)
    _check_module(jax_fn, params, port, x, OP_RTOL, 9)


def _tiny_tower_params(seed):
    jm = jax_swin.SwinTransformer(**TINY)
    x0 = jnp.zeros((1, SIZE, SIZE, 3))
    return jm, _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x0),
                       seed)


def _images(seed, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, SIZE, SIZE, 3)).astype(np.float32)


def test_swin_transformer_matches_jax():
    jm, params = _tiny_tower_params(10)
    port = swin.SwinTransformer(**TINY, img_size=SIZE)
    _check_module(lambda p, x_: jm.apply(p, x_), params, port, _images(11),
                  TOWER_RTOL, 12)


def test_swin_transformer_non_square_matches_jax():
    """56 x 112 images: stage 0 is a 14 x 28 map (8 windows, shift 3),
    stage 1 a 7 x 14 map (window 7, unshifted). Each block derives its
    window, shift and mask from the map it is given, as the JAX block does,
    and builds each mask once per (H, W, device)."""
    jm, params = _tiny_tower_params(22)
    x = np.random.default_rng(23).standard_normal((2, SIZE, 2 * SIZE, 3)
                                                  ).astype(np.float32)
    port = swin.SwinTransformer(**TINY, img_size=SIZE)
    _check_module(lambda p, x_: jm.apply(p, x_), params, port, x,
                  TOWER_RTOL, 24)
    masks = [tuple(m.shape) for blk in port.stages[0] for m in
             blk._masks.values()]
    assert masks == [(8, L, L)]  # block 1 of stage 0, built once
    assert not any(blk._masks for blk in port.stages[1])


@pytest.mark.parametrize("cls", ["R2GenGPT", "R2GenCSR"])
def test_mrg_default_tower_is_the_jax_default(cls):
    """Built with its defaults, each MRG model picks the JAX class's tower
    (``chosen="swin"``)."""
    from medical_image_analysis_tpu.models import llm as jax_llm
    from medical_image_analysis_tpu.models import mrg as jax_mrg
    from medical_image_analysis_tpu_torch.models import llm, mrg

    kw = dict(vocab_size=48, dim=32, n_layers=1, n_heads=4, n_kv_heads=2,
              hidden_dim=64)
    want = getattr(jax_mrg, cls)(llm_cfg=jax_llm.LLMConfig(**kw)).chosen
    port = getattr(mrg, cls)(llm.LLMConfig(**kw), device="meta")
    assert port.vision.chosen == want == "swin"
    assert isinstance(port.vision.swin, swin.SwinTransformer)


def test_swinchex_logits_and_loss_match_jax():
    backbone = jax_swin.SwinTransformer(**TINY)
    jm = jax_swin.SwinCheX(backbone=backbone, num_classes=14)
    x = _images(13, 3)
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    jnp.asarray(x)), 14)
    labels = np.random.default_rng(15).uniform(size=(3, 14)).astype(
        np.float32)
    want_logits, want_loss = jax.jit(lambda p, x_, y_: (
        lambda lg: (lg, jax_cls.swinchex_loss(lg, y_)))(jm.apply(p, x_)))(
        params, jnp.asarray(x), jnp.asarray(labels))
    port = swin.SwinCheX(swin.SwinTransformer(**TINY, img_size=SIZE), 14)
    load_jax_params(port, params)
    with torch.no_grad():
        logits = port(torch.from_numpy(x))
    assert logits.shape == (3, 14, 2)
    _assert_close("y", logits, want_logits, TOWER_RTOL)
    loss = classifiers.swinchex_loss(logits, torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)


def test_r2gencsr_swin_encode_img_matches_jax():
    """R2GenCSR on its own tower (``vision=swin``): the projected image
    tokens and the global feature, from one full parameter tree."""
    from medical_image_analysis_tpu.models import llm as jax_llm
    from medical_image_analysis_tpu.models import mrg as jax_mrg
    from medical_image_analysis_tpu_torch.models import llm, mrg

    llm_kw = dict(vocab_size=48, dim=32, n_layers=1, n_heads=4, n_kv_heads=2,
                  hidden_dim=64)
    jm = jax_mrg.R2GenCSR(
        llm_cfg=jax_llm.LLMConfig(**llm_kw, dtype=jnp.float32),
        chosen="swin", vision_kwargs=TINY)
    rng = np.random.default_rng(16)
    imgs = rng.standard_normal((2, 2, SIZE, SIZE, 3)).astype(np.float32)
    batch = (imgs, imgs[:, :2], np.full((2, 3), 5, np.int32),
             np.full((2, 2), 6, np.int32), np.full((2, 4), 7, np.int32),
             np.ones((2, 4), np.int32))
    params = _params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), *map(jnp.asarray, batch)), 17)
    want_tok, want_glob = jax.jit(lambda p, x_: jm.apply(
        p, x_, method=jax_mrg.R2GenCSR.encode_img))(params, jnp.asarray(imgs))
    port = mrg.R2GenCSR(llm.LLMConfig(**llm_kw, dtype=torch.float32),
                        chosen="swin", vision_kwargs=dict(TINY, img_size=SIZE))
    load_jax_params(port, params)
    with torch.no_grad():
        tok, glob = port.encode_img(torch.from_numpy(imgs))
    _assert_close("y", tok, want_tok, TOWER_RTOL)
    _assert_close("y", glob, want_glob, TOWER_RTOL)


# --------------------------------------------------------------------------
# (d) the gate
# --------------------------------------------------------------------------


def test_kernel_path_only_without_a_gradient(monkeypatch):
    """The sub-layer wrapper is called once per block in eval mode under
    ``no_grad`` (or with nothing requiring grad), and never when a gradient
    is needed or the block is not deterministic; ``plain`` calls the plain
    version instead."""
    calls = {"fwd": 0, "plain": 0}

    def counting(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(swin, "swin_attn_fwd",
                        counting("fwd", sb.swin_attn_fwd))
    monkeypatch.setattr(swin, "swin_attn_block_plain",
                        counting("plain", sb.swin_attn_block_plain))
    tower = swin.SwinTransformer(**TINY, img_size=SIZE)
    from medical_image_analysis_tpu_torch.models.common import init_params

    init_params(tower, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(18))
    blocks = sum(TINY["depths"])
    with torch.no_grad():
        tower(x)
    assert calls == {"fwd": blocks, "plain": 0}
    tower(x).sum().backward()  # parameters require grad: unfused
    tower(x, deterministic=False)
    assert calls == {"fwd": blocks, "plain": 0}
    for p in tower.parameters():
        p.requires_grad_(False)
    tower(x)  # nothing requires grad: the kernel path
    assert calls == {"fwd": 2 * blocks, "plain": 0}
    set_fused(tower, False)
    with torch.no_grad():
        tower(x)
    assert calls == {"fwd": 2 * blocks, "plain": blocks}
