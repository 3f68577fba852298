"""The ViT block's sub-layers of the port against the JAX package on CPU.

(a) Forward: the plain attention and MLP sub-layers (``attn_block_plain``,
    ``mlp_block_plain``, what the kernel wrappers run on a CPU tensor)
    against ``fused_attn_block`` / ``fused_mlp_block`` in Pallas interpret
    mode and against ``_attn_unfused`` / ``_mlp_unfused``, at L = 12 and at
    a ragged L = 13. fp32 with the same formulas: 1e-5. bf16: the plain
    versions round where the TPU kernel rounds, so they stay within one
    bf16 step of the largest output of the interpret kernel.
(b) Gradients: every input and weight gradient of ``AttnBlockFn`` and
    ``MlpBlockFn`` (their plain backward on the CPU) against ``jax.vjp`` of
    the interpret-mode kernels, with a hidden layer that the TPU kernel
    walks in several chunks; fp32, 2e-5 of each gradient's largest. And the
    plain backward against autograd of the plain forward.
(c) The gathers and their gradients, and the masking ids from shared noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.models import vit as jax_vit
from medical_image_analysis_tpu.ops import gather as jax_gather
from medical_image_analysis_tpu.ops import vit_block as jvb
from medical_image_analysis_tpu_torch.models import vit
from medical_image_analysis_tpu_torch.ops import gather
from medical_image_analysis_tpu_torch.ops import vit_block as vb

D, HEADS = 32, 4
FWD_RTOL = 1e-5  # (a) fp32, relative to max(1, max |y|)
GRAD_RTOL = 2e-5  # (b) relative to each gradient's largest entry


def _weights(seed, d=D, hidden=4 * D):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.3, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    attn = [t(d, 3 * d), t(3 * d, scale=0.1), t(d, d), t(d, scale=0.1),
            t(d, scale=0.1, shift=1.0), t(d, scale=0.1)]
    mlp = [t(d, hidden, scale=0.2), t(hidden, scale=0.1),
           t(hidden, d, scale=0.05), t(d, scale=0.1),
           t(d, scale=0.1, shift=1.0), t(d, scale=0.1)]
    return attn, mlp


def _x(seed, b, l, d=D):
    return np.random.default_rng(seed).standard_normal((b, l, d)).astype(
        np.float32)


@jax.jit
def _jax_attn_interpret(x, *w):
    return jvb.fused_attn_block(x, *w, HEADS, 2, True)


@jax.jit
def _jax_mlp_interpret(x, *w):
    return jvb.fused_mlp_block(x, *w, 2, True)


def _err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max(), max(1.0, np.abs(want).max())


# --------------------------------------------------------------------------
# (a) forward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("l", [12, 13], ids=["l12", "ragged-l13"])
def test_sublayers_fp32_match_jax(l):
    attn, mlp = _weights(l)
    x = _x(l + 100, 2, l)
    for plain, interp, unfused, w, extra in (
        (vb.attn_block_plain, _jax_attn_interpret, jvb._attn_unfused, attn,
         (HEADS,)),
        (vb.mlp_block_plain, _jax_mlp_interpret, jvb._mlp_unfused, mlp, ()),
    ):
        got = plain(torch.from_numpy(x), *map(torch.from_numpy, w), *extra)
        jw = [jnp.asarray(a) for a in w]
        for want in (interp(jnp.asarray(x), *jw),
                     unfused(jnp.asarray(x), *jw, *extra)):
            err, scale = _err(got, want)
            assert err <= FWD_RTOL * scale, (plain.__name__, err, scale)


@pytest.mark.parametrize("l", [12, 13], ids=["l12", "ragged-l13"])
def test_sublayers_bf16_match_jax_interpret(l):
    attn, mlp = _weights(l + 1)
    x = _x(l + 200, 2, l)
    for plain, interp, w, extra in (
        (vb.attn_block_plain, _jax_attn_interpret, attn, (HEADS,)),
        (vb.mlp_block_plain, _jax_mlp_interpret, mlp, ()),
    ):
        jx = jnp.asarray(x, jnp.bfloat16)
        jw = [jnp.asarray(a, jnp.bfloat16) for a in w]
        want = np.asarray(interp(jx, *jw).astype(jnp.float32))
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
        tw = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
              for a in jw]
        got = plain(tx, *tw, *extra)
        assert got.dtype == torch.bfloat16
        err, _ = _err(got.float(), want)
        top = np.abs(want).max()
        step = 2.0 ** (np.floor(np.log2(top)) - 7)  # one bf16 step at top
        assert err <= step, (plain.__name__, err, step)


# --------------------------------------------------------------------------
# (b) gradients
# --------------------------------------------------------------------------


def _assert_grads(names, got, want):
    for name, g, wv in zip(names, got, want):
        g, wv = np.asarray(g), np.asarray(wv)
        assert g.shape == wv.shape, name
        scale = max(np.abs(wv).max(), 1e-30)
        assert np.abs(g - wv).max() <= GRAD_RTOL * scale, (name, scale)


@pytest.mark.parametrize("kind,l,hidden", [
    ("attn", 12, 4 * D), ("attn", 13, 4 * D), ("mlp", 13, 4 * D),
    ("mlp", 12, 2048),  # the TPU kernel walks hidden=2048 in two chunks
], ids=["attn-l12", "attn-ragged", "mlp-ragged", "mlp-multi-chunk"])
def test_block_fn_grads_match_jax_vjp(kind, l, hidden):
    attn, mlp = _weights(l + hidden, hidden=hidden)
    x, dy = _x(1, 4, l), _x(2, 4, l)
    if hidden == 2048:
        assert jvb._mlp_bwd_plan(4, l, D, hidden, 2)[1] < hidden
    w = attn if kind == "attn" else mlp
    fn = ((lambda *a: jvb.fused_attn_block(*a, HEADS, 2, True))
          if kind == "attn" else
          (lambda *a: jvb.fused_mlp_block(*a, 2, True)))
    _, vjp = jax.vjp(fn, jnp.asarray(x), *map(jnp.asarray, w))
    want = vjp(jnp.asarray(dy))

    leaves = [torch.tensor(a, requires_grad=True) for a in [x, *w]]
    y = (vb.fused_attn_block(*leaves, HEADS) if kind == "attn"
         else vb.fused_mlp_block(*leaves))
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    names = (["x", "wqkv", "bqkv", "wo", "bo", "ln_g", "ln_b"]
             if kind == "attn" else
             ["x", "w1", "b1", "w2", "b2", "ln_g", "ln_b"])
    _assert_grads(names, got, want)


@pytest.mark.parametrize("kind", ["attn", "mlp"])
def test_plain_bwd_matches_autograd_of_plain_fwd(kind):
    attn, mlp = _weights(9)
    x, dy = torch.from_numpy(_x(3, 3, 13)), torch.from_numpy(_x(4, 3, 13))
    if kind == "attn":
        args, fwd, bwd = ([x, *map(torch.from_numpy, attn)],
                          lambda *a: vb.attn_block_plain(*a, HEADS),
                          lambda *a: vb.attn_block_bwd_plain(*a, HEADS, dy))
    else:
        args, fwd, bwd = ([x, *map(torch.from_numpy, mlp)],
                          vb.mlp_block_plain,
                          lambda *a: vb.mlp_block_bwd_plain(*a, dy))
    leaves = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(fwd(*leaves), leaves, dy)
    got = bwd(*args)
    assert got[0].dtype == x.dtype and all(
        g.dtype == torch.float32 for g in got[1:])
    _assert_grads(range(7), [g.numpy() for g in got],
                  [w.numpy() for w in want])


def test_block_with_drop_path_matches_jax(monkeypatch):
    """A training block with stochastic depth: the port drops each
    sub-layer's branch around the kernel wrappers' output, the JAX block
    around its unfused path. The JAX block's per-sample keep masks (read
    off its DropPath calls) are handed to the port's DropPath through
    ``torch.rand``; output and every gradient agree."""
    import flax.linen as nn

    rate, b, l = 0.5, 8, 13
    jblock = jax_vit.TransformerBlock(dim=D, num_heads=HEADS, drop_path=rate)
    x, dy = _x(21, b, l), _x(22, b, l)
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    rng = np.random.default_rng(23)
    params = {k: (rng.standard_normal(s.shape) * 0.2
                  + (1.0 if k.endswith("_scale") else 0.0)).astype(np.float32)
              for k, s in shapes.items()}

    drops = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.module.__class__.__name__ == "DropPath":
            drops.append(out)
        return out

    def jfwd(p, x_):
        return jblock.apply({"params": p}, x_, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(3)})

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    with nn.intercept_methods(record):
        jfwd(jparams, jnp.asarray(x))
    kept = [np.abs(np.asarray(o)).reshape(b, -1).max(axis=1) > 0
            for o in drops]
    want, vjp = jax.vjp(jfwd, jparams, jnp.asarray(x))  # the same masks
    assert len(kept) == 2 and all(0 < k.sum() < b for k in kept)
    jgrads, jdx = vjp(jnp.asarray(dy))

    block = vit.TransformerBlock(D, HEADS, drop_path=rate)
    with torch.no_grad():
        for k, v in params.items():
            getattr(block, k).copy_(torch.from_numpy(v))
    draws = [torch.where(torch.from_numpy(k), 0.0, 1.0) for k in kept]

    def rand(shape, **kw):  # DropPath keeps a sample where rand < 1 - rate
        return draws.pop(0).reshape(shape)

    monkeypatch.setattr(torch, "rand", rand)
    tx = torch.tensor(x, requires_grad=True)
    y = block(tx, deterministic=False)
    assert not draws
    err, scale = _err(y.detach(), want)
    assert err <= FWD_RTOL * scale, (err, scale)
    names = list(params)
    got = torch.autograd.grad(y, [tx, *(getattr(block, k) for k in names)],
                              torch.from_numpy(dy))
    _assert_grads(["x", *names], got, [jdx, *(jgrads[k] for k in names)])


# --------------------------------------------------------------------------
# (c) gathers and masking
# --------------------------------------------------------------------------


def test_gathers_and_grads_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 9, 4)).astype(np.float32)
    w_keep = rng.standard_normal((3, 4, 4)).astype(np.float32)
    w_perm = rng.standard_normal((3, 9, 4)).astype(np.float32)
    noise = rng.random((3, 9)).astype(np.float32)
    ids_shuffle = np.argsort(noise, axis=1, kind="stable")
    ids_restore = np.argsort(ids_shuffle, axis=1, kind="stable")
    ids_keep = ids_shuffle[:, :4]

    def jloss(x_):
        a = jax_gather.subset_gather(x_, jnp.asarray(ids_keep),
                                     jnp.asarray(ids_restore))
        b = jax_gather.perm_gather(x_, jnp.asarray(ids_restore))
        c = jax_gather.injective_gather(x_, jnp.asarray(ids_shuffle),
                                        jnp.asarray(ids_restore))
        return (jnp.sum(jnp.sin(a) * w_keep) + jnp.sum(b * w_perm)
                + jnp.sum(c ** 2)), (a, b, c)

    (_, jouts), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ti = {k: torch.from_numpy(v) for k, v in dict(
        keep=ids_keep, restore=ids_restore, shuffle=ids_shuffle).items()}
    a = gather.subset_gather(tx, ti["keep"], ti["restore"])
    b = gather.perm_gather(tx, ti["restore"])
    c = gather.injective_gather(tx, ti["shuffle"], ti["restore"])
    loss = ((torch.sin(a) * torch.from_numpy(w_keep)).sum()
            + (b * torch.from_numpy(w_perm)).sum() + (c ** 2).sum())
    for got, want in zip((a, b, c), jouts):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got_grad,) = torch.autograd.grad(loss, tx)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mask_type", ["random", "region"])
def test_masking_ids_from_shared_noise_match_jax(mask_type):
    """The keep counts come from the same Python float expressions
    (``int(2000 * (1 - 0.85))``, where 1 - 0.85 = 0.15000000000000002), and
    the shuffles are stable argsorts of the same noise: jax.random.uniform
    for random masking, the two halves of jax.random.split for region
    masking."""
    n, l, d = 3, 64, 8
    rng = jax.random.PRNGKey(11)
    x = np.random.default_rng(6).standard_normal((n, l, d)).astype(np.float32)
    if mask_type == "random":
        j_keep, j_mask, j_restore = jax_vit.random_mask_ids(rng, n, l, 0.75)
        noise = np.array(jax.random.uniform(rng, (n, l)))
        p_keep, p_mask, p_restore = vit.random_mask_ids(
            torch.from_numpy(noise), 0.75)
        j_x = jnp.take_along_axis(jnp.asarray(x), j_keep[..., None], axis=1)
        p_x, _, _ = vit.random_masking(torch.from_numpy(x),
                                       torch.from_numpy(noise), 0.75)
    else:
        r1, r2 = jax.random.split(rng)
        idx_out, idx_in = vit.region_split(l)
        noise = np.concatenate([
            np.asarray(jax.random.uniform(r1, (n, len(idx_out)))),
            np.asarray(jax.random.uniform(r2, (n, len(idx_in))))], axis=1)
        j_x, j_mask, j_restore = jax_vit.region_masking(
            rng, jnp.asarray(x), 0.75, 0.85)
        p_keep, p_mask, p_restore = vit.region_mask_ids(
            torch.from_numpy(noise), 0.75, 0.85)
        p_x, p_mask2, _ = vit.region_masking(
            torch.from_numpy(x), torch.from_numpy(noise), 0.75, 0.85)
        torch.testing.assert_close(p_mask2, p_mask)
        j_keep = jnp.argsort(j_restore, axis=1)[:, : p_keep.shape[1]]
        assert p_keep.shape[1] == int(len(idx_out) * 0.25) + int(
            len(idx_in) * (1 - 0.85))
    np.testing.assert_array_equal(p_keep.numpy(), np.asarray(j_keep))
    np.testing.assert_array_equal(p_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(p_restore.numpy(), np.asarray(j_restore))
    np.testing.assert_array_equal(p_x.numpy(), np.asarray(j_x))


def test_patchify_and_pos_embed_match_jax():
    imgs = np.random.default_rng(2).standard_normal((2, 32, 48, 3)).astype(
        np.float32)
    got = vit.patchify(torch.from_numpy(imgs), 16)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_vit.patchify(imgs, 16)))
    back = vit.unpatchify(got, 16, 32, 48, 3)
    np.testing.assert_array_equal(back.numpy(), imgs)
    np.testing.assert_array_equal(vit.sincos_pos_embed_2d(32, 5),
                                  jax_vit.sincos_pos_embed_2d(32, 5))
