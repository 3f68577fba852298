"""MambaXray-VL stage 2 (CLIP alignment) of the port against the JAX package
on CPU, at a tiny size.

(a) ``TextEncoder`` (its features and ``pool_eos``, a padded row and an
    empty one) and ``BertModel`` (plain; with query
    tokens, text and cross-attention every other layer with the query FFN;
    query tokens alone into cross-attention every layer) from one JAX
    ``init``: outputs within 1e-5 of max(1, max |y|) (fp32 through two
    layers, reordered sums).
(b) ``clip_loss`` within 1e-6 relative, from the same unit vectors.
(c) ``MambaXrayVLCLIP`` with a tiny ARM (the JAX ``ref`` route, the port's
    plain fused layer) and a scratch or a BERT text tower: the loss within
    1e-5 relative and every parameter's gradient within 1e-4 of that
    tensor's largest (the ARM parity tests' bound). BERT's key biases have
    a gradient of 0 in exact arithmetic (a softmax is unchanged by a shift
    along its keys): there both sides must stay within 1e-7 of 0.
(d) The recipe: ``fit_clip`` on the ``clip_align`` preset (tiny widths, 3
    steps of 10 studies) from the JAX parameters, against the JAX
    ``make_train_step`` with ``make_adamw`` on the same batches: loss
    within 1e-5 relative, grad norm within 1e-4, every parameter's change
    within 1e-3 of that tensor's largest change (the text tower's key
    biases, whose gradients are rounding noise, move each side by under a
    tenth of the learning rate a step); and what ``fit_clip``
    builds by default (the text tower's depth 2 and ``data.max_len``
    positions, ARM-B at the data's image size, ``logit_scale`` a 0-d
    tensor outside weight decay).
"""

import json
import math
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.models import bert as jax_bert
from medical_image_analysis_tpu.models import clip as jax_clip
from medical_image_analysis_tpu.models import mambaxray_vl as jax_vl
from medical_image_analysis_tpu.models import text_encoder as jax_text
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu.train import train_state as jax_ts
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    load_jax_params,
    state_dict_from_jax,
)
from medical_image_analysis_tpu_torch.configs.config import load_config
from medical_image_analysis_tpu_torch.data import datasets
from medical_image_analysis_tpu_torch.models import bert, clip, mambaxray_vl
from medical_image_analysis_tpu_torch.models import text_encoder
from medical_image_analysis_tpu_torch.train import loop, optim

PRESETS = (Path(__file__).resolve().parents[1]
           / "medical_image_analysis_tpu_torch" / "configs" / "presets")
OUT_RTOL = 1e-5
KEY_BIAS_ATOL = 1e-7
TINY_ARM = dict(patch_size=16, embed_dim=32, depth=2, d_state=4)
TINY_TEXT = dict(dim=16, depth=2, num_heads=2, max_len=12)
TINY_BERT = dict(dim=16, n_layers=2, n_heads=2, intermediate=32,
                 max_position=20)
VOCAB = 30


def _params(shapes, seed):
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
        if key == "logit_scale":
            return jnp.asarray(np.float32(math.log(1 / 0.07)))
        return jnp.asarray(0.2 * v)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _text(seed, b, l, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, l)).astype(np.int32)
    lengths = np.array([l, l // 2, 1, 0][:b])
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.int32)
    return ids, mask


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= OUT_RTOL * scale, (err, scale)



@pytest.fixture(autouse=True)
def one_thread():
    """The port's many tiny ops run faster on one thread, and the parallel
    test run shares the cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# --------------------------------------------------------------------------
# (a) the text towers
# --------------------------------------------------------------------------


def test_text_encoder_and_pool_eos_match_jax():
    ids, mask = _text(0, 4, 10)
    jm = jax_text.TextEncoder(vocab_size=VOCAB, **TINY_TEXT)
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    jnp.asarray(ids), jnp.asarray(mask)), 1)
    want = jax.jit(jm.apply)(params, jnp.asarray(ids), jnp.asarray(mask))
    want_pool = jax_text.TextEncoder.pool_eos(want, jnp.asarray(mask))
    port = text_encoder.TextEncoder(vocab_size=VOCAB, **TINY_TEXT)
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got, want)
    pooled = port.pool_eos(got, torch.from_numpy(mask))
    _close(pooled, want_pool)
    # the empty row pools its first token
    np.testing.assert_array_equal(pooled[3].numpy(), got[3, 0].numpy())


def _bert_case(case):
    """(config kwargs, call kwargs)."""
    ids, mask = _text(3, 3, 9)
    rng = np.random.default_rng(4)
    queries = jnp.asarray(rng.standard_normal((3, 4, 16)).astype(np.float32))
    enc = jnp.asarray(rng.standard_normal((3, 7, 16)).astype(np.float32))
    enc_mask = jnp.asarray((np.arange(7)[None] < np.array([[7], [5], [2]]))
                           .astype(np.int32))
    text = dict(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    if case == "plain":
        return {}, text
    if case == "query-text-cross":
        return (dict(cross_attention_freq=2, query_ffn=True),
                dict(text, query_embeds=queries, encoder_hidden_states=enc,
                     encoder_attention_mask=enc_mask))
    return (dict(cross_attention_freq=1, use_embeddings=False),
            dict(query_embeds=queries, encoder_hidden_states=enc,
                 encoder_attention_mask=enc_mask))


@pytest.mark.parametrize("case", ["plain", "query-text-cross", "query-cross"])
def test_bert_model_matches_jax(case):
    extra, call = _bert_case(case)
    cfg = dict(vocab_size=VOCAB, **TINY_BERT, **extra)
    jm = jax_bert.BertModel(jax_bert.BertConfig(**cfg))
    params = _params(jax.eval_shape(
        lambda k: jm.init(k, **call), jax.random.PRNGKey(0)), 5)
    want = jax.jit(lambda p: jm.apply(p, **call))(params)
    port = bert.BertModel(bert.BertConfig(**cfg))
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(**{k: torch.tensor(np.asarray(v))
                      for k, v in call.items()})
    assert got.shape == want.shape
    _close(got, want)


# --------------------------------------------------------------------------
# (b) clip_loss, (c) the model
# --------------------------------------------------------------------------


def test_clip_loss_matches_jax():
    rng = np.random.default_rng(6)
    v, t = (rng.standard_normal((5, 8)).astype(np.float32) for _ in range(2))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    scale = np.float32(1 / 0.07)
    want = float(jax_clip.clip_loss(jnp.asarray(v), jnp.asarray(t),
                                    jnp.asarray(scale)))
    got = clip.clip_loss(torch.from_numpy(v), torch.from_numpy(t),
                         torch.tensor(scale)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _tower_kwargs(tower):
    if tower == "bert":
        return dict(vocab_size=VOCAB, **TINY_BERT)
    return dict(vocab_size=VOCAB, **TINY_TEXT)


@pytest.mark.parametrize("tower", ["scratch", "bert"])
def test_mambaxray_vl_clip_loss_and_grads_match_jax(tower):
    x = np.random.default_rng(7).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    ids, mask = _text(8, 3, 10)
    args = (jnp.asarray(x), jnp.asarray(ids), jnp.asarray(mask))
    jm = jax_vl.MambaXrayVLCLIP(
        arm_kwargs=dict(TINY_ARM, scan_backend="ref"),
        text_kwargs=_tower_kwargs(tower), proj_dim=8, text_tower=tower)
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args),
                     9)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, *args)))(params)
    want = state_dict_from_jax(grads)
    port = mambaxray_vl.MambaXrayVLCLIP(
        arm_kwargs=dict(TINY_ARM, img_size=32),
        text_kwargs=_tower_kwargs(tower), proj_dim=8, text_tower=tower)
    load_jax_params(port, params)
    got = port(*(torch.from_numpy(a) for a in (x, ids, mask)))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    named = dict(port.named_parameters())
    assert set(named) == set(want) and named["head.logit_scale"].dim() == 0
    for name, p in named.items():
        if name.endswith("key.bias"):
            for g in (p.grad, want[name]):
                assert g.abs().max() <= KEY_BIAS_ATOL, name
            continue
        err = (p.grad - want[name]).abs().max().item()
        assert err <= 1e-4 * want[name].abs().max().item(), (name, err)


# --------------------------------------------------------------------------
# (d) the recipe
# --------------------------------------------------------------------------


@pytest.fixture
def fixed_pixels(monkeypatch):
    """The synthetic pixels seeded by CRC-32 of the sample id in place of
    Python's per-process string hash (ROADMAP.md, section 3); both packages
    read the port's batcher here, so they see the same images."""
    monkeypatch.setattr(datasets, "hash",
                        lambda s: zlib.crc32(s.encode()), raising=False)


BATCH, LR, MAX_LEN = 10, 1e-3, 16  # 32 synthetic train samples: 3 steps


def _clip_cfg(save_dir, *extra):
    return load_config(str(PRESETS / "clip_align.yaml"), [
        "data.dataset=synthetic", f"data.batch_size={BATCH}",
        "data.input_size=32", f"data.max_len={MAX_LEN}",
        "data.vocab_min_freq=1", "data.num_workers=2",
        "model.vision_kwargs=" + json.dumps(TINY_ARM), "train.epochs=1",
        f"train.lr={LR}", "train.warmup_steps=1", "train.log_every=100",
        f"train.save_dir={save_dir}", *extra])


def test_fit_clip_matches_jax(tmp_path, fixed_pixels):
    cfg = _clip_cfg(tmp_path)
    assert (cfg.model.task, cfg.model.vision_size) == ("clip", "base")
    _, tok, batcher, _ = loop.build_data(cfg)
    text = dict(vocab_size=tok.vocab_size, dim=16, depth=2, num_heads=2,
                max_len=MAX_LEN)
    cfg.model.task_kwargs = {"proj_dim": 8, "text_kwargs": text}
    jm = jax_vl.MambaXrayVLCLIP(
        arm_kwargs=loop.vision_preset("arm", "base", TINY_ARM),
        text_kwargs=text, proj_dim=8)
    train_b = batcher("train")
    try:
        batches = list(train_b.batches(epoch=0))
    finally:
        train_b.close()
    steps = len(batches)
    assert steps == 3
    keys = ("images", "target_ids", "target_mask")
    first = [jnp.asarray(batches[0][k][:, 0] if k == "images"
                         else batches[0][k]) for k in keys]
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *first),
                     11)
    t = cfg.train
    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(LR, 1, steps),
                              weight_decay=t.weight_decay,
                              grad_clip=t.grad_clip, params_for_mask=params)
    state = jax_ts.TrainState.create(params, tx)
    step = jax_ts.make_train_step(
        lambda p, b, rng: jm.apply(p, b["images"][:, 0], b["target_ids"],
                                   b["target_mask"]), tx, donate=False)
    want = []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(batch[k]) for k in keys},
                        jax.random.PRNGKey(0))
        want.append((float(m["loss"]), float(m["grad_norm"])))

    seen = {}

    def on_start(model, _):
        load_jax_params(model, params)
        seen["model"] = model

    loop.fit(cfg, "cpu", on_start=on_start)
    with open(tmp_path / "log.txt") as f:
        got = [r for r in map(json.loads, f) if "step" in r]
    assert len(got) == steps
    for i, (r, (loss, norm)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(r["grad_norm"], norm, rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")
    start, final = state_dict_from_jax(params), state_dict_from_jax(
        state.params)
    for name, p in seen["model"].named_parameters():
        want_move = (final[name] - start[name]).numpy()
        got_move = (p.detach() - start[name]).numpy()
        if ".qkv_" in name and name.endswith(".bias"):
            # the key third's gradient is rounding noise, far under Adam's
            # eps: each side moves it by a small fraction of lr a step, in
            # signs of its own
            d = want_move.shape[0] // 3
            for move in (got_move[d : 2 * d], want_move[d : 2 * d]):
                assert np.abs(move).max() <= 0.1 * LR * steps, name
            keep = np.r_[0:d, 2 * d : 3 * d]
            got_move, want_move = got_move[keep], want_move[keep]
        err = np.abs(got_move - want_move).max()
        assert err <= 1e-3 * max(np.abs(want_move).max(), 1e-12), (name, err)


def test_fit_clip_default_towers(tmp_path):
    cfg = _clip_cfg(tmp_path)
    model = loop.build_clip_model(cfg, 123, device="meta")
    te = model.text_encoder
    assert isinstance(te, text_encoder.TextEncoder)
    assert (te.depth, te.pos_embed.shape[1], te.tok_embed.num_embeddings,
            te.dim) == (2, MAX_LEN, 123, 768)
    arm = model.visual_encoder
    assert (len(arm.layers), arm.pos_embed.shape[1]) == (2, 5)  # 32^2 / 16^2
    assert model.head.vision_proj.out_features == 2048
    decay = optim.no_decay_mask(["head/logit_scale", "head/text_proj/kernel"])
    assert decay == {"head/logit_scale": False, "head/text_proj/kernel": True}
    cfg.model.task_kwargs = {"text_tower": "bert"}
    te = loop.build_clip_model(cfg, 123, device="meta").text_encoder
    assert isinstance(te, bert.BertModel) and te.cfg.vocab_size == 123
    assert te.cfg == bert.BertConfig(vocab_size=123)
