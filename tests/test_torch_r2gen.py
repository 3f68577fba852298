"""R2Gen (a ViT tower and the relational-memory transformer) in the port
against the JAX package on CPU, at tiny widths.

(a) ``RelationalMemory`` (3 slots, 4 heads), ``_ref_norm`` (the unbiased
    std, eps on the std) and ``ConditionalLayerNorm`` (the memory at slots
    x d_model), each from one JAX ``init`` loaded strictly: outputs within
    1e-5 of max(1, max |ref|).
(b) ``R2Gen`` (2 layers of 32, 4 heads) on raw features: logits and the
    gradient of every parameter under a random cotangent; then
    ``R2GenPipeline`` (a tiny ViT over two views): the loss within 1e-5
    relative, every gradient within 1e-4 of that tensor's largest (the key
    biases, 0 in exact arithmetic, within 1e-6 of the largest gradient),
    greedy and beam-3 tokens token for token.
(c) The decay mask by flax name equals the JAX package's, and the norms'
    ``gamma``/``beta`` decay.
(d) One epoch of ``fit_r2gen`` on the ``r2gen_iu`` preset (tiny widths, 3
    steps of 10 studies) from the JAX parameters against the JAX
    ``make_train_step`` with ``make_adamw`` over every tensor, on the same
    batches: loss within 1e-5 and grad norm within 1e-4 relative; then a
    validation and a delta.
(e) ``fit`` routes ``r2gen`` to ``fit_r2gen``; the two tasks left raise.
(f) ``model.vision_init`` into R2Gen: a bare ViT tree grafted at
    ``vision/vit/``, every tower tensor bit for bit, no other tensor
    changed.
"""

import json
import re
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.models import r2gen as jax_r2gen
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu.train import train_state as jax_ts
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    flax_named_parameters,
    load_jax_params,
    state_dict_from_jax,
)
from medical_image_analysis_tpu_torch.configs.config import load_config
from medical_image_analysis_tpu_torch.data import datasets
from medical_image_analysis_tpu_torch.models import r2gen
from medical_image_analysis_tpu_torch.models.vit import ViT
from medical_image_analysis_tpu_torch.train import loop
from medical_image_analysis_tpu_torch.train.optim import no_decay_mask

PRESET = (Path(__file__).resolve().parents[1]
          / "medical_image_analysis_tpu_torch" / "configs" / "presets"
          / "r2gen_iu.yaml")
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
ZERO_RTOL = 1e-6
# gradients of 0 in exact arithmetic: the attentions' key biases (a shift
# of every key of a row)
KEY_BIASES = r"(^|\.)(attn_k|k)\.bias$"
VOCAB = 40
R2GEN_KW = dict(d_model=32, d_ff=48, num_layers=2, num_heads=4,
                rm_num_slots=3, rm_num_heads=4)
TINY_VIT = dict(embed_dim=32, depth=1, num_heads=2)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(shapes, seed):
    """Random parameters of the JAX tree's shapes: norm scales and gammas
    near 1, matrices N(0, 1/fan-in), the rest N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        key = path[-1].key
        if key in ("scale", "gamma") or key.endswith("_scale"):
            return jnp.asarray(1.0 + 0.1 * v)
        if leaf.ndim >= 2 and "bias" not in key:
            return jnp.asarray(v / np.sqrt(np.prod(leaf.shape[:-1])))
        return jnp.asarray(0.1 * v)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=OUT_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _grads_close(named, want, zero=KEY_BIASES):
    assert set(named) == set(want)
    largest = max(g.abs().max().item() for g in want.values())
    for name, p in named.items():
        if re.search(zero, name):
            for g in (p.grad, want[name]):
                assert g.abs().max() <= ZERO_RTOL * largest, name
            continue
        err = (p.grad - want[name]).abs().max().item()
        assert err <= GRAD_RTOL * want[name].abs().max().item(), (name, err)


# --------------------------------------------------------------------------
# (a) the memory and the norms
# --------------------------------------------------------------------------


def test_relational_memory_matches_jax():
    x = _normal(np.random.default_rng(0), 2, 6, 16)
    jm = jax_r2gen.RelationalMemory(num_slots=3, d_model=16, num_heads=4)
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    jnp.asarray(x)), 1)
    port = r2gen.RelationalMemory(3, 16, 4)
    load_jax_params(port, params)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 6, 48)
    _close(got.numpy(), want)
    eye = port.init_memory(2)
    assert eye.shape == (2, 3, 16)
    assert torch.equal(eye[0, :, :3], torch.eye(3)) and not eye[:, :, 3:].any()


@pytest.mark.parametrize("width", [8, 513])
def test_ref_norm_matches_jax(width):
    x = 3.0 * _normal(np.random.default_rng(width), 4, width) + 1.5
    want = jax_r2gen._ref_norm(jnp.asarray(x))
    _close(r2gen._ref_norm(torch.from_numpy(x)).numpy(), want)
    # the unbiased std, eps added to it: not torch's LayerNorm
    n = width
    std = np.sqrt(x.var(-1, keepdims=True) * n / (n - 1))
    _close(r2gen._ref_norm(torch.from_numpy(x)).numpy(),
           (x - x.mean(-1, keepdims=True)) / (std + 1e-6))


def test_conditional_layer_norm_matches_jax():
    rng = np.random.default_rng(2)
    x, mem = _normal(rng, 2, 5, 16), _normal(rng, 2, 5, 48)
    jm = jax_r2gen.ConditionalLayerNorm(16)
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    jnp.asarray(x), jnp.asarray(mem)), 3)
    port = r2gen.ConditionalLayerNorm(16, 48)
    load_jax_params(port, params)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(mem))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mem))
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# (b) the model
# --------------------------------------------------------------------------


def test_r2gen_logits_and_grads_match_jax():
    rng = np.random.default_rng(4)
    feats = _normal(rng, 2, 9, 24)
    seq = rng.integers(0, VOCAB, (2, 7)).astype(np.int32)
    jm = jax_r2gen.R2Gen(vocab_size=VOCAB, **R2GEN_KW)
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    jnp.asarray(feats), jnp.asarray(seq)), 5)
    port = r2gen.R2Gen(VOCAB, 24, **R2GEN_KW)
    load_jax_params(port, params)
    cot = _normal(rng, 2, 7, VOCAB)
    want, vjp = jax.vjp(lambda p: jm.apply(p, jnp.asarray(feats),
                                           jnp.asarray(seq)), params)
    got = port(torch.from_numpy(feats), torch.from_numpy(seq))
    _close(got.detach().numpy(), want)
    (got * torch.from_numpy(cot)).sum().backward()
    (grads,) = vjp(jnp.asarray(cot))
    _grads_close(dict(port.named_parameters()), state_dict_from_jax(grads))


def _pipelines():
    jm = jax_r2gen.R2GenPipeline(vocab_size=VOCAB, chosen="vit",
                                 vision_kwargs=dict(TINY_VIT, patch_size=16),
                                 r2gen_kwargs=R2GEN_KW)
    port = r2gen.R2GenPipeline(VOCAB, "vit",
                               dict(TINY_VIT, patch_size=16, img_size=32),
                               R2GEN_KW)
    return jm, port


def test_r2gen_pipeline_loss_grads_and_tokens_match_jax():
    rng = np.random.default_rng(6)
    imgs = _normal(rng, 2, 2, 32, 32, 3)
    tgt = rng.integers(3, VOCAB, (2, 6)).astype(np.int32)
    mask = np.array([[1] * 6, [1] * 4 + [0] * 2], np.int32)
    call = [jnp.asarray(a) for a in (imgs, tgt, mask)]
    jm, port = _pipelines()
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *call), 7)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, *call)))(params)
    load_jax_params(port, params)
    got = port(*(torch.from_numpy(a) for a in (imgs, tgt, mask)))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=OUT_RTOL)
    _grads_close(dict(port.named_parameters()), state_dict_from_jax(grads),
                 KEY_BIASES)
    for beams in (1, 3):
        want = jax.jit(lambda p: jm.apply(
            p, call[0], 8, beams,
            method=jax_r2gen.R2GenPipeline.generate))(params)
        out = port.generate(torch.from_numpy(imgs), 8, beams)
        assert out.shape == (2, 8)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want),
                                      err_msg=f"beams {beams}")


# --------------------------------------------------------------------------
# (c) the decay mask
# --------------------------------------------------------------------------


def test_decay_mask_matches_jax_and_decays_gamma_beta():
    jm, port = _pipelines()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, 32, 32, 3)),
                            jnp.ones((1, 4), jnp.int32),
                            jnp.ones((1, 4), jnp.int32))
    flat = jax.tree_util.tree_flatten_with_path(
        jax_optim.no_decay_mask(shapes["params"]))[0]
    want = {"/".join(k.key for k in path): v for path, v in flat}
    got = no_decay_mask(flax_named_parameters(port))
    assert got == want
    for name in ("r2gen/enc_ln0/gamma", "r2gen/dec_cln2/beta",
                 "r2gen/dec_norm/gamma", "r2gen/rm/w_gate/kernel",
                 "r2gen/dec_cln0/delta_gamma2/kernel"):
        assert got[name], name
    for name in ("r2gen/embed/embedding", "r2gen/rm/w_gate/bias",
                 "vision/vit/block0/ln1_scale", "vision/vit/cls_token"):
        assert not got[name], name


# --------------------------------------------------------------------------
# (d) the recipe
# --------------------------------------------------------------------------


@pytest.fixture
def fixed_pixels(monkeypatch):
    """The synthetic pixels seeded by CRC-32 of the sample id in place of
    Python's per-process string hash (ROADMAP.md, section 3)."""
    monkeypatch.setattr(datasets, "hash",
                        lambda s: zlib.crc32(s.encode()), raising=False)


BATCH, LR = 10, 1e-3  # 32 synthetic train samples: 3 steps


def _task_cfg(save_dir, *extra):
    return load_config(str(PRESET), [
        "data.dataset=synthetic", f"data.batch_size={BATCH}",
        "data.input_size=32", "data.max_len=12", "data.vocab_min_freq=1",
        "data.num_workers=2", "model.vision_kwargs=" + json.dumps(TINY_VIT),
        "model.task_kwargs=" + json.dumps({"r2gen_kwargs": R2GEN_KW}),
        "train.epochs=1", f"train.lr={LR}", "train.warmup_steps=1",
        "train.log_every=100", f"train.save_dir={save_dir}",
        "generate.num_beams=3", "generate.max_new_tokens=4", *extra])


def test_fit_r2gen_matches_jax(tmp_path, fixed_pixels):
    cfg = _task_cfg(tmp_path)
    assert cfg.model.task == "r2gen" and cfg.model.vision == "vit"
    _, tok, batcher, _ = loop.build_data(cfg)
    train_b = batcher("train")
    try:
        batches = list(train_b.batches(epoch=0))
    finally:
        train_b.close()
    steps = len(batches)
    assert steps == 3
    keys = ("images", "target_ids", "target_mask")
    jm = jax_r2gen.R2GenPipeline(
        vocab_size=tok.vocab_size, chosen="vit",
        vision_kwargs=loop.vision_preset("vit", "base", TINY_VIT),
        bos_id=tok.BOS, eos_id=tok.EOS, r2gen_kwargs=R2GEN_KW)
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *(
        jnp.asarray(batches[0][k]) for k in keys)), 8)
    t = cfg.train
    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(LR, 1, steps),
                              weight_decay=t.weight_decay,
                              grad_clip=t.grad_clip, params_for_mask=params)
    step = jax_ts.make_train_step(lambda p, b, _r: jm.apply(
        p, *(b[k] for k in keys)), tx, accum_steps=1, donate=False)
    state = jax_ts.TrainState.create(params, tx)
    want = []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(batch[k]) for k in keys},
                        jax.random.PRNGKey(1))
        want.append((float(m["loss"]), float(m["grad_norm"])))

    def on_start(model, _):
        load_jax_params(model, params)

    scores = loop.fit(cfg, "cpu", on_start=on_start)
    assert np.isfinite(scores["Bleu_4"])
    with open(tmp_path / "log.txt") as f:
        records = list(map(json.loads, f))
    got = [r for r in records if "step" in r]
    assert len(got) == steps
    for i, (r, (loss, norm)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(r["grad_norm"], norm, rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")
    assert sum("val_s" in r for r in records) == 1
    deltas = list(tmp_path.glob("checkpoint_epoch0_*.pt"))
    assert len(deltas) == 1
    meta = torch.load(deltas[0], weights_only=False)["meta"]
    assert meta["config"] == {"task": "r2gen"}


# --------------------------------------------------------------------------
# (e) the dispatch
# --------------------------------------------------------------------------


def test_fit_routes_r2gen_and_refuses_the_rest(monkeypatch, tmp_path):
    """``fit`` routes every task: r2gen to ``fit_r2gen``, mac_rrg to
    ``fit_mrg`` and mamba_lm_sft to ``fit_lm_sft``; none is refused."""
    for name in ("fit_r2gen", "fit_mrg", "fit_lm_sft"):
        monkeypatch.setattr(loop, name, lambda cfg, device, on_start, n=name:
                            (n, cfg.model.task))
    assert loop.fit(_task_cfg(tmp_path), "cpu") == ("fit_r2gen", "r2gen")
    for task, recipe in (("mac_rrg", "fit_mrg"),
                         ("mamba_lm_sft", "fit_lm_sft")):
        assert loop.fit(_task_cfg(tmp_path, f"model.task={task}"),
                        "cpu") == (recipe, task)


# --------------------------------------------------------------------------
# (f) model.vision_init into R2Gen
# --------------------------------------------------------------------------


class _Stop(Exception):
    pass


def _start_params(cfg) -> dict:
    seen = {}

    def on_start(model, _):
        seen.update({n: p.detach().clone()
                     for n, p in flax_named_parameters(model).items()})
        raise _Stop

    with pytest.raises(_Stop):
        loop.fit(cfg, "cpu", on_start=on_start)
    return seen


def test_vision_init_grafts_a_vit_into_r2gen(tmp_path):
    vit = ViT(**loop.vision_preset("vit", "base", TINY_VIT), img_size=32)
    gen = torch.Generator().manual_seed(13)
    with torch.no_grad():
        for p in vit.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    tower = {n: p.detach().clone()
             for n, p in flax_named_parameters(vit).items()}
    path = tmp_path / "vit.pt"
    torch.save(tower, path)
    plain = _start_params(_task_cfg(tmp_path / "plain"))
    grafted = _start_params(_task_cfg(tmp_path / "graft",
                                      f"model.vision_init={path}"))
    assert set(grafted) == set(plain)
    moved = {n for n in plain if not torch.equal(plain[n], grafted[n])}
    assert moved == {f"vision/vit/{n}" for n in tower}
    for n, t in tower.items():
        assert torch.equal(grafted[f"vision/vit/{n}"], t), n
