"""AM-MRG and R2GenKG in the port against the JAX package on CPU, at tiny
widths.

(a) ``AMMRG`` (a tiny ARM, a 1-layer Q-Former of 16 over a 24-wide
    projection, both Hopfield memories) and ``R2GenKG`` (a tiny Swin, a
    1-layer Q-Former, 5 R-GCN scales, the fusion, the cross blocks), each
    from one JAX ``init`` loaded strictly (R2GenKG's fusion holds flax
    ``DenseGeneral`` kernels): the loss within 1e-5 relative, every
    parameter's gradient within 1e-4 of that tensor's largest (a key bias,
    whose gradient is 0 in exact arithmetic, within 1e-6 of the largest
    gradient), and beam-2 generation token for token. ``xdbl_tile`` at
    ARM-L's C=96 takes one direction a block.
(b) The side-input chain from one set of tower parameters: ``swin_grad_cam``
    (cam and tokens), ``build_am_banks`` (the JAX SwinCheX ``init`` of the
    chain's seed loaded into the port's) and ``synthesize_graph_artifacts``
    through ``make_text_embedder(params=...)``: arrays within 1e-5 of
    max(1, max |ref|), the edges equal.
(c) The recipes: ``fit_mrg`` on the ``am_mrg_mimic`` and ``r2genkg_mimic``
    presets (tiny widths, an fp32 LLM, LoRA r2 with random B, 3 steps of 10
    studies) from the JAX parameters and LoRA, against the JAX
    ``make_train_step`` with ``make_adamw`` over the same batches and side
    inputs: loss within 1e-5 relative and the trainable leaves' grad norm
    within 1e-4.
(d) ``model.vision_init`` into AM-MRG: a bare ARM tree grafted at
    ``vision/``, every tower tensor bit for bit, no other tensor changed.
"""

import dataclasses
import json
import re
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.data import side_inputs as jax_side
from medical_image_analysis_tpu.data.tokenizer import (
    WordTokenizer as JaxTokenizer,
)
from medical_image_analysis_tpu.models import am_mrg as jax_am
from medical_image_analysis_tpu.models import llm as jax_llm
from medical_image_analysis_tpu.models import mrg as jax_mrg
from medical_image_analysis_tpu.models import r2gen_kg as jax_kg
from medical_image_analysis_tpu.models import swin as jax_swin
from medical_image_analysis_tpu.models import text_encoder as jax_text
from medical_image_analysis_tpu.peft import lora as jax_lora
from medical_image_analysis_tpu.train import loop as jax_loop
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu.train import train_state as jax_ts
from medical_image_analysis_tpu.utils import cam as jax_cam
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    flax_named_parameters,
    load_jax_params,
    lora_from_jax,
    state_dict_from_jax,
)
from medical_image_analysis_tpu_torch.configs.config import load_config
from medical_image_analysis_tpu_torch.data import datasets
from medical_image_analysis_tpu_torch.data import side_inputs
from medical_image_analysis_tpu_torch.data.tokenizer import WordTokenizer
from medical_image_analysis_tpu_torch.models import am_mrg, llm, mrg, r2gen_kg
from medical_image_analysis_tpu_torch.models import swin
from medical_image_analysis_tpu_torch.models.mamba import ARM
from medical_image_analysis_tpu_torch.train import loop
from medical_image_analysis_tpu_torch.utils import cam

PRESETS = (Path(__file__).resolve().parents[1]
           / "medical_image_analysis_tpu_torch" / "configs" / "presets")
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
ZERO_RTOL = 1e-6
# gradients of 0 in exact arithmetic: the key biases, and the Hopfield
# memories' stored-pattern norm bias (no update step reads the keys)
KEY_BIASES = r"(^|\.)(key|k|k_proj|norm_stored)\.bias$"
VOCAB = 40
LLM_KW = dict(dim=32, n_layers=1, n_heads=4, n_kv_heads=2, hidden_dim=64)
TINY_ARM = dict(patch_size=8, embed_dim=16, depth=1, d_state=4)
TINY_SWIN = dict(embed_dim=8, depths=(1, 1), num_heads=(2, 2), window_size=4,
                 drop_path_rate=0.0)
AM_KW = dict(qformer_dim=16, qformer_width=24, qformer_layers=1,
             qformer_heads=4)
KG_KW = dict(graph_dim=16, qformer_layers=1, qformer_heads=4,
             num_fusion_heads=4)
GEN = dict(num_beams=2, max_new_tokens=6, min_new_tokens=2,
           repetition_penalty=2.0, length_penalty=2.0, no_repeat_ngram_size=2,
           eos_id=2, max_cache_len=96)


@pytest.fixture(autouse=True)
def one_thread():
    """The port's many tiny ops run faster on one thread, and the parallel
    test run shares the cores among its workers."""
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


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=OUT_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _llm_cfgs(vocab=VOCAB):
    return (jax_llm.LLMConfig(vocab_size=vocab, **LLM_KW, dtype=jnp.float32),
            llm.LLMConfig(vocab_size=vocab, **LLM_KW, dtype=torch.float32))


def _text(rng):
    return [rng.integers(4, VOCAB, (2, 3)).astype(np.int32),
            rng.integers(4, VOCAB, (2, 2)).astype(np.int32),
            rng.integers(4, VOCAB, (2, 5)).astype(np.int32),
            np.array([[1] * 5, [1] * 3 + [0] * 2], np.int32)]


def _graph(rng, scales=5, dim=12, edges=8):
    """Per scale (2 (s + 1) + 1, dim) node features with a zero dummy row,
    ``edges`` edges of which the last two are pads at the dummy row."""
    nf, ei, et = [], [], []
    for s in range(scales):
        n = 2 * (s + 1)
        h = _normal(rng, n + 1, dim)
        h[n] = 0.0
        e = np.full((2, edges), n, np.int32)
        e[:, : edges - 2] = rng.integers(0, n, (2, edges - 2))
        t = np.zeros(edges, np.int32)
        t[: edges - 2] = rng.integers(0, 3, edges - 2)
        nf.append(h)
        ei.append(e)
        et.append(t)
    return nf, ei, et


def _check_model(jm, port, call, gen, seed):
    """Loss and every gradient, then beam-2 tokens, from one set of
    parameters (loaded strictly into ``port``)."""
    jcall = jax.tree_util.tree_map(jnp.asarray, call)
    params = _params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), *jcall)), seed)
    gcfg = jax_mrg.GenerateConfig(**GEN)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, *jcall)))(params)
    tokens = jax.jit(lambda p: jm.apply(
        p, *[jcall[i] for i in gen], gcfg, method=type(jm).generate))(params)
    load_jax_params(port, params)
    tcall = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                   call)
    got = port(*tcall)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=OUT_RTOL)
    want = state_dict_from_jax(grads)
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    largest = max(g.abs().max().item() for g in want.values())
    for name, p in named.items():
        if re.search(KEY_BIASES, name):
            for g in (p.grad, want[name]):
                assert g.abs().max() <= ZERO_RTOL * largest, name
            continue
        err = (p.grad - want[name]).abs().max().item()
        assert err <= GRAD_RTOL * want[name].abs().max().item(), (name, err)
    out = port.generate(*[tcall[i] for i in gen], mrg.GenerateConfig(**GEN))
    assert out.shape == (2, GEN["max_new_tokens"])
    np.testing.assert_array_equal(out.numpy(), np.asarray(tokens))
    return params


# --------------------------------------------------------------------------
# (a) the models
# --------------------------------------------------------------------------


def test_am_mrg_loss_grads_and_tokens_match_jax():
    rng = np.random.default_rng(0)
    call = [_normal(rng, 2, 2, 32, 32, 3), _normal(rng, 18, 16),
            _normal(rng, 11, 12), *_text(rng)]
    jcfg, pcfg = _llm_cfgs()
    jm = jax_am.AMMRG(llm_cfg=jcfg, arm_kwargs=dict(TINY_ARM,
                                                     scan_backend="ref"),
                      **AM_KW)
    port = am_mrg.AMMRG(pcfg, arm_kwargs=dict(TINY_ARM, img_size=32),
                        visual_bank_dim=16, report_bank_dim=12, **AM_KW)
    assert port.visual_memory.assoc.q_proj.out_features == 6 * 21
    _check_model(jm, port, call, (0, 1, 2, 3, 4), 1)


def test_r2gen_kg_loss_grads_and_tokens_match_jax():
    """Node features 12 wide and a disease bank 10 wide (the widths the JAX
    ``Dense`` layers infer), the fusion's ``DenseGeneral`` kernels loaded
    through ``ckpt/from_jax.py``."""
    rng = np.random.default_rng(2)
    nf, ei, et = _graph(rng)
    call = [_normal(rng, 2, 2, 32, 32, 3), nf, ei, et, _normal(rng, 9, 10),
            *_text(rng)]
    jcfg, pcfg = _llm_cfgs()
    jm = jax_kg.R2GenKG(llm_cfg=jcfg, vision_kwargs=TINY_SWIN, **KG_KW)
    port = r2gen_kg.R2GenKG(pcfg, vision_kwargs=dict(TINY_SWIN, img_size=32),
                            node_dim=12, bank_dim=10, **KG_KW)
    params = _check_model(jm, port, call, (0, 1, 2, 3, 4, 5, 6), 3)
    kernel = params["params"]["fusion"]["attn0"]["query"]["kernel"]
    assert kernel.shape == (16, 4, 4)


@pytest.mark.parametrize("b,tile", [(12, (64, 1, 2)), (4, (64, 1, 4)),
                                    (1, (64, 1, 8))])
def test_xdbl_tile_at_arm_large(b, tile):
    """At ARM-L's C=96 (dt rank 64) a block of both directions holds 80
    columns at most, so ``xdbl_tile`` takes one direction a block, whose
    two halves of warps hold all 96: the fastest tile of an H100 sweep at
    the training step's 12 images, validation's 4 and one image."""
    from medical_image_analysis_tpu_torch.ops import mamba_fused as mf

    assert mf.xdbl_block_cols(64, 2, 96) < 96 <= mf.xdbl_block_cols(64, 1, 96)
    assert mf.xdbl_tile(b, 4, 197, 1024, 96, 132) == tile


# --------------------------------------------------------------------------
# (b) the side-input chain
# --------------------------------------------------------------------------


def _chexswin(jax_side_kw=None):
    kw = dict(embed_dim=16, depths=(1, 1), num_heads=(2, 2), window_size=4,
              drop_path_rate=0.0)
    kw.update(jax_side_kw or {})
    return (jax_swin.SwinCheX(backbone=jax_swin.SwinTransformer(**kw),
                              num_classes=14),
            swin.SwinCheX(swin.SwinTransformer(**kw, img_size=32),
                          num_classes=14))


def test_swin_grad_cam_matches_jax():
    x = _normal(np.random.default_rng(4), 3, 32, 32, 3)
    jm, port = _chexswin()
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    jnp.asarray(x)), 5)
    load_jax_params(port, params)
    for c in (0, 13):
        want_cam, want_tok = jax.jit(
            lambda p, a: jax_cam.swin_grad_cam(jm, p, a, c))(params,
                                                             jnp.asarray(x))
        got_cam, got_tok = cam.swin_grad_cam(port, torch.from_numpy(x), c)
        assert got_cam.shape == (3, 4, 4)
        _close(got_tok.numpy(), want_tok)
        _close(got_cam.numpy(), want_cam)


def _corpus():
    ann = datasets.synthetic_annotations()
    reports = [s.report for s in ann["train"]]
    return (ann, JaxTokenizer.from_corpus(reports, min_freq=1),
            WordTokenizer.from_corpus(reports, min_freq=1))


def _text_params(tok, dim=16):
    jm = jax_text.TextEncoder(vocab_size=tok.vocab_size, dim=dim, depth=2,
                              num_heads=4, max_len=64)
    return jm, _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                      jnp.ones((1, 4), jnp.int32),
                                      jnp.ones((1, 4), jnp.int32)), 6)


def _jitted_embedder(jm, tok, params):
    """JAX ``make_text_embedder(params=...)``'s ``embed``, jitted (it runs
    op by op, seconds a call on this CPU)."""
    run = jax.jit(lambda p, i, m: jax_text.TextEncoder.pool_eos(
        jm.apply(p, i, m), m))

    def embed(texts):
        pairs = [tok.pad(tok.encode(t, max_len=jm.max_len - 1, add_eos=True),
                         jm.max_len) for t in texts]
        ids, masks = (jnp.asarray([p[i] for p in pairs], jnp.int32)
                      for i in (0, 1))
        return np.asarray(run(params, ids, masks), np.float32)

    return embed


def test_text_embedder_matches_jax():
    ann, jtok, ptok = _corpus()
    jm, params = _text_params(jtok)
    texts = [s.report for s in ann["train"][:5]] + ["", "effusion"]
    want = jax_side.make_text_embedder(jtok, dim=16, params=params)(texts)
    _close(_jitted_embedder(jm, jtok, params)(texts), want)
    got = side_inputs.make_text_embedder(ptok, dim=16, params=params)(texts)
    assert got.dtype == np.float32
    _close(got, want)


def test_am_banks_match_jax(monkeypatch):
    """The JAX chain with its SwinCheX's ``init`` returning one set of
    parameters, which the port's chain loads (``swin_params``); its
    GradCAM jitted (the class index traced), and the report memory's
    embedder taking one set of parameters on both sides."""
    ann, jtok, ptok = _corpus()
    loader = datasets.synthetic_image_loader(32, 2)
    jtext, text_params = _text_params(jtok)
    samples = ann["train"]
    imgs = np.stack([loader(s)[0] for s in samples[:8]]).astype(np.float32)
    jm, _ = _chexswin()
    swin_params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                         jnp.asarray(imgs)), 9)
    monkeypatch.setattr(jax_swin.SwinCheX, "init",
                        lambda self, *a, **k: swin_params)
    grad_cam = jax.jit(jax_cam.swin_grad_cam, static_argnums=0)
    monkeypatch.setattr(jax_side, "swin_grad_cam", grad_cam)
    kw = dict(bank_dim=24, report_memory_size=20, visual_max_features=40)
    want = jax_side.build_am_banks(
        samples, loader, _jitted_embedder(jtext, jtok, text_params), **kw)
    got = side_inputs.build_am_banks(
        samples, loader, side_inputs.make_text_embedder(
            ptok, dim=16, params=text_params), **kw, swin_params=swin_params)
    assert got[0].shape == (14 + 40, 24) and got[1].shape == (20, 24)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        _close(g, w)


def test_graph_artifacts_match_jax():
    ann, jtok, ptok = _corpus()
    jm, params = _text_params(jtok)
    reports = [s.report for s in ann["train"]]
    kw = dict(num_scales=5, base_nodes=3, edges_per_scale=12,
              disease_bank_size=20)
    want = jax_side.synthesize_graph_artifacts(
        reports, _jitted_embedder(jm, jtok, params), **kw)
    got = side_inputs.synthesize_graph_artifacts(
        reports, side_inputs.make_text_embedder(ptok, dim=16, params=params),
        **kw)
    for key in ("edge_indices", "edge_types"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(got["node_feats"], want["node_feats"]):
        _close(g, w)
    _close(got["disease_bank"], want["disease_bank"])
    assert got["node_feats"][4].shape == (16, 16)


# --------------------------------------------------------------------------
# (c) the recipes
# --------------------------------------------------------------------------


@pytest.fixture
def fixed_pixels(monkeypatch):
    """The synthetic pixels seeded by CRC-32 of the sample id in place of
    Python's per-process string hash (ROADMAP.md, section 3); both packages
    read the port's batcher here, so they see the same images."""
    monkeypatch.setattr(datasets, "hash",
                        lambda s: zlib.crc32(s.encode()), raising=False)


@pytest.fixture
def fp32_llm(monkeypatch):
    """The preset's LLM at the tiny widths in fp32 (``llm_kwargs`` cannot
    name a dtype), so that both packages compute in fp32."""
    base = loop.LLM_CONFIGS["qwen1_5_1_8b"]
    monkeypatch.setitem(loop.LLM_CONFIGS, "qwen1_5_1_8b",
                        dataclasses.replace(base, dtype=torch.float32))


BATCH, LR, RANK = 10, 1e-3, 2  # 32 synthetic train samples: 3 steps
TASKS = {
    "am_mrg": ("am_mrg_mimic.yaml", TINY_ARM, AM_KW,
               {"dim": 16, "bank_dim": 24}),
    "r2gen_kg": ("r2genkg_mimic.yaml", TINY_SWIN, KG_KW,
                 {"dim": 12, "base_nodes": 2, "edges_per_scale": 8,
                  "disease_bank_size": 10}),
}


def _task_cfg(task, save_dir, *extra):
    preset, vision, task_kw, si = TASKS[task]
    return load_config(str(PRESETS / preset), [
        "data.dataset=synthetic", f"data.batch_size={BATCH}",
        "data.input_size=32", "data.max_len=16", "data.vocab_min_freq=1",
        "data.num_workers=2", "model.vision_kwargs=" + json.dumps(vision),
        "model.llm_kwargs=" + json.dumps(LLM_KW),
        "model.task_kwargs=" + json.dumps(task_kw),
        "model.side_inputs=" + json.dumps(si), f"train.lora_rank={RANK}",
        "train.epochs=1", f"train.lr={LR}", "train.warmup_steps=1",
        "train.log_every=100", f"train.save_dir={save_dir}",
        "generate.num_beams=2", "generate.max_new_tokens=3",
        "generate.min_new_tokens=1", *extra])


def _jax_model(task, cfg, vocab, side):
    t = cfg.train
    llm_cfg = jax_llm.LLMConfig(vocab_size=vocab, **LLM_KW, dtype=jnp.float32,
                                remat=t.remat)
    vk = jax_loop.vision_preset(cfg.model.vision, cfg.model.vision_size,
                                cfg.model.vision_kwargs)
    if task == "am_mrg":
        return jax_am.AMMRG(llm_cfg=llm_cfg,
                            arm_kwargs=dict(vk, scan_backend="ref",
                                            remat=t.remat),
                            **cfg.model.task_kwargs)
    return jax_kg.R2GenKG(llm_cfg=llm_cfg, vision_kwargs=vk,
                          **cfg.model.task_kwargs)


@pytest.mark.parametrize("task", list(TASKS))
def test_fit_mrg_matches_jax(task, tmp_path, fixed_pixels, fp32_llm):
    cfg = _task_cfg(task, tmp_path)
    assert cfg.model.task == task and cfg.train.lora_llm
    ann, tok, batcher, loader = loop.build_data(cfg)
    ad = loop.make_task_adapter(cfg, ann, tok, loader, "cpu")
    side = [np.asarray(v) for v in ad.side.values()]
    if task == "r2gen_kg":
        n = cfg.model.task_kwargs.get("num_scales", 5)
        side = [side[:n], side[n : 2 * n], side[2 * n : 3 * n], side[-1]]
    train_b = batcher("train")
    try:
        batches = list(train_b.batches(epoch=0))
    finally:
        train_b.close()
    steps = len(batches)
    assert steps == 3
    keys = ("images", "before_ids", "after_ids", "target_ids", "target_mask")

    def call(b):
        return [b["images"], *side, *(b[k] for k in keys[1:])]

    jm = _jax_model(task, cfg, tok.vocab_size, side)
    jside = jax.tree_util.tree_map(jnp.asarray, side)
    params = _params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), *jax.tree_util.tree_map(
            jnp.asarray, call(batches[0])))), 7)
    rules = jax_lora.llama_qv_rules(rank=RANK)
    lora = jax_lora.init_lora(jax.random.PRNGKey(2), params, rules)
    rng = np.random.default_rng(8)
    lora = {k: {"a": v["a"], "b": jnp.asarray(_normal(rng, *v["b"].shape)
                                              * 0.05)}
            for k, v in lora.items()}
    # the frozen LLM closed over, so that the step's grad norm is the
    # trainable leaves' (the port's definition)
    frozen_llm = params["params"]["llm"]
    trainable = {"params": {k: v for k, v in params["params"].items()
                            if k != "llm"}}
    train_params = {"base": trainable, "lora": lora}
    t = cfg.train
    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(LR, 1, steps),
                              weight_decay=t.weight_decay,
                              grad_clip=t.grad_clip,
                              params_for_mask=train_params)

    def jax_loss(p, b, _rng):
        base = {"params": {**p["base"]["params"], "llm": frozen_llm}}
        merged = jax_lora.apply_lora(base, p["lora"], rules)
        return jm.apply(merged, b["images"], *jside,
                        *(b[k] for k in keys[1:]))

    step = jax_ts.make_train_step(jax_loss, tx, accum_steps=1, donate=False)
    state = jax_ts.TrainState.create(train_params, tx)
    want = []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(batch[k]) for k in keys},
                        jax.random.PRNGKey(1))
        want.append((float(m["loss"]), float(m["grad_norm"])))

    plora = lora_from_jax(lora)

    def on_start(model, pstate):
        # the LoRA-parametrized weights hold their base as ``original``
        own = model.state_dict()
        model.load_state_dict({
            k if k in own else k.replace(
                ".weight", ".parametrizations.weight.original"): v
            for k, v in state_dict_from_jax(params).items()})
        with torch.no_grad():
            for key, ab in plora.items():
                for part, tensor in ab.items():
                    pstate.params[f"lora/{key}/{part}"].copy_(tensor)

    scores = loop.fit(cfg, "cpu", on_start=on_start)
    assert np.isfinite(scores["val_score"])
    with open(tmp_path / "log.txt") as f:
        records = list(map(json.loads, f))
    got = [r for r in records if "step" in r]
    assert len(got) == steps
    for i, (r, (loss, norm)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(r["grad_norm"], norm, rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")
    shapes = next(r["side_inputs"] for r in records if "side_inputs" in r)
    assert shapes == {k: list(v.shape) for k, v in ad.side.items()}


# --------------------------------------------------------------------------
# (d) model.vision_init into AM-MRG
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


def test_vision_init_grafts_a_bare_arm_into_am_mrg(tmp_path):
    arm = ARM(**loop.vision_preset("arm", "large", TINY_ARM), img_size=32)
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in arm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    tower = {n: p.detach().clone()
             for n, p in flax_named_parameters(arm).items()}
    path = tmp_path / "arm.pt"
    torch.save(tower, path)
    plain = _start_params(_task_cfg("am_mrg", tmp_path / "plain"))
    grafted = _start_params(_task_cfg("am_mrg", tmp_path / "graft",
                                      f"model.vision_init={path}"))
    assert set(grafted) == set(plain)
    moved = {n for n in plain if not torch.equal(plain[n], grafted[n])}
    assert moved == {f"vision/{n}" for n in tower}
    for n, t in tower.items():
        assert torch.equal(grafted[f"vision/{n}"], t), n
