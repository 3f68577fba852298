"""MAC-RRG (a Swin tower, the agents' rag and concept embeddings, an LLM)
in the port against the JAX package on CPU, at tiny widths.

(a) The agents in numpy, over one deterministic numpy embedder in both
    packages: the alias dictionary, the relations and the chunk corpus of
    ``MACContext``, each draft's entities, links, searcher indices, and
    rag and concept arrays, all equal; ``graph_attention_embed`` returns
    ``central + w @ neighbors``.
(b) ``MACRRG`` from one JAX ``init`` loaded strictly: ``encode_img`` and
    the loss within 1e-5 relative, every parameter's gradient within 1e-4
    of that tensor's largest, and greedy and beam-2 tokens token for
    token.
(c) ``fit_mrg`` on the ``mac_rrg_mimic`` preset (tiny widths, an fp32
    LLM, LoRA r2 with random B, 3 steps of 10 studies, the agents' arrays
    in every batch) from the JAX parameters and LoRA, against the JAX
    ``make_train_step`` with ``make_adamw`` over the same batches: loss
    within 1e-5 relative and the trainable leaves' grad norm within 1e-4.
    A run from the seed, then ``cli.mac_refine`` on its delta, whose merge
    gives back the trained tensors bit for bit.
(d) ``refine_mac_rrg`` end to end in both packages, from one set of
    parameters and the numpy embedder: the draft and refined reports and
    their scores equal; and the routing of ``fit``.
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

from medical_image_analysis_tpu.agents import kg_agent as jax_kg
from medical_image_analysis_tpu.agents import rag_agent as jax_rag
from medical_image_analysis_tpu.configs import config as jax_config
from medical_image_analysis_tpu.data import side_inputs as jax_side
from medical_image_analysis_tpu.models import llm as jax_llm
from medical_image_analysis_tpu.models import mac_rrg as jax_mac
from medical_image_analysis_tpu.models import mrg as jax_mrg
from medical_image_analysis_tpu.peft import lora as jax_lora
from medical_image_analysis_tpu.train import loop as jax_loop
from medical_image_analysis_tpu.train import mac_driver as jax_driver
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu.train import train_state as jax_ts
from medical_image_analysis_tpu_torch.agents import kg_agent, rag_agent
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    flax_named_parameters,
    load_jax_params,
    lora_from_jax,
    state_dict_from_jax,
)
from medical_image_analysis_tpu_torch.cli import mac_refine
from medical_image_analysis_tpu_torch.configs.config import load_config
from medical_image_analysis_tpu_torch.data import datasets, side_inputs
from medical_image_analysis_tpu_torch.models import llm, mac_rrg, mrg
from medical_image_analysis_tpu_torch.train import loop, mac_driver

PRESET = (Path(__file__).resolve().parents[1]
          / "medical_image_analysis_tpu_torch" / "configs" / "presets"
          / "mac_rrg_mimic.yaml")
JAX_PRESET = (Path(__file__).resolve().parents[1]
              / "medical_image_analysis_tpu" / "configs" / "presets"
              / "mac_rrg_mimic.yaml")
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
ZERO_RTOL = 1e-6
KEY_BIASES = r"(^|\.)(key|k|k_proj)\.bias$"
VOCAB = 40
EMBED_DIM = 12
LLM_KW = dict(dim=32, n_layers=1, n_heads=4, n_kv_heads=2, hidden_dim=64)
TINY_SWIN = dict(embed_dim=8, depths=(1, 1), num_heads=(2, 2), window_size=4,
                 drop_path_rate=0.0)
GEN = dict(num_beams=2, max_new_tokens=6, min_new_tokens=2,
           repetition_penalty=2.0, length_penalty=2.0, no_repeat_ngram_size=2,
           eos_id=2, max_cache_len=96)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_embed(texts):
    """A deterministic numpy embedder: each text's vector drawn from the
    CRC-32 of its bytes, with ``right`` read as ``left``, so that chunks
    that differ only in the side tie and the searcher meets ties."""
    out = []
    for t in texts:
        key = zlib.crc32(t.replace("right", "left").encode())
        out.append(np.random.default_rng(key).standard_normal(EMBED_DIM))
    return np.asarray(out, np.float32)


def _params(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        key = path[-1].key
        if key == "scale":
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


# --------------------------------------------------------------------------
# (a) the agents
# --------------------------------------------------------------------------


def _reports():
    ann = datasets.synthetic_annotations()
    learn = datasets.learnable_synthetic_annotations(n_train=64)
    return ([s.report for s in ann["train"] + learn["train"]],
            [s.draft for s in ann["val"] + learn["val"][:8]])


@pytest.fixture(scope="module")
def contexts():
    reports, drafts = _reports()
    kw = dict(max_chunks=6, max_entities=5)
    return (jax_side.MACContext(reports, np_embed, **kw),
            side_inputs.MACContext(reports, np_embed, **kw), drafts)


def test_alias_dict_relations_and_chunks_match_jax(contexts):
    want, got, _ = contexts
    assert got.alias_dict == want.alias_dict
    assert list(got.alias_dict) == list(want.alias_dict)
    assert got.relations == want.relations
    assert got.chunks == want.chunks
    np.testing.assert_array_equal(got.searcher.doc_vecs,
                                  want.searcher.doc_vecs)
    reports, _ = _reports()
    for n in (0, 7):
        assert (side_inputs.build_relations(reports, got.alias_dict, n)
                == jax_side.build_relations(reports, want.alias_dict, n))
    # substring matching: "effusion" inside "effusions" counts
    rel = side_inputs.build_relations(["small effusions and edema"],
                                      {"effusion": "E", "edema": "D"})
    assert rel == [("E", "co_occurs", "D")]


def test_entities_links_and_searcher_match_jax(contexts):
    want, got, drafts = contexts
    ties = 0
    for draft in drafts + ["none", "", "Edema . EDEMA and edema-like",
                           "right pleural effusion"]:
        ents = kg_agent.merge_entities(kg_agent.preprocess_report(
            draft, got.alias_dict))
        assert ents == jax_kg.merge_entities(jax_kg.preprocess_report(
            draft, want.alias_dict))
        assert (kg_agent.extract_entity_links(got.relations, ents, 3)
                == jax_kg.extract_entity_links(want.relations, ents, 3))
        for e in ents:
            hits = got.searcher.search(e, 2)
            assert hits == want.searcher.search(e, 2)
            q = np_embed([e])[0]
            scores = got.searcher.doc_vecs @ (q / np.linalg.norm(q))
            ties += len(scores) - len(np.unique(scores))
        hits = [want.searcher.search(e, 2) for e in ents]
        assert (rag_agent.merge_dedup_chunks_only(hits)
                == jax_rag.merge_dedup_chunks_only(hits))
    assert ties > 0
    # word boundaries: "effusion" is not found inside "effusions"
    assert kg_agent.preprocess_report("effusions", {"effusion": "E"}) == []
    assert kg_agent.preprocess_report("an effusion.", {"effusion": "E"}) == [
        "E"]


def test_agent_embeds_match_jax(contexts):
    want, got, drafts = contexts
    nonzero = 0
    for draft in drafts + ["none"]:
        g_rag, g_con = got.agent_embeds(draft)
        w_rag, w_con = want.agent_embeds(draft)
        assert g_rag.dtype == g_con.dtype == np.float32
        assert g_rag.shape == (6, EMBED_DIM) and g_con.shape == (5, EMBED_DIM)
        np.testing.assert_array_equal(g_rag, w_rag)
        np.testing.assert_array_equal(g_con, w_con)
        nonzero += bool(g_rag.any() and g_con.any())
        g_rag2, g_mask = rag_agent.encode_rag(
            draft, got.alias_dict, got.searcher, np_embed, topk=2,
            max_chunks=6)
        w_rag2, w_mask = jax_rag.encode_rag(
            draft, want.alias_dict, want.searcher, np_embed, topk=2,
            max_chunks=6)
        np.testing.assert_array_equal(g_rag2, w_rag2)
        np.testing.assert_array_equal(g_mask, w_mask)
    assert nonzero >= len(drafts) // 2
    sample = datasets.Sample("x", [], "heart size is normal .", draft=None)
    extra = got.extra_fn(sample)
    np.testing.assert_array_equal(extra["rag_embeds"],
                                  want.agent_embeds(sample.report)[0])


def test_graph_attention_and_empty_concepts_match_jax():
    rng = np.random.default_rng(0)
    c, nb, ed = _normal(rng, 8), _normal(rng, 3, 8), _normal(rng, 3, 8)
    got = kg_agent.graph_attention_embed(c, nb, ed)
    np.testing.assert_array_equal(got, jax_kg.graph_attention_embed(c, nb,
                                                                    ed))
    s = (nb + ed) @ c / np.sqrt(8)
    w = np.exp(s - s.max()) / np.exp(s - s.max()).sum()
    np.testing.assert_allclose(got, c + w @ nb, rtol=1e-6)
    assert kg_agent.graph_attention_embed(c, nb[:0], ed[:0]) is c
    calls = []

    def embed(texts):
        calls.append(list(texts))
        return np_embed(texts)

    out = kg_agent.encode_concepts("nothing here", {"effusion": "E"}, [],
                                   embed, max_entities=4)
    assert out.shape == (4, EMBED_DIM) and not out.any()
    assert calls == [["none"]]


# --------------------------------------------------------------------------
# (b) the model
# --------------------------------------------------------------------------


def _llm_cfgs(vocab=VOCAB):
    return (jax_llm.LLMConfig(vocab_size=vocab, **LLM_KW, dtype=jnp.float32),
            llm.LLMConfig(vocab_size=vocab, **LLM_KW, dtype=torch.float32))


@pytest.fixture(scope="module")
def tiny_model():
    """One JAX ``MACRRG`` (rag rows 12 wide, concept rows 10 wide), its
    parameters, the loss and gradients, and the port loaded strictly."""
    rng = np.random.default_rng(1)
    call = [_normal(rng, 2, 2, 32, 32, 3), _normal(rng, 2, 3, 12),
            _normal(rng, 2, 4, 10),
            rng.integers(4, VOCAB, (2, 3)).astype(np.int32),
            rng.integers(4, VOCAB, (2, 2)).astype(np.int32),
            rng.integers(4, VOCAB, (2, 5)).astype(np.int32),
            np.array([[1] * 5, [1] * 3 + [0] * 2], np.int32)]
    call[1][1, 2:] = 0.0  # zero-padded rows still take the bias
    jcfg, pcfg = _llm_cfgs()
    jm = jax_mac.MACRRG(llm_cfg=jcfg, vision_kwargs=TINY_SWIN)
    jcall = [jnp.asarray(a) for a in call]
    params = _params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), *jcall)), 2)
    (loss, img), grads = jax.jit(jax.value_and_grad(
        lambda p: (jm.apply(p, *jcall), jm.apply(
            p, *jcall[:3], method=jax_mac.MACRRG.encode_img)),
        has_aux=True))(params)
    port = mac_rrg.MACRRG(pcfg, vision_kwargs=dict(TINY_SWIN, img_size=32),
                          rag_dim=12, concept_dim=10)
    load_jax_params(port, params)
    return dict(jm=jm, call=call, jcall=jcall, params=params, loss=loss,
                img=img, grads=grads, port=port)


def test_mac_rrg_encode_img_loss_and_grads_match_jax(tiny_model):
    m = tiny_model
    port = m["port"]
    tcall = [torch.from_numpy(a) for a in m["call"]]
    img = port.encode_img(*tcall[:3])
    # 16 image tokens of the tiny Swin (32^2 / 4^2 patches, one merge),
    # then 3 rag and 4 concept rows
    assert img.shape == (2, 16 + 3 + 4, LLM_KW["dim"])
    _close(img.detach().numpy(), m["img"])
    port.zero_grad()
    got = port(*tcall)
    got.backward()
    np.testing.assert_allclose(got.item(), float(m["loss"]), rtol=OUT_RTOL)
    want = state_dict_from_jax(m["grads"])
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
    assert port.proj_norm.eps == 1e-6


@pytest.mark.parametrize("beams", [1, 2])
def test_mac_rrg_tokens_match_jax(tiny_model, beams):
    m = tiny_model
    gen = dict(GEN, num_beams=beams)
    want = jax.jit(lambda p: m["jm"].apply(
        p, *m["jcall"][:5], jax_mrg.GenerateConfig(**gen),
        method=jax_mac.MACRRG.generate))(m["params"])
    out = m["port"].generate(*[torch.from_numpy(a) for a in m["call"][:5]],
                             mrg.GenerateConfig(**gen))
    assert out.shape == (2, GEN["max_new_tokens"])
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# (c) the recipe and a refinement from its delta
# --------------------------------------------------------------------------


@pytest.fixture
def fp32_llm(monkeypatch):
    """The preset's LLM at the tiny widths in fp32, in both packages."""
    base = loop.LLM_CONFIGS["qwen1_5_1_8b"]
    monkeypatch.setitem(loop.LLM_CONFIGS, "qwen1_5_1_8b",
                        dataclasses.replace(base, dtype=torch.float32))
    jbase = jax_loop.LLM_CONFIGS["qwen1_5_1_8b"]
    monkeypatch.setitem(jax_loop.LLM_CONFIGS, "qwen1_5_1_8b",
                        dataclasses.replace(jbase, dtype=jnp.float32))


BATCH, LR, RANK = 10, 1e-3, 2  # 32 synthetic train samples: 3 steps
SIDE = {"dim": EMBED_DIM, "max_chunks": 4, "max_entities": 3}


def _sets(save_dir, *extra):
    return [
        "data.dataset=synthetic", f"data.batch_size={BATCH}",
        "data.input_size=32", "data.max_len=16", "data.vocab_min_freq=1",
        "data.num_workers=2", "model.vision_kwargs=" + json.dumps(TINY_SWIN),
        "model.llm_kwargs=" + json.dumps(LLM_KW),
        "model.side_inputs=" + json.dumps(SIDE), f"train.lora_rank={RANK}",
        "train.epochs=1", f"train.lr={LR}", "train.warmup_steps=1",
        "train.log_every=100", f"train.save_dir={save_dir}",
        "generate.num_beams=2", "generate.max_new_tokens=3",
        "generate.min_new_tokens=1", *extra]


def test_fit_mrg_matches_jax(tmp_path, fp32_llm):
    cfg = load_config(str(PRESET), _sets(tmp_path))
    assert cfg.model.task == "mac_rrg" and cfg.train.lora_llm
    ann, tok, batcher, loader = loop.build_data(cfg)
    ad = loop.make_task_adapter(cfg, ann, tok, loader, "cpu")
    assert ad.side_dims == {"rag_dim": EMBED_DIM, "concept_dim": EMBED_DIM}
    train_b = batcher("train", extra_fn=ad.extra_fn)
    try:
        batches = list(train_b.batches(epoch=0))
    finally:
        train_b.close()
    assert len(batches) == 3
    assert batches[0]["rag_embeds"].shape == (BATCH, 4, EMBED_DIM)
    assert batches[0]["concept_embeds"].shape == (BATCH, 3, EMBED_DIM)
    assert batches[0]["rag_embeds"].any()
    keys = ("images", "rag_embeds", "concept_embeds", "before_ids",
            "after_ids", "target_ids", "target_mask")

    llm_cfg = jax_llm.LLMConfig(vocab_size=tok.vocab_size, **LLM_KW,
                                dtype=jnp.float32)
    jm = jax_mac.MACRRG(llm_cfg=llm_cfg, vision_kwargs=TINY_SWIN)
    params = _params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *(jnp.asarray(batches[0][k])
                                 for k in keys))), 7)
    rules = jax_lora.llama_qv_rules(rank=RANK)
    lora = jax_lora.init_lora(jax.random.PRNGKey(2), params, rules)
    rng = np.random.default_rng(8)
    lora = {k: {"a": v["a"], "b": jnp.asarray(_normal(rng, *v["b"].shape)
                                              * 0.05)}
            for k, v in lora.items()}
    frozen_llm = params["params"]["llm"]
    train_params = {"base": {"params": {k: v for k, v in
                                        params["params"].items()
                                        if k != "llm"}}, "lora": lora}
    t = cfg.train
    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(LR, 1, 3),
                              weight_decay=t.weight_decay,
                              grad_clip=t.grad_clip,
                              params_for_mask=train_params)

    def jax_loss(p, b, _rng):
        base = {"params": {**p["base"]["params"], "llm": frozen_llm}}
        return jm.apply(jax_lora.apply_lora(base, p["lora"], rules),
                        *(b[k] for k in keys))

    step = jax_ts.make_train_step(jax_loss, tx, accum_steps=1, donate=False)
    state = jax_ts.TrainState.create(train_params, tx)
    want = []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(batch[k]) for k in keys},
                        jax.random.PRNGKey(1))
        want.append((float(m["loss"]), float(m["grad_norm"])))

    plora = lora_from_jax(lora)
    def on_start(model, pstate):
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
    assert len(got) == 3
    for i, (r, (loss, norm)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(r["grad_norm"], norm, rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")
    side = next(r for r in records if "side_inputs" in r)["side_inputs"]
    assert side == {"aliases": len(ad.mac_ctx.alias_dict),
                    "relations": len(ad.mac_ctx.relations),
                    "chunks": len(ad.mac_ctx.chunks)}


def test_refine_from_the_delta_gives_back_the_trained_tensors(tmp_path,
                                                               fp32_llm):
    """A run initialised from the seed on the CPU, then ``cli.mac_refine``
    on its delta: the frozen tensors are the same draws, the delta's are
    merged over them."""
    cfg = load_config(str(PRESET), _sets(tmp_path))
    seen = {}
    loop.fit(cfg, "cpu", on_start=lambda model, state: seen.update(
        state=state))
    pstate = seen["state"]
    trained = {n: p.detach().clone()
               for n, p in {**pstate.params, **pstate.frozen}.items()}
    delta = next(tmp_path.glob("checkpoint_epoch0_*.pt"))
    meta = torch.load(delta, weights_only=True)["meta"]
    assert meta["config"] == {"task": "mac_rrg", "init_device": "cpu"}
    merged = {}

    def on_refine(model, named, ctx):
        merged.update({n: p.detach().clone() for n, p in named.items()})
        merged["ctx"] = ctx

    argv = ["--config", str(PRESET), "--delta", str(delta), "--device", "cpu",
            "--max-batches", "1"]
    for item in _sets(tmp_path / "refine"):
        argv += ["--set", item]
    out = mac_refine.main(argv, on_start=on_refine)
    assert set(merged) - {"ctx"} == set(trained)
    for n, t in trained.items():
        assert torch.equal(merged[n], t), n
    assert merged["ctx"].max_chunks == 4
    assert len(out["reports"]) == 8  # the val split, in one batch of 10
    for key in ("draft", "refined"):
        assert np.isfinite(out[key]["Bleu_4"]) and "ce_f1" in out[key]


# --------------------------------------------------------------------------
# (d) refine_mac_rrg in both packages, and the routing
# --------------------------------------------------------------------------


def test_refine_mac_rrg_matches_jax(tmp_path, monkeypatch, fp32_llm):
    """Both packages' refinements from one set of parameters (random LoRA
    B), the agents over the numpy embedder, two validation batches of 5,
    beam 2."""
    monkeypatch.setattr(jax_side, "make_text_embedder",
                        lambda *a, **k: np_embed)
    monkeypatch.setattr(side_inputs, "make_text_embedder",
                        lambda *a, **k: np_embed)
    sets = _sets(tmp_path, "data.batch_size=5", "generate.max_new_tokens=5",
                 "generate.min_new_tokens=2")
    jcfg = jax_config.load_config(str(JAX_PRESET), sets)
    cfg = load_config(str(PRESET), sets)
    ann, tok, batcher, loader = jax_loop.build_data(jcfg)
    ad = jax_loop.make_task_adapter(jcfg, ann, tok, loader)
    ev = batcher("val", extra_fn=ad.extra_fn)
    first = next(ev.batches(shuffle=False, drop_last=False))
    jm = jax_loop.build_mrg_model(jcfg, tok.vocab_size)
    params = _params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, ad.loss_args(first)))), 11)
    rules = jax_lora.llama_qv_rules(rank=RANK)
    lora = jax_lora.init_lora(jax.random.PRNGKey(2), params, rules)
    rng = np.random.default_rng(12)
    lora = {k: {"a": v["a"], "b": jnp.asarray(_normal(rng, *v["b"].shape)
                                              * 0.5)}
            for k, v in lora.items()}
    want = jax_driver.refine_mac_rrg(
        jcfg, params=jax_lora.apply_lora(params, lora, rules), rounds=1,
        max_batches=2)
    plora = lora_from_jax(lora)

    def on_start(model, named, ctx):
        own = model.state_dict()
        model.load_state_dict({
            k if k in own else k.replace(
                ".weight", ".parametrizations.weight.original"): v
            for k, v in state_dict_from_jax(params).items()})
        with torch.no_grad():
            for key, ab in plora.items():
                for part, tensor in ab.items():
                    named[f"lora/{key}/{part}"].copy_(tensor)
        assert ctx.embed_texts is np_embed

    got = mac_driver.refine_mac_rrg(cfg, rounds=1, max_batches=2,
                                    device="cpu", on_start=on_start)
    assert len(got["reports"]) == 8
    assert got["reports"] == want["reports"]
    for key in ("draft", "refined"):
        assert set(got[key]) == set(want[key])
        for k, v in want[key].items():
            np.testing.assert_allclose(got[key][k], v, rtol=1e-9, err_msg=k)
    assert got["draft"] != got["refined"]


def test_build_mrg_model_builds_mac_rrg():
    cfg = load_config(str(PRESET), _sets("unused"))
    model = loop.build_mrg_model(cfg, VOCAB, device="meta",
                                 side_dims={"rag_dim": 7, "concept_dim": 5})
    assert isinstance(model, mac_rrg.MACRRG)
    assert model.rag_proj.in_features == 7
    assert model.concept_proj.in_features == 5
    assert model.vision.chosen == "swin"
    names = flax_named_parameters(model)
    assert {"proj_norm/scale", "rag_proj/kernel",
            "concept_proj/bias"} <= set(names)
    with pytest.raises(ValueError, match="mac_rrg"):
        mac_driver.refine_mac_rrg(load_config(str(PRESET), [
            "model.task=r2gengpt"]), device="cpu")


def test_mac_refine_cli_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mac_refine.main(["--config", str(PRESET)])
