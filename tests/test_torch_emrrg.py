"""EMRRG (an ARM and the hybrid gated cross-attention decoder) in the port
against the JAX package on CPU, at tiny widths.

(a) ``slow_fast_split`` on an even and an odd patch grid.
(b) ``HybridTransformerLM`` (3 layers, hybrid at 0 and 2, GQA, q/k/v
    biases) from one JAX ``init`` loaded strictly: logits with no cache,
    with the joint cache token by token, and through the split beam cache
    with a non-trivial ancestry, within 1e-4 (fp32 through a few layers).
(c) ``EMRRG`` with and without ``text_only_cross``: the loss within 1e-5
    relative, every gradient within 1e-4 of that tensor's largest (the key
    biases too: rotated per position, their gradient is not 0), greedy and
    beam-3 tokens token for token.
(d) ``unfreeze_hybrid_layers`` under ``freeze_llm``: the port's mask by
    flax name equals the JAX package's.
(e) The fp32-master rule: ``fit_mrg`` on the ``emrrg_iu`` preset (tiny
    widths, the LLM in its bf16 ``cfg.dtype``, hybrid layers 0 and 2 of 3)
    for three steps, two of them at a non-zero learning rate, against the
    JAX ``make_train_step`` on the same batches: each hybrid tensor is
    fp32, the 2-norm of its change's error within 2^-4 of the 2-norm of
    the JAX change, and every frozen LLM tensor is bit for bit unchanged.
    The bound: the two bf16 computes give gradients one bf16 step apart
    (2^-8 of an element), and AdamW divides each step by the root of its
    second moment, so where a gradient sits at that noise the step moves
    by up to 41% of the tensor's largest; no per-element bound holds. The
    norm's error is at most 0.029 (the gate of layer 2); a bf16-stored
    weight rounds most updates away and misses by 0.24 to 0.41.
(f) ``model.vision_init`` into EMRRG: a bare ARM tree grafted at
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

from medical_image_analysis_tpu.models import emrrg as jax_emrrg
from medical_image_analysis_tpu.models import hybrid_decoder as jax_hybrid
from medical_image_analysis_tpu.models import llm as jax_llm
from medical_image_analysis_tpu.models import mrg as jax_mrg
from medical_image_analysis_tpu.train import loop as jax_loop
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu.train import train_state as jax_ts
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    flax_named_parameters,
    load_jax_params,
    state_dict_from_jax,
)
from medical_image_analysis_tpu_torch.configs.config import load_config
from medical_image_analysis_tpu_torch.data import datasets
from medical_image_analysis_tpu_torch.models import emrrg, hybrid_decoder, llm
from medical_image_analysis_tpu_torch.models import mrg
from medical_image_analysis_tpu_torch.models.mamba import ARM
from medical_image_analysis_tpu_torch.train import loop

PRESET = (Path(__file__).resolve().parents[1]
          / "medical_image_analysis_tpu_torch" / "configs" / "presets"
          / "emrrg_iu.yaml")
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
LM_ATOL = 1e-4
# the hybrid tensors' changes after two AdamW steps of bf16 gradients, in
# the 2-norm (see (e) above)
MOVE_RTOL = 2.0**-4
VOCAB = 40
LLM_KW = dict(dim=32, n_layers=3, n_heads=4, n_kv_heads=2, hidden_dim=64)
CROSS_EVERY = 2
TINY_ARM = dict(patch_size=8, embed_dim=16, depth=1, d_state=4)


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


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _llm_cfgs(**extra):
    kw = {"vocab_size": VOCAB, **LLM_KW, "attn_bias": True, **extra}
    return (jax_llm.LLMConfig(**kw, dtype=jnp.float32),
            llm.LLMConfig(**kw, dtype=torch.float32))


# --------------------------------------------------------------------------
# (a) slow_fast_split
# --------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [4, 5])
def test_slow_fast_split_matches_jax(grid):
    x = _normal(np.random.default_rng(grid), 2, grid * grid + 1, 8)
    cls_pos = grid * grid // 2
    want = jax_emrrg.slow_fast_split(jnp.asarray(x), cls_pos)
    got = emrrg.slow_fast_split(torch.from_numpy(x), cls_pos)
    assert got[0].shape == (2, 1 + (grid // 2) ** 2, 8)
    assert got[1].shape == (2, grid * grid, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


# --------------------------------------------------------------------------
# (b) HybridTransformerLM
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["no_cache", "joint_cache", "split_cache"])
def test_hybrid_lm_logits_match_jax(mode):
    jcfg, pcfg = _llm_cfgs()
    rng = np.random.default_rng(5)
    b, lp, nb, lv = 2, 5, 3, 6
    ids = rng.integers(0, VOCAB, (b, lp)).astype(np.int32)
    vision = _normal(rng, b, lv, LLM_KW["dim"])
    pos = np.broadcast_to(np.arange(lp), (b, lp)).astype(np.int32)
    jm = jax_hybrid.HybridTransformerLM(jcfg, cross_every=CROSS_EVERY)
    params = _params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                        vision=jnp.asarray(vision))), 6)
    port = hybrid_decoder.HybridTransformerLM(pcfg, cross_every=CROSS_EVERY)
    load_jax_params(port, params)
    assert [type(x).__name__ for x in port.layers] == [
        "HybridDecoderLayer", "LlamaBlock", "HybridDecoderLayer"]
    apply = jax.jit(jm.apply)

    def run_port(**kw):
        with torch.no_grad():
            return port(**{k: torch.from_numpy(np.ascontiguousarray(v))
                           if isinstance(v, np.ndarray) else v
                           for k, v in kw.items()})

    def close(got, want):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=LM_ATOL)

    if mode == "no_cache":
        mask = np.ones((b, lp), np.int32)
        mask[0, -2:] = 0
        want = apply(params, input_ids=jnp.asarray(ids),
                     vision=jnp.asarray(vision),
                     attention_mask=jnp.asarray(mask))
        close(run_port(input_ids=ids, vision=vision, attention_mask=mask),
              want)
        return

    if mode == "joint_cache":
        # prefill 2 slots of an 8-slot cache, then the rest token by token
        jc = jax_llm.init_cache(jcfg, b, 8)
        pc = llm.init_cache(pcfg, b, 8)
        for lo, hi in [(0, 2)] + [(i, i + 1) for i in range(2, lp)]:
            kw = dict(input_ids=ids[:, lo:hi], positions=pos[:, lo:hi])
            want, jc = apply(params, vision=jnp.asarray(vision), cache=jc,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
            got, pc = run_port(vision=vision, cache=pc, **kw)
            close(got, want)
        return

    # the split beam cache: a B-row prefill of lp slots, then nb beams
    # decode with vision rows replicated per beam and the ancestry map
    # swapping parents between steps
    jc = jax_llm.init_cache(jcfg, b, lp)
    pc = llm.init_cache(pcfg, b, lp)
    _, jc = apply(params, input_ids=jnp.asarray(ids), positions=jnp.asarray(
        pos), vision=jnp.asarray(vision), cache=jc)
    _, pc = run_port(input_ids=ids, positions=pos, vision=vision, cache=pc)
    jc = jax_llm.split_beam_cache(jc, nb, 4)
    pc = llm.split_beam_cache(pc, nb, 4)
    vis_r = np.repeat(vision, nb, axis=0)
    anc = np.zeros((b, nb, 4), np.int32)
    for step in range(3):
        anc[:, :, step] = np.arange(nb)[None]
        toks = rng.integers(0, VOCAB, (b * nb, 1)).astype(np.int32)
        p1 = np.full((b * nb, 1), lp + step, np.int32)
        want, jc = apply(params, input_ids=jnp.asarray(toks),
                         positions=jnp.asarray(p1), vision=jnp.asarray(vis_r),
                         cache=jc, beam=jnp.asarray(anc))
        got, pc = run_port(input_ids=toks, positions=p1, vision=vis_r,
                           cache=pc, beam=anc)
        close(got, want)
        anc = anc[:, ::-1].copy()


# --------------------------------------------------------------------------
# (c) EMRRG
# --------------------------------------------------------------------------


@pytest.mark.parametrize("text_only_cross", [False, True],
                         ids=["all2media", "text_only"])
def test_emrrg_loss_grads_and_tokens_match_jax(text_only_cross):
    rng = np.random.default_rng(7)
    call = [_normal(rng, 2, 2, 32, 32, 3),
            rng.integers(4, VOCAB, (2, 3)).astype(np.int32),
            rng.integers(4, VOCAB, (2, 2)).astype(np.int32),
            rng.integers(4, VOCAB, (2, 5)).astype(np.int32),
            np.array([[1] * 5, [1] * 3 + [0] * 2], np.int32)]
    jcfg, pcfg = _llm_cfgs()
    kw = dict(cross_every=CROSS_EVERY, text_only_cross=text_only_cross)
    jm = jax_emrrg.EMRRG(llm_cfg=jcfg, arm_kwargs=dict(TINY_ARM,
                                                       scan_backend="ref"),
                         **kw)
    port = emrrg.EMRRG(pcfg, arm_kwargs=dict(TINY_ARM, img_size=32), **kw)
    jcall = [jnp.asarray(a) for a in call]
    params = _params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), *jcall)), 8)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, *jcall)))(params)
    load_jax_params(port, params)
    tcall = [torch.from_numpy(a) for a in call]
    got = port(*tcall)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=OUT_RTOL)
    want = state_dict_from_jax(grads)
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    assert any("cross_attn_gate_proj" in n for n in named)
    for name, p in named.items():
        err = (p.grad - want[name]).abs().max().item()
        assert err <= GRAD_RTOL * want[name].abs().max().item(), (name, err)
    for beams in (1, 3):
        gen = dict(num_beams=beams, max_new_tokens=6, min_new_tokens=2,
                   repetition_penalty=2.0, length_penalty=2.0,
                   no_repeat_ngram_size=2, eos_id=2, max_cache_len=64)
        tokens = jax.jit(lambda p: jm.apply(
            p, *jcall[:3], jax_mrg.GenerateConfig(**gen),
            method=jax_emrrg.EMRRG.generate))(params)
        out = port.generate(*tcall[:3], mrg.GenerateConfig(**gen))
        assert out.shape == (2, gen["max_new_tokens"])
        np.testing.assert_array_equal(out.numpy(), np.asarray(tokens),
                                      err_msg=f"beams {beams}")


# --------------------------------------------------------------------------
# (d) the trainable mask
# --------------------------------------------------------------------------


def _flat_names(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_names(v, name))
        else:
            out[name] = v
    return out


def test_unfreeze_hybrid_layers_matches_jax():
    jcfg, pcfg = _llm_cfgs(n_layers=5)
    jm = jax_emrrg.EMRRG(llm_cfg=jcfg, arm_kwargs=dict(TINY_ARM,
                                                       scan_backend="ref"),
                         cross_every=CROSS_EVERY)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)),
        jnp.ones((1, 2), jnp.int32), jnp.ones((1, 2), jnp.int32),
        jnp.ones((1, 3), jnp.int32), jnp.ones((1, 3), jnp.int32)))
    jmask = jax_loop.trainable_mask(shapes, True)["params"]
    want = _flat_names(jax_loop.unfreeze_hybrid_layers(jmask, CROSS_EVERY))
    port = emrrg.EMRRG(pcfg, arm_kwargs=dict(TINY_ARM, img_size=32),
                       cross_every=CROSS_EVERY, device="meta")
    names = flax_named_parameters(port)
    got = loop.unfreeze_hybrid_layers(loop.trainable_mask(names, True),
                                      CROSS_EVERY)
    assert got == want
    trainable_layers = {n.split("/")[1] for n, m in got.items()
                        if m and n.startswith("llm/")}
    assert trainable_layers == {"layers_0", "layers_2", "layers_4"}


# --------------------------------------------------------------------------
# (e) the fp32-master rule through fit_mrg
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
        "data.input_size=32", "data.max_len=16", "data.vocab_min_freq=1",
        "data.num_workers=2", "model.vision_kwargs=" + json.dumps(TINY_ARM),
        "model.llm_kwargs=" + json.dumps(LLM_KW),
        "model.task_kwargs=" + json.dumps({"cross_every": CROSS_EVERY}),
        "train.epochs=1", f"train.lr={LR}", "train.warmup_steps=1",
        "train.log_every=100", f"train.save_dir={save_dir}",
        "generate.num_beams=2", "generate.max_new_tokens=3",
        "generate.min_new_tokens=1", *extra])


def _hybrid(name: str) -> bool:
    m = re.match(r"llm/layers_(\d+)/", name)
    return bool(m) and int(m.group(1)) % CROSS_EVERY == 0


def test_fit_mrg_keeps_fp32_masters_of_the_hybrid_layers(tmp_path,
                                                         fixed_pixels):
    cfg = _task_cfg(tmp_path)
    t = cfg.train
    assert cfg.model.task == "emrrg" and t.freeze_llm and not t.lora_llm
    ann, tok, batcher, _ = loop.build_data(cfg)
    train_b = batcher("train")
    try:
        batches = list(train_b.batches(epoch=0))
    finally:
        train_b.close()
    steps = len(batches)
    assert steps == 3
    keys = ("images", "before_ids", "after_ids", "target_ids", "target_mask")
    # the JAX model as its fit_mrg builds it, the LLM in bf16
    llm_cfg = jax_llm.LLMConfig(vocab_size=tok.vocab_size, **LLM_KW)
    assert llm_cfg.dtype == jnp.bfloat16
    jm = jax_emrrg.EMRRG(
        llm_cfg=llm_cfg, arm_kwargs=dict(jax_loop.vision_preset(
            "arm", cfg.model.vision_size, TINY_ARM), scan_backend="ref"),
        cross_every=CROSS_EVERY)
    params = _params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *(jnp.asarray(batches[0][k])
                                 for k in keys))), 9)
    # the frozen LLM tensors closed over, the hybrid layers trained
    llm_p = params["params"]["llm"]
    frozen = {k: v for k, v in llm_p.items() if not _hybrid(f"llm/{k}/")}
    trainable = {"params": {**{k: v for k, v in params["params"].items()
                               if k != "llm"},
                            "llm": {k: v for k, v in llm_p.items()
                                    if k not in frozen}}}
    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(LR, 1, steps),
                              weight_decay=t.weight_decay,
                              grad_clip=t.grad_clip,
                              params_for_mask=trainable)

    def jax_loss(p, b, _rng):
        full = {"params": {**p["params"],
                           "llm": {**p["params"]["llm"], **frozen}}}
        return jm.apply(full, *(b[k] for k in keys))

    step = jax_ts.make_train_step(jax_loss, tx, accum_steps=1, donate=False)
    state = jax_ts.TrainState.create(trainable, tx)
    for batch in batches:
        state, _ = step(state, {k: jnp.asarray(batch[k]) for k in keys},
                        jax.random.PRNGKey(1))
    assert int(state.step) == 3

    seen = {}

    def on_start(model, pstate):
        model.load_state_dict(state_dict_from_jax(params))
        seen["model"] = model
        seen["start"] = {n: p.detach().clone()
                         for n, p in flax_named_parameters(model).items()}
        seen["trainable"] = set(pstate.params)

    loop.fit(cfg, "cpu", on_start=on_start)
    named = flax_named_parameters(seen["model"])
    start = seen["start"]
    hybrid = {n for n in named if _hybrid(n)}
    assert seen["trainable"] == {n for n in named
                                 if not n.startswith("llm/") or n in hybrid}
    want_end = {f"llm/{n}": v for n, v in _flat_names(
        jax.tree_util.tree_map(np.asarray, state.params)["params"]["llm"]
    ).items()}
    want_start = {f"llm/{n}": v for n, v in _flat_names(
        jax.tree_util.tree_map(np.asarray, params)["params"]["llm"]).items()}
    for n, p in named.items():
        if not n.startswith("llm/"):
            continue
        if n not in hybrid:
            if n.startswith("llm/layers_") and p.dim() == 2:
                assert p.dtype == torch.bfloat16, n
            assert torch.equal(p, start[n]), n
            continue
        assert p.dtype == torch.float32, n
        got = (p.detach() - start[n]).numpy()
        want = want_end[n] - want_start[n]
        if n.endswith("kernel"):  # Dense (in, out) -> Linear (out, in)
            want = want.T
        assert np.abs(want).max() > 0, n
        err = np.linalg.norm(got - want)
        assert err <= MOVE_RTOL * np.linalg.norm(want), (n, err)


# --------------------------------------------------------------------------
# (f) model.vision_init into EMRRG
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


def test_vision_init_grafts_a_bare_arm_into_emrrg(tmp_path):
    arm = ARM(**loop.vision_preset("arm", "base", TINY_ARM), img_size=32)
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for p in arm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    tower = {n: p.detach().clone()
             for n, p in flax_named_parameters(arm).items()}
    path = tmp_path / "arm.pt"
    torch.save(tower, path)
    plain = _start_params(_task_cfg(tmp_path / "plain"))
    grafted = _start_params(_task_cfg(tmp_path / "graft",
                                      f"model.vision_init={path}"))
    assert set(grafted) == set(plain)
    moved = {n for n in plain if not torch.equal(plain[n], grafted[n])}
    assert moved == {f"vision/{n}" for n in tower}
    for n, t in tower.items():
        assert torch.equal(grafted[f"vision/{n}"], t), n


def test_emrrg_is_ported():
    assert not hasattr(loop, "_NOT_PORTED")
    cfg = _task_cfg("unused")
    model = loop.build_mrg_model(cfg, VOCAB, device="meta")
    assert isinstance(model, emrrg.EMRRG) and model.cross_every == CROSS_EVERY
    assert dataclasses.asdict(model.llm_cfg)["dim"] == LLM_KW["dim"]
