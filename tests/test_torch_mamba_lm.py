"""The Mamba LM of EMRRG's text finetune in the port against the JAX
package on CPU, at tiny widths.

(a) ``causal_conv1d_update``, and the one-direction ``MambaMixer.step``
    and ``MambaBlock.step`` from one JAX ``init`` (outputs and both
    states within 1e-5); the step refuses a mixer of more directions.
(b) ``MambaLM`` (2 blocks) from one JAX ``init`` loaded strictly: the
    logits and every gradient within 1e-5 (of max(1, the largest logit),
    and of each tensor's largest gradient), plain and with each
    activation adapter (AdaptFormer, prompt tuning, prefix tuning), and
    with LoRA on the X half of ``in_proj`` (``mamba_partial_x_rules``,
    the adapters' gradients); ``step`` against the JAX ``step`` within
    1e-5, and the step decode against the full forward within the JAX
    package's own 2e-4.
(c) ``lm_loss`` and ``alpaca_prompt`` (byte for byte), the recipe's
    ``lm_ids``/``lm_mask`` against the JAX package's encoding of the same
    prompt, and ``build_lm_model``'s refusal of the weight-space family.
(d) ``fit_lm_sft`` on the ``mamba_lm_sft`` preset (tiny widths) from the
    JAX parameters: two updates against the JAX ``make_train_step`` with
    ``make_adamw`` over the same batches (loss within 1e-5 relative, grad
    norm within 1e-4), then the validation's loss within 1e-5.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.data.tokenizer import (
    WordTokenizer as JaxTokenizer,
)
from medical_image_analysis_tpu.models import mamba as jax_mamba
from medical_image_analysis_tpu.models import mamba_lm as jax_lm
from medical_image_analysis_tpu.ops import causal_conv as jax_conv
from medical_image_analysis_tpu.peft import lora as jax_lora
from medical_image_analysis_tpu.peft import mamba_peft as jax_peft
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu.train import train_state as jax_ts
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    load_jax_params,
    lora_from_jax,
    state_dict_from_jax,
)
from medical_image_analysis_tpu_torch.configs.config import load_config
from medical_image_analysis_tpu_torch.models import mamba, mamba_lm
from medical_image_analysis_tpu_torch.ops import causal_conv
from medical_image_analysis_tpu_torch.peft import lora, mamba_peft
from medical_image_analysis_tpu_torch.train import loop

PRESET = (Path(__file__).resolve().parents[1]
          / "medical_image_analysis_tpu_torch" / "configs" / "presets"
          / "mamba_lm_sft.yaml")
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-5
DECODE_TOL = 2e-4  # the JAX package's own step-vs-forward bound
VOCAB = 48
LM_KW = dict(d_model=16, depth=2, d_state=4)
PEFT = {
    "plain": None,
    "adaptformer": dict(adaptformer=True, dim_adaptf=6, s_adaptf=0.5),
    "prompt": dict(prompt_tuning=True, prompt_num_tokens=3),
    "prefix": dict(prefix_tuning=True, num_virtual_tokens=2),
}


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


def _close(got, want, rtol=OUT_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _ids(seed, b=2, length=10):
    return np.random.default_rng(seed).integers(1, VOCAB, (b, length)).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# (a) the decode step's parts
# --------------------------------------------------------------------------


def test_causal_conv1d_update_matches_jax():
    rng = np.random.default_rng(0)
    x, state = rng.standard_normal((3, 8)), rng.standard_normal((3, 3, 8))
    w, bias = rng.standard_normal((4, 8)), rng.standard_normal(8)
    args = [a.astype(np.float32) for a in (x, state, w, bias)]
    for act in ("silu", None):
        want_y, want_s = jax_conv.causal_conv1d_update(
            *map(jnp.asarray, args), activation=act)
        got_y, got_s = causal_conv.causal_conv1d_update(
            *map(_t, args), activation=act)
        _close(got_y.numpy(), want_y)
        np.testing.assert_array_equal(got_s.numpy(), want_s)
        assert np.array_equal(got_s.numpy()[:, -1], args[0])


@pytest.mark.parametrize("which", ["mixer", "block"])
def test_mixer_and_block_step_match_jax(which):
    d, n = 12, 4
    if which == "mixer":
        jm = jax_mamba.MambaMixer(d_model=d, d_state=n, expand=2)
        port = mamba.MambaMixer(d, d_state=n, expand=2)
    else:
        jm = jax_mamba.MambaBlock(d_model=d, d_state=n, expand=2)
        port = mamba.MambaBlock(d, d_state=n, expand=2)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, d)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 2 * d)).astype(np.float32)
    ssm = rng.standard_normal((2, 2 * d, n)).astype(np.float32)
    params = _params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.ones((2, 5, d))), 2)
    want = jax.jit(lambda p, *a: jm.apply(p, *a, method=type(jm).step))(
        params, jnp.asarray(x), jnp.asarray(conv), jnp.asarray(ssm))
    load_jax_params(port, params)
    with torch.no_grad():
        got = port.step(_t(x), _t(conv), _t(ssm))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)


def test_step_refuses_more_directions():
    mixer = mamba.MambaMixer(8, d_state=4, bimamba_type="v2")
    with pytest.raises(AssertionError, match="1-directional"):
        mixer.step(torch.zeros(1, 8), torch.zeros(1, 3, 16),
                   torch.zeros(1, 16, 4))


# --------------------------------------------------------------------------
# (b) the LM
# --------------------------------------------------------------------------


def _models(peft=None):
    jpc = None if peft is None else jax_peft.MambaPEFTConfig(**peft)
    ppc = None if peft is None else mamba_peft.MambaPEFTConfig(**peft)
    return (jax_lm.MambaLM(vocab_size=VOCAB, **LM_KW, peft_cfg=jpc),
            mamba_lm.MambaLM(VOCAB, **LM_KW, peft_cfg=ppc))


def _lm_params(jm, seed):
    return _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                  jnp.ones((2, 10), jnp.int32)), seed)


def _check_grads(named, want, tol=GRAD_RTOL):
    assert set(named) == set(want)
    for name, p in named.items():
        err = (p.grad - want[name]).abs().max().item()
        assert err <= tol * want[name].abs().max().item(), (name, err)


@pytest.mark.parametrize("peft", list(PEFT))
def test_mamba_lm_logits_and_grads_match_jax(peft):
    jm, port = _models(PEFT[peft])
    ids = _ids(3)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    params = _lm_params(jm, 4)

    def loss(p):
        logits = jm.apply(p, jnp.asarray(ids))
        return jax_lm.lm_loss(logits, jnp.asarray(ids), jnp.asarray(mask)), \
            logits

    (want_loss, want_logits), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    load_jax_params(port, params)
    logits = port(_t(ids))
    _close(logits.detach().numpy(), want_logits)
    got_loss = mamba_lm.lm_loss(logits, _t(ids), _t(mask))
    np.testing.assert_allclose(got_loss.item(), float(want_loss),
                               rtol=OUT_RTOL)
    got_loss.backward()
    _check_grads(dict(port.named_parameters()), state_dict_from_jax(grads))
    if peft == "adaptformer":
        assert port.adaptf_up_1.weight.shape == (16, 6)


def test_mamba_lm_partial_x_lora_matches_jax():
    """LoRA r2 on the X half of each block's ``in_proj`` (random B, so that
    the merge is not 0): the logits, and the adapters' gradients."""
    jm, port = _models()
    ids = _ids(5)
    mask = np.ones_like(ids)
    params = _lm_params(jm, 6)
    d_inner = 2 * LM_KW["d_model"]
    rules_j = jax_lora.mamba_partial_x_rules(d_inner, rank=2)
    rules_p = lora.mamba_partial_x_rules(d_inner, rank=2)
    assert rules_p[0].out_slice == (0, d_inner)
    tree = jax_lora.init_lora(jax.random.PRNGKey(1), params, rules_j)
    rng = np.random.default_rng(7)
    tree = {k: {"a": v["a"], "b": jnp.asarray(
        0.1 * rng.standard_normal(v["b"].shape).astype(np.float32))}
        for k, v in tree.items()}
    assert len(tree) == LM_KW["depth"]

    def loss(t):
        logits = jm.apply(jax_lora.apply_lora(params, t, rules_j),
                          jnp.asarray(ids))
        return jax_lm.lm_loss(logits, jnp.asarray(ids), jnp.asarray(mask)), \
            logits

    (want_loss, want_logits), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(tree)
    load_jax_params(port, params)
    adapters = lora_from_jax(tree)
    assert set(adapters) == {f"layers_{i}/mixer/in_proj/kernel"
                             for i in range(LM_KW["depth"])}
    lora.apply_lora(port, adapters, rules_p)
    logits = port(_t(ids))
    _close(logits.detach().numpy(), want_logits)
    got = mamba_lm.lm_loss(logits, _t(ids), _t(mask))
    np.testing.assert_allclose(got.item(), float(want_loss), rtol=OUT_RTOL)
    got.backward()
    for key, ab in adapters.items():
        for part in ("a", "b"):
            want = np.asarray(grads[f"params/{key}"][part])
            err = np.abs(ab[part].grad.numpy() - want).max()
            assert err <= GRAD_RTOL * np.abs(want).max(), (key, part, err)


def test_lm_step_matches_jax_and_the_full_forward():
    jm, port = _models()
    ids = _ids(8)
    params = _lm_params(jm, 9)
    full = jax.jit(jm.apply)(params, jnp.asarray(ids))
    step = jax.jit(lambda p, tok, s: jm.apply(p, tok, s,
                                              method=jax_lm.MambaLM.step))
    load_jax_params(port, params)
    states = port.init_states(2)
    assert [tuple(s.shape) for s in states[0]] == [(2, 3, 32), (2, 32, 4)]
    assert all(s.dtype == torch.float32 and not s.any()
               for pair in states for s in pair)
    jstates = jm.apply(params, 2, method=jax_lm.MambaLM.init_states)
    outs = []
    with torch.no_grad():
        for t in range(ids.shape[1]):
            want, jstates = step(params, jnp.asarray(ids[:, t]), jstates)
            got, states = port.step(_t(ids[:, t]), states)
            _close(got.numpy(), want)
            for (gc, gs), (wc, ws) in zip(states, jstates):
                _close(gc.numpy(), wc)
                _close(gs.numpy(), ws)
            outs.append(got)
        inc = torch.stack(outs, dim=1).numpy()
        np.testing.assert_allclose(inc, port(_t(ids)).numpy(),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
    np.testing.assert_allclose(inc, np.asarray(full), rtol=DECODE_TOL,
                               atol=DECODE_TOL)


# --------------------------------------------------------------------------
# (c) the loss, the prompt, the recipe's inputs
# --------------------------------------------------------------------------


def test_lm_loss_matches_jax():
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((3, 7, VOCAB)).astype(np.float32)
    ids = _ids(11, 3, 7)
    mask = (rng.random((3, 7)) < 0.7).astype(np.int32)
    mask[2] = 0  # a row with no target
    want = jax_lm.lm_loss(jnp.asarray(logits), jnp.asarray(ids),
                          jnp.asarray(mask))
    got = mamba_lm.lm_loss(_t(logits), _t(ids), _t(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=OUT_RTOL)
    zero = mamba_lm.lm_loss(_t(logits), _t(ids), torch.zeros(3, 7))
    assert zero.item() == 0.0


@pytest.mark.parametrize("inp", ["", "the input"])
def test_alpaca_prompt_is_the_jax_packages(inp):
    for args in (("summarize", inp, "resp"), ("generate a report", inp, "")):
        assert mamba_lm.alpaca_prompt(*args) == jax_lm.alpaca_prompt(*args)


def test_lm_sft_extra_matches_the_jax_encoding():
    """``lm_ids``/``lm_mask`` of the recipe against the JAX package's
    tokenizer over its own ``alpaca_prompt`` (``fit_lm_sft``'s ``lm_extra``):
    the prompt's words out of the report vocabulary are ``<unk>``."""
    cfg = _cfg("unused")
    ann, tok, _, _ = loop.build_data(cfg)
    reports = [s.report for s in ann["train"]]
    jtok = JaxTokenizer.from_corpus(reports, min_freq=1)
    extra = loop.lm_sft_extra(tok, 24)
    for s in ann["train"][:4] + ann["val"][:2]:
        got = extra(s)
        ids = jtok.encode(jax_lm.alpaca_prompt(loop.LM_INSTRUCTION, "",
                                               s.report),
                          max_len=23, add_eos=True)
        ids, mask = jtok.pad(ids, 24)
        np.testing.assert_array_equal(got["lm_ids"], ids)
        np.testing.assert_array_equal(got["lm_mask"], mask)
        assert got["lm_ids"].dtype == np.int32
    assert tok.encode("below")[0] == tok.UNK


def test_build_lm_model_reads_peft_cfg_and_refuses_the_weight_space():
    model = loop.build_lm_model(_cfg("unused", "model.lm_kwargs=" + json.dumps(
        dict(LM_KW, peft_cfg=PEFT["adaptformer"]))), VOCAB, device="meta")
    assert isinstance(model.peft_cfg, mamba_peft.MambaPEFTConfig)
    assert model.peft_cfg.adaptformer and hasattr(model, "adaptf_down_0")
    pc = mamba_peft.MambaPEFTConfig(lora_X=True, additional_scan=True)
    assert mamba_peft.weight_space_fields(pc) == ["lora_X", "additional_scan"]
    assert mamba_peft.effective_d_state(pc, 16) == 17
    with pytest.raises(NotImplementedError, match="merge_mamba_peft"):
        loop.build_lm_model(_cfg("unused", "model.lm_kwargs=" + json.dumps(
            dict(LM_KW, peft_cfg={"lora_X": True}))), VOCAB, device="meta")


def test_mamba_peft_config_is_the_jax_packages():
    want = [(f.name, f.default) for f in dataclasses.fields(
        jax_peft.MambaPEFTConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(
        mamba_peft.MambaPEFTConfig)]
    assert got == want


# --------------------------------------------------------------------------
# (d) the recipe
# --------------------------------------------------------------------------

BATCH, LR = 16, 1e-3  # 32 synthetic train samples: 2 steps an epoch


def _cfg(save_dir, *extra):
    return load_config(str(PRESET), [
        "data.dataset=synthetic", f"data.batch_size={BATCH}",
        "data.input_size=8", "data.max_len=24", "data.vocab_min_freq=1",
        "data.num_workers=1", "model.lm_kwargs=" + json.dumps(LM_KW),
        "train.epochs=1", f"train.lr={LR}", "train.warmup_steps=1",
        "train.log_every=100", f"train.save_dir={save_dir}", *extra])


def test_fit_lm_sft_matches_jax(tmp_path):
    cfg = _cfg(tmp_path)
    assert cfg.model.task == "mamba_lm_sft"
    ann, tok, batcher, _ = loop.build_data(cfg)
    extra = loop.lm_sft_extra(tok, cfg.data.max_len)
    keys = ("lm_ids", "lm_mask")
    batches, val = [], []
    for split, out, kw in (("train", batches, dict(epoch=0)),
                           ("val", val, dict(shuffle=False,
                                             drop_last=False))):
        b = batcher(split, extra_fn=extra)
        try:
            out += [{k: x[k] for k in keys} for x in b.batches(**kw)]
        finally:
            b.close()
    assert len(batches) == 2 and len(val) == 1
    n_val = len(ann["val"])
    assert n_val < BATCH  # the padded rows are sliced off

    jm = jax_lm.MambaLM(vocab_size=tok.vocab_size, **LM_KW)
    params = _lm_params(jm, 12)
    t = cfg.train
    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(LR, 1, 2),
                              weight_decay=t.weight_decay,
                              grad_clip=t.grad_clip, params_for_mask=params)

    def jax_loss(p, b, _rng):
        return jax_lm.lm_loss(jm.apply(p, b["lm_ids"]), b["lm_ids"],
                              b["lm_mask"])

    step = jax_ts.make_train_step(jax_loss, tx, accum_steps=1, donate=False)
    state = jax_ts.TrainState.create(params, tx)
    want = []
    for batch in batches:
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                        jax.random.PRNGKey(1))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    vb = {k: jnp.asarray(v[:n_val]) for k, v in val[0].items()}
    want_val = float(jax.jit(jax_loss)(state.params, vb, None))

    def on_start(model, _):
        load_jax_params(model, params)

    scores = loop.fit(cfg, "cpu", on_start=on_start)
    with open(tmp_path / "log.txt") as f:
        records = list(map(json.loads, f))
    got = [r for r in records if "step" in r]
    assert len(got) == 2
    for i, (r, (loss, norm)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(r["grad_norm"], norm, rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")
    np.testing.assert_allclose(scores["val_loss"], want_val, rtol=1e-5)
    assert scores["val_ppl"] == pytest.approx(np.exp(scores["val_loss"]))
    assert sum("val_s" in r for r in records) == 1
