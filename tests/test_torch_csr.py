"""The port's R2GenCSR slice against the JAX package on CPU, at tiny sizes.

R2GenCSR on a tiny vssm1 tower (depths (1, 1, 1, 1), dims (8, 16, 32,
64), 32x32 images, d_state 1, no gate, v2 patch embed) with a tiny fp32
LLM. The JAX side runs its ``ref`` backend (its choice on a CPU), the
port its ``auto`` backend, whose scan wrappers run the plain versions on
CPU tensors. One set of parameters goes into both. Tolerances: fp32 on
both sides, reordered sums only: the loss within 1e-5, the grad norm
within 1e-4 (relative); generated tokens are exact.
"""

import argparse
import base64
import dataclasses
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from medical_image_analysis_tpu.data import datasets as jax_data
from medical_image_analysis_tpu.data.tokenizer import (
    WordTokenizer as JaxTokenizer,
)
from medical_image_analysis_tpu.models import llm as jax_llm
from medical_image_analysis_tpu.models import mrg as jax_mrg
from medical_image_analysis_tpu.models.vmamba import _V1
from medical_image_analysis_tpu.peft import lora as jax_lora
from medical_image_analysis_tpu.train import loop as jax_loop
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu.train import train_state as jax_ts
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    flax_named_parameters,
    load_jax_params,
    lora_from_jax,
)
from medical_image_analysis_tpu_torch.data import datasets as port_data
from medical_image_analysis_tpu_torch.data.tokenizer import WordTokenizer
from medical_image_analysis_tpu_torch.models import llm, mrg
from medical_image_analysis_tpu_torch.peft.lora import (
    apply_lora,
    llama_qv_rules,
)
from medical_image_analysis_tpu_torch.train import loop, optim, train_state

VSSM1_KW = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), **_V1)
LLM_KW = dict(dim=32, n_layers=1, n_heads=4, n_kv_heads=2, hidden_dim=64)
VOCAB = 48
GEN = dict(max_new_tokens=8, min_new_tokens=3, repetition_penalty=2.0,
           length_penalty=2.0, no_repeat_ngram_size=2, eos_id=2,
           max_cache_len=64)


def _batch(seed):
    """Two studies of two views, one positive and one negative context
    image each."""
    rng = np.random.default_rng(seed)
    return dict(
        images=rng.standard_normal((2, 2, 32, 32, 3)).astype(np.float32),
        context_images=rng.standard_normal((2, 2, 32, 32, 3)).astype(
            np.float32),
        before_ids=rng.integers(4, VOCAB, (2, 5)).astype(np.int32),
        after_ids=rng.integers(4, VOCAB, (2, 3)).astype(np.int32),
        target_ids=rng.integers(4, VOCAB, (2, 6)).astype(np.int32),
        target_mask=np.array([[1] * 6, [1] * 4 + [0] * 2], np.int32),
    )


def _random_params(jm, batch, seed):
    """Parameters of the model's shapes, random from numpy (tracing the
    init is far cheaper than compiling it)."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *(jnp.asarray(v) for v in batch.values()))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "scale":
            return jnp.asarray(1.0 + 0.1 * v)
        return jnp.asarray(0.2 * v)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _tiny_pair(seed=0, remat=False):
    fields = dict(vocab_size=VOCAB, **LLM_KW)
    jm = jax_mrg.R2GenCSR(
        llm_cfg=jax_llm.LLMConfig(**fields, dtype=jnp.float32, remat=remat),
        chosen="vssm", vision_kwargs=VSSM1_KW)
    port = mrg.R2GenCSR(
        llm.LLMConfig(**fields, dtype=torch.float32, remat=remat),
        chosen="vssm", vision_kwargs=VSSM1_KW).eval()
    batch = _batch(seed)
    params = _random_params(jm, batch, seed)
    load_jax_params(port, params)
    return jm, params, port, batch


def test_loss_and_tokens_match_jax():
    """The teacher-forced loss, beam-3 tokens (split ancestry cache) and
    greedy tokens, from one set of parameters and one batch."""
    jm, params, port, batch = _tiny_pair()
    gen_keys = ("images", "context_images", "before_ids", "after_ids")
    beam = jax_mrg.GenerateConfig(num_beams=3, **GEN)
    greedy = jax_mrg.GenerateConfig(num_beams=1, **GEN)

    keys = tuple(batch)  # a dict through jit comes back with sorted keys

    @jax.jit
    def jax_all(p, b):
        loss = jm.apply(p, *(b[k] for k in keys))
        gen = [b[k] for k in gen_keys]
        return (loss, jm.apply(p, *gen, beam, method=jax_mrg.R2GenCSR.generate),
                jm.apply(p, *gen, greedy, method=jax_mrg.R2GenCSR.generate))

    want_loss, want_beam, want_greedy = jax_all(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got_loss = port(*t.values())
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=0,
                               atol=1e-5)
    for gcfg, want in ((beam, want_beam), (greedy, want_greedy)):
        got = port.generate(*(t[k] for k in gen_keys), mrg.GenerateConfig(
            **dataclasses.asdict(gcfg)))
        assert got.shape == (2, GEN["max_new_tokens"])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_context_tower_has_no_gradient():
    """Only the study's images reach the tower's gradient: the loss's
    gradient w.r.t. the context images is None (no graph), and the
    markers and ctx_proj get gradients."""
    _, _, port, batch = _tiny_pair(seed=1)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    t["context_images"].requires_grad_()
    t["images"].requires_grad_()
    port(*t.values()).backward()
    assert t["context_images"].grad is None
    assert t["images"].grad is not None
    for name in ("pos_marker", "neg_marker", "ctx_proj.weight"):
        assert port.get_parameter(name).grad.abs().sum() > 0, name


STEPS, LR = 3, 1e-3


def test_train_steps_match_jax():
    """Three steps of the slice's recipe (frozen LLM with LoRA r2 on q/v,
    trainable tower, projector, ctx_proj and markers; AdamW, clip, warmup
    1): the loss and the grad norm over the trainable leaves."""
    jm, params, port, batch = _tiny_pair(seed=2)
    rules = jax_lora.llama_qv_rules(rank=2)
    lora = jax_lora.init_lora(jax.random.PRNGKey(2), params, rules)
    rng = np.random.default_rng(3)
    lora = {k: {"a": v["a"], "b": jnp.asarray(
        (rng.standard_normal(v["b"].shape) * 0.05).astype(np.float32))}
        for k, v in lora.items()}

    train_params = {"base": params, "lora": lora}
    mask = {"base": jax_loop.trainable_mask(params, True, False),
            "lora": jax.tree_util.tree_map(lambda _: True, lora)}
    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(LR, 1, STEPS),
                              weight_decay=0.05, grad_clip=1.0,
                              params_for_mask=train_params,
                              trainable_mask=mask)

    def jax_loss(p, b, _rng):
        return jm.apply(jax_lora.apply_lora(p["base"], p["lora"], rules),
                        *(b[k] for k in batch))

    step = jax_ts.make_train_step(jax_loss, tx, accum_steps=1, donate=False)

    @jax.jit
    def jax_step(state, b):
        # the trainable-leaf norm (the port's definition) beside the step
        grads = jax.grad(jax_loss)(state.params, b, None)
        masked = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda g, m: g if m else jnp.zeros(()), grads, mask))
        state, metrics = step(state, b, jax.random.PRNGKey(1))
        return state, metrics["loss"], jnp.sqrt(
            sum(jnp.sum(g * g) for g in masked))

    state = jax_ts.TrainState.create(train_params, tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(STEPS):
        state, loss, norm = jax_step(state, jb)
        want.append((float(loss), float(norm)))

    named = flax_named_parameters(port)
    tmask = loop.trainable_mask(named, True, False)
    for n, p in named.items():
        p.requires_grad_(tmask[n])
    plora = lora_from_jax(lora)
    apply_lora(port, plora, llama_qv_rules(rank=2))
    trainable = {f"base/{n}": p for n, p in named.items() if tmask[n]}
    assert {"base/pos_marker", "base/neg_marker", "base/ctx_proj/kernel",
            "base/vision/vssm/stage0_block0/op/x_proj_w"} <= set(trainable)
    for key, ab in plora.items():
        for part, tensor in ab.items():
            trainable[f"lora/{key}/{part}"] = tensor
    ptx = optim.make_adamw(trainable, optim.warmup_cosine(LR, 1, STEPS),
                           weight_decay=0.05, grad_clip=1.0)
    pstate = train_state.TrainState(trainable, ptx)
    pstep = train_state.make_train_step(lambda b: port(*b.values()), 1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i, (loss, norm) in enumerate(want):
        m = pstep(pstate, tb)
        np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")


def _ann_and_tok():
    ann = port_data.synthetic_annotations(n_train=12, n_val=4, n_test=2)
    reports = [s.report for s in ann["train"]]
    return (ann, JaxTokenizer.from_corpus(reports, min_freq=1),
            WordTokenizer.from_corpus(reports, min_freq=1))


@pytest.mark.parametrize("mode", ["keyword", "random", "chexbert"])
def test_context_sampling_matches_jax(mode):
    """The same seed draws the same context ids, and the batches (their
    ``context_images`` included) are equal, per epoch and from the
    batcher's own generator."""
    ann, jtok, ptok = _ann_and_tok()
    chex = {"s0": np.eye(14, dtype=np.int32)[13],
            "s1": np.eye(14, dtype=np.int32)[2]}
    for n in (1, 3):
        want = jax_data.sample_context_ids(
            np.random.default_rng(n), ann["train"], n, mode,
            chexbert_labels=chex)
        got = port_data.sample_context_ids(
            np.random.default_rng(n), ann["train"], n, mode,
            chexbert_labels=chex)
        assert [list(map(int, x)) for x in got] == \
            [list(map(int, x)) for x in want]
    load = port_data.synthetic_image_loader(8, 2)
    kw = dict(max_len=8, n_context=2, context_mode=mode, chexbert_labels=chex)
    jb = jax_data.MRGBatcher(ann["train"], jtok, load, 4, num_workers=1, **kw)
    pb = port_data.MRGBatcher(ann["train"], ptok, load, 4, num_workers=2,
                              **kw)
    try:
        for epoch in (1, None):
            pairs = list(zip(jb.batches(epoch=epoch, drop_last=False),
                             port_data.prefetch(pb.batches(
                                 epoch=epoch, drop_last=False))))
            assert len(pairs) == 3
            for want, got in pairs:
                assert got["context_images"].shape == (4, 4, 8, 8, 3)
                assert want.keys() == got.keys()
                for k in want:
                    if isinstance(want[k], np.ndarray):
                        np.testing.assert_array_equal(got[k], want[k],
                                                      err_msg=k)
                    else:
                        assert got[k] == want[k], k
    finally:
        pb.close()


def _tiny_run_cfg(save_dir):
    from medical_image_analysis_tpu_torch.configs.config import (
        PRESET_DIR,
        load_config,
    )

    return load_config(str(PRESET_DIR / "r2gencsr_iu.yaml"), [
        "data.dataset=synthetic", "data.input_size=32", "data.batch_size=4",
        "data.max_len=16", "data.vocab_min_freq=1", "data.n_context=1",
        "data.num_workers=2", "model.vision=vssm", "model.vision_size=base",
        "model.vision_kwargs=" + json.dumps(VSSM1_KW),
        "model.llm_kwargs=" + json.dumps(LLM_KW),
        "train.lora_rank=2", "train.epochs=1", f"train.save_dir={save_dir}",
        "generate.max_new_tokens=4", "generate.min_new_tokens=1",
    ])


def test_fit_r2gencsr_vssm1_through_the_cli(tmp_path):
    """The preset with the slice's overrides at a tiny size, through
    ``cli.train.main`` on the CPU: every step finite, one validation, a
    delta written; then ``--validate`` scores the same reports again."""
    from medical_image_analysis_tpu_torch.cli import train as cli_train
    from medical_image_analysis_tpu_torch.configs.config import save_config

    cfg = _tiny_run_cfg(tmp_path)
    save_config(cfg, str(tmp_path / "run.yaml"))
    scores = cli_train.main(["--config", str(tmp_path / "run.yaml"),
                             "--device", "cpu"])
    assert all(np.isfinite(v) for v in scores.values())
    with open(tmp_path / "log.txt") as f:
        steps = [r for r in map(json.loads, f) if "step" in r]
    assert len(steps) == 8 and all(np.isfinite(r["loss"]) for r in steps)
    assert (tmp_path / "checkpoint_best.pt").exists()
    again = cli_train.main(["--config", str(tmp_path / "run.yaml"),
                            "--validate", "--device", "cpu"])
    assert again == {k: v for k, v in scores.items() if k != "val_score"}


def test_preset_builds_vssm1_base_and_qwen_0_5b_at_full_width():
    """r2gencsr_iu with the slice's overrides, on the meta device."""
    from medical_image_analysis_tpu_torch.configs.config import (
        PRESET_DIR,
        load_config,
    )
    from medical_image_analysis_tpu_torch.train.loop import build_mrg_model

    cfg = load_config(str(PRESET_DIR / "r2gencsr_iu.yaml"), [
        "model.vision=vssm", "model.vision_size=base",
        "model.vision_kwargs=" + json.dumps(dict(_V1)),
    ])
    assert (cfg.data.batch_size, cfg.data.n_context, cfg.data.max_len) == (
        6, 3, 60)
    model = build_mrg_model(cfg, 151936, device="meta")
    assert isinstance(model, mrg.R2GenCSR)
    vssm = model.vision.vssm
    assert (vssm.depths, vssm.dims) == ((2, 2, 15, 2), (128, 256, 512, 1024))
    ranks = [getattr(vssm, f"stage{s}_block0").op.rank for s in range(4)]
    assert ranks == [8, 16, 32, 64]
    assert model.llm_cfg == dataclasses.replace(
        llm.LLM_CONFIGS["qwen1_5_0_5b"], vocab_size=151936)
    assert model.ctx_proj.weight.shape == (1024, 1024)


def test_demo_serves_r2gengpt_on_vssm1(tmp_path):
    """The demo builds task=r2gengpt with the vssm1 tower and answers a
    POST; it refuses task=r2gencsr (the JAX package has no such demo)."""
    import PIL.Image

    from medical_image_analysis_tpu_torch.cli.demo import (
        build_pipeline,
        make_server,
    )

    cfg = {"data": {"input_size": 32},
           "model": {"task": "r2gengpt", "vision": "vssm",
                     "vision_kwargs": dict(VSSM1_KW), "llm_kwargs": LLM_KW},
           "generate": {"max_new_tokens": 5, "min_new_tokens": 2,
                        "max_cache_len": 64}}
    path = tmp_path / "demo.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    args = argparse.Namespace(config=str(path), vocab=None, vocab_size=40,
                              delta=None, device="cpu", seed=0)
    report_for = build_pipeline(args)
    img = np.random.default_rng(0).integers(0, 255, (48, 40, 3),
                                            dtype=np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, format="PNG")
    server = make_server(report_for, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/generate",
            data=json.dumps(
                {"image": base64.b64encode(buf.getvalue()).decode()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            out = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert out == report_for(img) and len(out["ids"]) == 5
    cfg["model"]["task"] = "r2gencsr"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    with pytest.raises(NotImplementedError, match="r2gengpt"):
        build_pipeline(args)
