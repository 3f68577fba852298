"""JAX train states and pretrain artifacts in the port, on CPU.

(a) The port reads a state that JAX ``save_train_state`` wrote (the
    ``make_adamw`` chain plain and inside ``optax.masked``/``set_to_zero``,
    a LoRA tree beside the base, non-square Dense kernels), and
    ``tests/jax_state_files.py`` writes it back as JAX did: the two files
    decode to the same tree, bit for bit.
(b) A tiny ``dp_finetune`` (EMA on, one step an epoch) trained one step in
    JAX and saved there, resumed by the port's ``fit_classify``
    (``train.resume=auto``): its next step's loss and grad norm, and the
    parameters, moments, count and EMA shadow after it, match JAX's next
    step (fp32; loss and grad norm to 1e-5 relative, tensors to 1e-5 of
    each tensor's largest); the epoch goes on from the saved one.
(c) ``train.resume=auto`` picks the newest epoch among ``.pt`` and
    ``.msgpack`` (the port's where both hold it).
(d) ``model.vision_init`` from a JAX train state grafts what the JAX
    ``apply_vision_init`` grafts; from a JAX delta (which the JAX function
    cannot read: ROADMAP.md, queue 3, item 11) the same tensors.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medical_image_analysis_tpu.ckpt import bridge as jax_bridge
from medical_image_analysis_tpu.ckpt import checkpoint as jax_ckpt
from medical_image_analysis_tpu.evalx import chexbert as jax_chexbert
from medical_image_analysis_tpu.models import classifiers as jax_cls
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu.train import train_state as jax_ts
from medical_image_analysis_tpu.train.loop import vision_preset
from medical_image_analysis_tpu_torch.ckpt import checkpoint
from medical_image_analysis_tpu_torch.ckpt.bridge import apply_vision_init
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    flax_named_parameters,
    to_port_layout,
)
from medical_image_analysis_tpu_torch.ckpt.msgpack import msgpack_restore
from medical_image_analysis_tpu_torch.configs.config import load_config
from medical_image_analysis_tpu_torch.models.common import init_params
from medical_image_analysis_tpu_torch.train import loop

sys.path.insert(0, str(Path(__file__).resolve().parent))
from jax_state_files import write_jax_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DP = ROOT / "medical_image_analysis_tpu_torch/configs/presets/dp_finetune.yaml"
SIZE, BATCH, LR = 32, 8, 1e-3
# every transposed kernel non-square: the patch conv (8, 8, 3, 24), the
# head (24, 14); the blocks' raw kernels keep flax's layout
VIT = dict(patch_size=8, embed_dim=24, depth=1, num_heads=2)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fill(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        return jnp.asarray(1.0 + 0.1 * v if path[-1].key == "scale"
                           else 0.2 * v)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif a is None:
        assert b is None, path
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


def _decode(path):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# --------------------------------------------------------------------------
# (a) reading optax's layout, and writing it back
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "masked", "lora"])
def test_jax_state_read_and_written_back(tmp_path, kind):
    rng = np.random.default_rng(0)
    base = {"params": {
        "vision": {"proj": {"kernel": rng.standard_normal((6, 10)),
                            "bias": rng.standard_normal(10)},
                   "patch_embed": {"kernel": rng.standard_normal(
                       (2, 2, 3, 5))}},
        "llm": {"q_proj": {"kernel": rng.standard_normal((10, 12))},
                "norm": {"scale": rng.standard_normal(10)}}}}
    base = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), base)
    # fit_mrg's masks: the LLM frozen, LoRA (its own tree) beside the base
    frozen_llm = jax.tree_util.tree_map_with_path(
        lambda p, _: p[1].key != "llm", base)
    params, mask = base, None
    if kind == "masked":
        mask = frozen_llm
    elif kind == "lora":
        params = {"base": base, "lora": {"params/llm/q_proj/kernel": {
            "a": jnp.asarray(rng.standard_normal((10, 2)), jnp.float32),
            "b": jnp.zeros((2, 12), jnp.float32)}}}
        mask = {"base": frozen_llm, "lora": jax.tree_util.tree_map(
            lambda _: True, params["lora"])}
    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(1e-2, 1, 10),
                              params_for_mask=params, trainable_mask=mask)
    state = jax_ts.TrainState.create(params, tx, ema=True)
    for i in range(3):
        grads = jax.tree_util.tree_map(lambda p: jnp.cos(p + i), params)
        updates, opt = tx.update(grads, state.opt_state, state.params)
        state = state.replace(step=state.step + 1, opt_state=opt,
                              params=optax.apply_updates(state.params,
                                                         updates))
    path = jax_ckpt.save_train_state(str(tmp_path / "jax"), state, 4)

    got, epoch = checkpoint.restore_train_state(path)
    assert epoch == 4 and got["step"] == 3 and got["opt"]["count"] == 3
    vision = {"vision/proj/kernel", "vision/proj/bias",
              "vision/patch_embed/kernel"}
    llm = {"llm/q_proj/kernel", "llm/norm/scale"}
    pre = "base/" if kind == "lora" else ""
    want = {"plain": vision | llm, "masked": vision,
            "lora": {pre + n for n in vision} | {
                "lora/llm/q_proj/kernel/a", "lora/llm/q_proj/kernel/b"}}[kind]
    assert set(got["params"]) == want == set(got["opt"]["mu"])
    assert set(got["frozen"]) == (set() if kind == "plain"
                                  else {pre + n for n in llm})
    assert set(got["ema"]) == want
    # the moments take their parameters' layouts
    chain = state.opt_state if mask is None else state.opt_state[0].inner_state
    mu = chain[1][0].mu  # (clip, (adam, decay, schedule))
    mu = (mu["base"] if kind == "lora" else mu)["params"]["vision"]
    np.testing.assert_array_equal(
        got["opt"]["mu"][pre + "vision/proj/kernel"].numpy(),
        np.asarray(mu["proj"]["kernel"]).T)
    np.testing.assert_array_equal(
        got["opt"]["mu"][pre + "vision/patch_embed/kernel"].numpy(),
        np.asarray(mu["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    if kind != "lora":  # LoRA's keys are not flax paths: the writer's
        # trees are (the port's own runs write .pt)
        back = write_jax_state(str(tmp_path / "port"), got, 4,
                               masked=mask is not None)
        _same(_decode(back), _decode(path))


# --------------------------------------------------------------------------
# (b) a JAX dp_finetune resumed by the port
# --------------------------------------------------------------------------


def _dp_cfg(save_dir, **extra):
    sets = ["data.dataset=synthetic_learnable", f"data.input_size={SIZE}",
            f"data.batch_size={BATCH}", f"data.synthetic_train_size={BATCH}",
            "data.num_workers=1", "model.vision_kwargs={patch_size: 8, "
            "embed_dim: 24, depth: 1, num_heads: 2}", f"train.lr={LR}",
            "train.warmup_steps=1", "train.log_every=100",
            f"train.save_dir={save_dir}"]
    return load_config(str(DP), sets + [f"{k}={v}" for k, v in extra.items()])


def test_jax_dp_state_resumes_in_port(tmp_path):
    cfg = _dp_cfg(tmp_path, **{"train.epochs": 2, "train.resume": "auto"})
    t = cfg.train
    assert t.ema_decay == 0.999
    jm = jax_cls.DPClassifier(14, vit_kwargs=vision_preset("vit", "base",
                                                            VIT))
    params = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                  jnp.zeros((1, SIZE, SIZE, 3))), 5)
    _, _, batcher, _ = loop.build_data(cfg)
    batches = []
    for epoch in (0, 1):
        b = batcher("train")
        try:
            batches += list(b.batches(epoch=epoch))
        finally:
            b.close()
    assert len(batches) == 2  # one step an epoch
    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(LR, 1, 2),
                              weight_decay=t.weight_decay,
                              grad_clip=t.grad_clip, params_for_mask=params)

    def jax_loss(p, b, rng):
        return jax_cls.weighted_bce_loss(jm.apply(p, b["images"][:, 0]),
                                         b["labels"])

    step = jax_ts.make_train_step(jax_loss, tx, donate=False,
                                  ema_decay=t.ema_decay)
    state = jax_ts.TrainState.create(params, tx, ema=True)
    metrics = []
    for i, batch in enumerate(batches):
        labels = np.stack([jax_chexbert.extract_labels(r)
                           for r in batch["reports"]]).astype(np.float32)
        state, m = step(state, {"images": jnp.asarray(batch["images"]),
                                "labels": jnp.asarray(labels)},
                        jax.random.PRNGKey(0))
        metrics.append(m)
        if i == 0:
            jax_ckpt.save_train_state(str(tmp_path), state, 0)

    loop.fit_classify(cfg, "cpu")
    with open(tmp_path / "log.txt") as f:
        got = [r for r in map(json.loads, f) if "step" in r]
    assert [(r["epoch"], r["step"]) for r in got] == [(1, 2)]
    np.testing.assert_allclose(got[0]["loss"], float(metrics[1]["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got[0]["grad_norm"],
                               float(metrics[1]["grad_norm"]), rtol=1e-5)
    saved, epoch = checkpoint.restore_train_state(
        str(tmp_path / "state_epoch00001.pt"))
    assert epoch == 1 and saved["step"] == 2 and saved["opt"]["count"] == 2
    want, _ = checkpoint.restore_train_state(
        jax_ckpt.save_train_state(str(tmp_path / "jax"), state, 1))
    for part in ("params", "ema"):
        for n, w in want[part].items():
            scale = max(1.0, w.abs().max().item())
            assert (saved[part][n] - w).abs().max().item() <= 1e-5 * scale, n
    for part in ("mu", "nu"):
        for n, w in want["opt"][part].items():
            scale = max(w.abs().max().item(), 1e-30)
            err = (saved["opt"][part][n] - w).abs().max().item()
            assert err <= 1e-4 * scale, (part, n)


# --------------------------------------------------------------------------
# (c) auto resume across the two kinds
# --------------------------------------------------------------------------


def test_auto_resume_picks_newest_epoch_of_either_kind(tmp_path):
    def touch(name):
        (tmp_path / name).write_bytes(b"")
        return str(tmp_path / name)

    assert checkpoint.auto_resume_helper(str(tmp_path)) is None
    touch("state_epoch00000.pt")
    newest = touch("state_epoch00001.msgpack")
    assert checkpoint.auto_resume_helper(str(tmp_path)) == newest
    newest = touch("state_epoch00002.pt")
    touch("state_epoch00002.msgpack")
    assert checkpoint.auto_resume_helper(str(tmp_path)) == newest
    newest = touch("state_epoch00010.msgpack")
    assert checkpoint.auto_resume_helper(str(tmp_path)) == newest


# --------------------------------------------------------------------------
# (d) model.vision_init from JAX artifacts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["state", "delta"])
def test_vision_init_from_jax_artifact(tmp_path, kind):
    jm = jax_cls.DPClassifier(14, vit_kwargs=vision_preset("vit", "base",
                                                            VIT))
    src = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, SIZE, SIZE, 3))), 6)
    if kind == "state":
        tx = jax_optim.make_adamw(1e-3, params_for_mask=src)
        path = jax_ckpt.save_train_state(
            str(tmp_path), jax_ts.TrainState.create(src, tx), 0)
    else:
        path = str(tmp_path / "delta.msgpack")
        jax_ckpt.save_delta(path, src, epoch=0, step=1)
    cfg = _dp_cfg(tmp_path)
    model, _, _ = loop.build_classifier(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    named = flax_named_parameters(model)
    before = {n: p.detach().clone() for n, p in named.items()}
    written = apply_vision_init(named, path, "vit", ("encoder",))
    assert set(written) == {n for n in named if n.startswith("encoder/")}
    # the JAX graft of the same tree (a JAX state: the JAX function does
    # not read its own deltas)
    target = jax.tree_util.tree_map(
        lambda t: np.zeros(t.shape, np.float32),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, SIZE, SIZE, 3))))
    state_path = path if kind == "state" else jax_ckpt.save_train_state(
        str(tmp_path / "s"), jax_ts.TrainState.create(
            src, jax_optim.make_adamw(1e-3)), 0)
    want = jax_bridge.apply_vision_init(target, state_path, "vit",
                                        ("encoder",))["params"]
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for p, leaf in flat:
        name = "/".join(k.key for k in p)
        ours = named[name].detach()
        if name in written:
            np.testing.assert_array_equal(
                ours.numpy(),
                to_port_layout(name.split("/"), torch.from_numpy(
                    np.asarray(leaf))).numpy(), err_msg=name)
        else:
            assert torch.equal(ours, before[name]), name
