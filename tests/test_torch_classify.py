"""Classification of the port against the JAX package on CPU, at a tiny size.

(a) The port's copies of the presets and the METEOR tables are
    byte-identical to the JAX package's files.
(b) ``VSSMClassifier`` (a tiny VSSM, the ``ref`` scan on the JAX side, the
    plain fused layer on the port's) and ``DPClassifier`` (a tiny ViT):
    logits and loss, 1e-5 of max(1, max |y|) and 1e-5 relative.
(c) ``mixup_cutmix`` exactly equal to the JAX function from the same
    ``default_rng``, on (B, 1, H, W, C) images: cutmix and mixup.
(d) ``evalx/classification.py`` equal to the JAX functions, with ties and a
    label without a positive (its AUC NaN and skipped).
(e) ``synthetic_learnable``: annotations and images equal to the JAX
    package's within one process.
(f) The slice as a whole: ``fit_classify`` on a tiny ``swinchex`` config
    (mixup 0.8, cutmix 1.0) for three steps from the JAX parameters, against
    the JAX ``make_train_step`` on the same batches (loss within 1e-5, grad
    norm within 1e-4), then its validation's ``acc_mean`` and ``auc_mean``
    against the JAX ``run_eval``'s computation; the same for a tiny
    ``vssm_classify`` through ``scan_backend: pallas``, with the trained
    parameters; and ``cli.train`` reaching the ``dp`` and ``vssm`` branches.
"""

import filecmp
import json
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.data import datasets as jax_data
from medical_image_analysis_tpu.evalx import chexbert as jax_chexbert
from medical_image_analysis_tpu.evalx import classification as jax_metrics
from medical_image_analysis_tpu.models import classifiers as jax_cls
from medical_image_analysis_tpu.models import swin as jax_swin
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu.train import train_state as jax_ts
from medical_image_analysis_tpu_torch.ckpt.from_jax import load_jax_params
from medical_image_analysis_tpu_torch.configs.config import load_config
from medical_image_analysis_tpu_torch.data import datasets
from medical_image_analysis_tpu_torch.evalx import classification as metrics
from medical_image_analysis_tpu_torch.models import classifiers
from medical_image_analysis_tpu_torch.train import loop

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "medical_image_analysis_tpu"
PORT_PKG = ROOT / "medical_image_analysis_tpu_torch"
SIZE = 56
SWIN_TINY = "{embed_dim: 16, depths: [2, 2], num_heads: [2, 4]}"


def _params(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "scale":
            return jnp.asarray(1.0 + 0.1 * v)
        return jnp.asarray(0.2 * v)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# --------------------------------------------------------------------------
# (a) the port's data files
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sub", ["configs/presets", "evalx/data"])
def test_data_files_are_byte_identical_copies(sub):
    ours = sorted(p.name for p in (PORT_PKG / sub).iterdir())
    theirs = sorted(p.name for p in (JAX_PKG / sub).iterdir()
                    if p.is_file())
    assert ours == theirs and ours
    for name in ours:
        assert filecmp.cmp(PORT_PKG / sub / name, JAX_PKG / sub / name,
                           shallow=False), name


# --------------------------------------------------------------------------
# (b) the classifiers
# --------------------------------------------------------------------------


def _images(seed, n, size=32):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", ["vssm", "dp"])
def test_classifiers_match_jax(kind):
    x = _images(1, 3)
    labels = (np.random.default_rng(2).uniform(size=(3, 14)) > 0.5).astype(
        np.float32)
    if kind == "vssm":
        kw = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64))
        jm = jax_cls.VSSMClassifier(
            14, vssm_kwargs=dict(kw, scan_backend="ref"))
        port = classifiers.VSSMClassifier(
            14, vssm_kwargs=dict(kw, scan_backend="plain"))
    else:
        kw = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2)
        jm = jax_cls.DPClassifier(14, vit_kwargs=kw)
        port = classifiers.DPClassifier(14, vit_kwargs=dict(kw, img_size=32))
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    jnp.asarray(x)), 3)
    want, want_loss = jax.jit(lambda p, x_, y_: (
        lambda lg: (lg, jax_cls.weighted_bce_loss(lg, y_)))(
            jm.apply(p, x_)))(params, jnp.asarray(x), jnp.asarray(labels))
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * scale
    loss = classifiers.weighted_bce_loss(got, torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)


# --------------------------------------------------------------------------
# (c) mixup / cutmix, (d) metrics, (e) synthetic_learnable
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_mixup_cutmix_equals_jax(seed):
    """Seeds 0 and 2 draw cutmix, 1 and 5 mixup (switch_prob 0.5)."""
    rng = np.random.default_rng(100 + seed)
    images = rng.standard_normal((6, 1, 20, 24, 3)).astype(np.float32)
    labels = (rng.uniform(size=(6, 14)) > 0.5).astype(np.int32)
    got = datasets.mixup_cutmix(np.random.default_rng(seed), images, labels)
    want = jax_data.mixup_cutmix(np.random.default_rng(seed), images, labels)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    mixed = (got[0] != images).any(axis=(1, 2, 4))
    assert mixed.any()


def test_classification_metrics_equal_jax():
    rng = np.random.default_rng(3)
    labels = (rng.uniform(size=(40, 5)) > 0.6).astype(np.int32)
    labels[:, 3] = 0  # no positive: NaN, skipped in the mean
    scores = np.round(rng.uniform(size=(40, 5)), 1)  # many ties
    logits2 = rng.standard_normal((40, 5, 2)).astype(np.float32)
    for c in range(5):
        a = metrics.roc_auc(scores[:, c], labels[:, c])
        b = jax_metrics.roc_auc(scores[:, c], labels[:, c])
        assert (np.isnan(a) and np.isnan(b)) or a == b
    got = metrics.multilabel_auc(scores, labels)
    want = jax_metrics.multilabel_auc(scores, labels)
    assert got["auc_mean"] == want["auc_mean"] and np.isfinite(
        got["auc_mean"])
    np.testing.assert_array_equal(got["auc_per_label"], want["auc_per_label"])
    assert (metrics.per_label_accuracy(logits2, labels)
            == jax_metrics.per_label_accuracy(logits2, labels))
    assert (metrics.pedestrian_metrics(scores, labels)
            == jax_metrics.pedestrian_metrics(scores, labels))


def test_learnable_synthetic_data_equals_jax():
    got = datasets.learnable_synthetic_annotations(n_train=20, holdout=8)
    want = jax_data.learnable_synthetic_annotations(n_train=20, holdout=8)
    for split in ("train", "val", "test"):
        assert [(s.id, s.image_paths, s.report, s.draft) for s in got[split]
                ] == [(s.id, s.image_paths, s.report, s.draft)
                      for s in want[split]]
    load = datasets.learnable_image_loader(SIZE, 2)
    jload = jax_data.learnable_image_loader(SIZE, 2)
    for s in got["train"][:3] + got["val"][:2]:
        np.testing.assert_array_equal(load(s), jload(s))


# --------------------------------------------------------------------------
# (f) the slice as a whole
# --------------------------------------------------------------------------

TRAIN_N, BATCH, LR = 24, 8, 1e-3


@pytest.fixture
def fixed_pixels(monkeypatch):
    """The synthetic pixels seeded by a fixed hash of the sample id (CRC-32)
    in place of Python's string hash, which changes between processes
    (ROADMAP.md, section 3): a run sees the same images every time. Both
    packages read the port's batcher in these tests, so they still see
    the same images."""
    monkeypatch.setattr(datasets, "hash",
                        lambda s: zlib.crc32(s.encode()), raising=False)


def _swinchex_sets(save_dir):
    return ["data.dataset=synthetic_learnable", f"data.input_size={SIZE}",
            f"data.batch_size={BATCH}", f"data.synthetic_train_size={TRAIN_N}",
            "data.num_workers=2", f"model.vision_kwargs={SWIN_TINY}",
            "train.epochs=1", f"train.lr={LR}", "train.warmup_steps=1",
            "train.log_every=100", f"train.save_dir={save_dir}"]


def test_fit_classify_swinchex_matches_jax(tmp_path, fixed_pixels):
    cfg = load_config(str(PORT_PKG / "configs/presets/swinchex.yaml"),
                      _swinchex_sets(tmp_path))
    t = cfg.train
    assert (t.mixup, t.cutmix, cfg.model.vision_size) == (0.8, 1.0, "large")
    jm = jax_swin.SwinCheX(backbone=jax_swin.SwinTransformer(
        **dict(jax_swin.SWIN_CONFIGS["swin_large"], embed_dim=16,
               depths=(2, 2), num_heads=(2, 4))), num_classes=14)
    params = _params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))), 4)

    # JAX: the batches of fit_classify's epoch 0, its mixup draws, its step
    ann = jax_data.learnable_synthetic_annotations(n_train=TRAIN_N)
    assert [s.id for s in ann["train"]] == [
        s.id for s in loop.build_data(cfg)[0]["train"]]
    _, _, batcher, _ = loop.build_data(cfg)  # the same batcher both ways
    train_b = batcher("train")
    try:
        batches = list(train_b.batches(epoch=0))
    finally:
        train_b.close()
    steps = len(batches)
    assert steps == 3
    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(LR, 1, steps),
                              weight_decay=t.weight_decay,
                              grad_clip=t.grad_clip, params_for_mask=params)

    def jax_loss(p, b, rng):
        return jax_cls.swinchex_loss(jm.apply(p, b["images"][:, 0]),
                                     b["labels"])

    state = jax_ts.TrainState.create(params, tx)
    step = jax_ts.make_train_step(jax_loss, tx, donate=False)
    want = []
    for i, batch in enumerate(batches):
        labels = np.stack([jax_chexbert.extract_labels(r)
                           for r in batch["reports"]]).astype(np.float32)
        imgs, labels = jax_data.mixup_cutmix(
            np.random.default_rng((t.seed, 0, i)), batch["images"], labels,
            mixup_alpha=t.mixup, cutmix_alpha=t.cutmix)
        state, m = step(state, {"images": jnp.asarray(imgs),
                                "labels": jnp.asarray(labels)},
                        jax.random.PRNGKey(0))
        want.append((float(m["loss"]), float(m["grad_norm"])))

    # JAX's run_eval over the val split with the trained parameters
    vb = batcher("val")
    try:
        val = list(vb.batches(shuffle=False, drop_last=False))
    finally:
        vb.close()
    n_val = len(vb.samples)
    logits_fn = jax.jit(jm.apply)
    logits = np.concatenate([np.asarray(logits_fn(
        state.params, jnp.asarray(b["images"][:, 0]))) for b in val])[:n_val]
    labels = np.concatenate([np.stack([jax_chexbert.extract_labels(r)
                                       for r in b["reports"]])
                             for b in val])[:n_val]
    e = np.exp(logits - logits.max(-1, keepdims=True))
    want_eval = {
        **jax_metrics.per_label_accuracy(logits, labels),
        "auc_mean": jax_metrics.multilabel_auc(
            (e / e.sum(-1, keepdims=True))[..., 1], labels)["auc_mean"]}

    # the port: fit_classify itself, started from the same parameters
    out = loop.fit_classify(
        cfg, "cpu", on_start=lambda model, _: load_jax_params(model, params))
    with open(tmp_path / "log.txt") as f:
        got = [r for r in map(json.loads, f) if "step" in r]
    assert len(got) == steps
    for i, (r, (loss, norm)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(r["grad_norm"], norm, rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")
    assert out["acc_mean"] == pytest.approx(want_eval["acc_mean"], abs=1e-9)
    assert out["auc_mean"] == pytest.approx(want_eval["auc_mean"], abs=1e-6)


VSSM_TINY = "{depths: [1, 1, 1, 1], dims: [8, 16, 32, 64], scan_backend: pallas}"


def test_fit_classify_vssm_pallas_matches_jax(tmp_path, fixed_pixels):
    """The slice as a whole: ``fit_classify`` on a tiny ``vssm_classify``
    (vssm_tiny's d_state 16 at depths (1, 1, 1, 1), 64^2 images, batch 4,
    EMA on)
    through ``scan_backend: pallas`` (the general scan's plain versions
    here) for three steps from the JAX parameters, against the JAX
    ``make_train_step`` of the same model through its Pallas kernels in
    interpret mode, on the same batches and mixup draws: loss within 1e-5
    and grad norm within 1e-4 relative, as the swinchex run; then every
    trained parameter's change from the start within 1e-3 of that tensor's
    largest change (Adam divides by the root of the second moment, so
    where a gradient is near zero a reordered sum moves the step more
    than the gradient)."""
    from medical_image_analysis_tpu_torch.ckpt.from_jax import (
        state_dict_from_jax,
    )

    size, batch = 64, 4
    cfg = load_config(str(PORT_PKG / "configs/presets/vssm_classify.yaml"), [
        "data.dataset=synthetic_learnable", f"data.input_size={size}",
        f"data.batch_size={batch}", f"data.synthetic_train_size={3 * batch}",
        "data.num_workers=2", f"model.vision_kwargs={VSSM_TINY}",
        "train.epochs=1", f"train.lr={LR}", "train.warmup_steps=1",
        "train.log_every=100", f"train.save_dir={tmp_path}"])
    t = cfg.train
    assert (t.mixup, t.cutmix, t.ema_decay) == (0.8, 1.0, 0.9999)
    jm = jax_cls.VSSMClassifier(14, vssm_kwargs=loop.vision_preset(
        "vssm", cfg.model.vision_size, cfg.model.vision_kwargs))
    assert jm.vssm_kwargs["scan_backend"] == "pallas"
    params = _params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))), 6)

    _, _, batcher, _ = loop.build_data(cfg)
    train_b = batcher("train")
    try:
        batches = list(train_b.batches(epoch=0))
    finally:
        train_b.close()
    steps = len(batches)
    assert steps == 3
    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(LR, 1, steps),
                              weight_decay=t.weight_decay,
                              grad_clip=t.grad_clip, params_for_mask=params)

    def jax_loss(p, b, rng):
        return jax_cls.weighted_bce_loss(jm.apply(p, b["images"][:, 0]),
                                         b["labels"])

    state = jax_ts.TrainState.create(params, tx)
    step = jax_ts.make_train_step(jax_loss, tx, donate=False)
    want = []
    for i, batch in enumerate(batches):
        labels = np.stack([jax_chexbert.extract_labels(r)
                           for r in batch["reports"]]).astype(np.float32)
        imgs, labels = jax_data.mixup_cutmix(
            np.random.default_rng((t.seed, 0, i)), batch["images"], labels,
            mixup_alpha=t.mixup, cutmix_alpha=t.cutmix)
        state, m = step(state, {"images": jnp.asarray(imgs),
                                "labels": jnp.asarray(labels)},
                        jax.random.PRNGKey(0))
        want.append((float(m["loss"]), float(m["grad_norm"])))

    seen = {}

    def on_start(model, _):
        load_jax_params(model, params)
        seen["model"] = model
        assert model.backbone.stage0_block0.op.scan_backend == "pallas"

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the plain scan's many tiny ops
    try:
        loop.fit_classify(cfg, "cpu", on_start=on_start)
    finally:
        torch.set_num_threads(threads)
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
    named = dict(seen["model"].named_parameters())
    assert set(named) == set(final)
    for name, p in named.items():
        got_move = (p.detach() - start[name]).numpy()
        want_move = (final[name] - start[name]).numpy()
        if "A_log" not in name:  # with L = 1 at stage 3 A_log stays put
            assert np.abs(want_move).max() > 0, name
        err = np.abs(got_move - want_move).max()
        assert err <= 1e-3 * max(np.abs(want_move).max(), 1e-12), (name, err)


@pytest.mark.parametrize("preset,sets", [
    ("dp_finetune.yaml", ["model.vision_kwargs={embed_dim: 32, depth: 1, "
                          "num_heads: 2}", "data.input_size=32"]),
    ("vssm_classify.yaml", ["model.vision_kwargs={depths: [1, 1, 1, 1], "
                            "dims: [8, 16, 32, 64]}", "data.input_size=32"]),
], ids=["dp", "vssm"])
def test_cli_train_classify_branches(tmp_path, preset, sets):
    """``cli.train`` reaches the ``dp`` and ``vssm`` branches of
    ``fit_classify`` (EMA on, as the presets have it) with no new flag, and
    validates."""
    from medical_image_analysis_tpu_torch.cli import train as cli_train

    argv = ["--device", "cpu", "--config",
            str(PORT_PKG / "configs/presets" / preset)]
    for item in ("data.dataset=synthetic_learnable", "data.batch_size=8",
                 "data.synthetic_train_size=16", "data.num_workers=2",
                 "train.epochs=1", "train.log_every=100",
                 f"train.save_dir={tmp_path}", *sets):
        argv += ["--set", item]
    out = cli_train.main(argv)
    assert np.isfinite(out["loss"]) and 0.0 <= out["auc_mean"] <= 1.0
    assert {"ma", "instance_f1"} <= set(out)
