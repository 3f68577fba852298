"""MAE pretraining of the port against the JAX package on CPU, at a tiny size
(d=32, 4 heads, hidden 128, 2 blocks, a 32-wide 2-block decoder, 64x64
images with patch 16: L = 16).

(a) ``MAE.forward`` with random and with region masking, from one JAX
    parameter tree carried across by ``ckpt.from_jax`` and the same noise
    (``jax.random.uniform`` of the JAX call's key; the two halves of its
    split for region masking): the loss within 1e-5 relative, the mask
    equal, the prediction within 1e-5 of its largest value.
(b) Three training steps of ``fit_mae``'s step (``mae_loss_fn`` +
    ``make_train_step`` + ``make_adamw``) against the JAX step, each step's
    noise drawn from the JAX step's key folded with the step: loss within
    1e-5 and grad norm within 1e-4.
(c) ``cli.train`` with ``model.task=mae`` on ``--device cpu``, and a kill
    and resume landing on the same state as the unbroken run.
(d) The ``mae_hd_1280`` preset as ``fit_mae`` builds it, on the meta device:
    patch 16, 3 channels, and its parameter count.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.models import vit as jax_vit
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu.train import train_state as jax_ts
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    flax_named_parameters,
    load_jax_params,
)
from medical_image_analysis_tpu_torch.configs.config import (
    load_config,
    make_config,
)
from medical_image_analysis_tpu_torch.models import vit
from medical_image_analysis_tpu_torch.train import loop, optim, train_state

KW = dict(patch_size=16, in_chans=3, embed_dim=32, depth=2, num_heads=4,
          decoder_embed_dim=32, decoder_depth=2, decoder_num_heads=4)
SIZE, BATCH = 64, 4
L = (SIZE // 16) ** 2
RATIOS = dict(mask_ratio=0.75, mask_ratio_inner=0.5)
PRESET = (Path(__file__).resolve().parents[1] / "medical_image_analysis_tpu"
          / "configs" / "presets" / "mae_hd_1280.yaml")


def _images(seed, n=BATCH):
    return np.random.default_rng(seed).standard_normal(
        (n, SIZE, SIZE, 3)).astype(np.float32)


def _jax_params(jm, seed=0):
    """A parameter tree of ``jm`` from its traced shapes, filled with numpy
    draws (an eager flax init is slow on this CPU)."""
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                        rng=jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return jnp.asarray(1.0 + 0.1 * rng.standard_normal(s.shape),
                               jnp.float32)
        std = 0.02 if "token" in name else max(s.shape[0], 1) ** -0.5
        return jnp.asarray(std * rng.standard_normal(s.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _noise(rng, mask_type, n=BATCH, l=L):
    """The noise the JAX masking draws from ``rng``, as the port takes it."""
    if mask_type == "random":
        return np.array(jax.random.uniform(rng, (n, l)))
    r1, r2 = jax.random.split(rng)
    idx_out, idx_in = vit.region_split(l)
    return np.concatenate([np.asarray(jax.random.uniform(r1, (n, len(idx_out)))),
                           np.asarray(jax.random.uniform(r2, (n, len(idx_in))))],
                          axis=1)


def _pair(seed=0):
    jm = jax_vit.MAE(**KW)
    params = _jax_params(jm, seed)
    port = vit.MAE(**KW)
    load_jax_params(port, params)
    return jm, params, port


@pytest.mark.parametrize("mask_type", ["random", "region"])
def test_mae_forward_matches_jax(mask_type):
    jm, params, port = _pair()
    imgs = _images(1)
    rng = jax.random.PRNGKey(3)
    apply = jax.jit(lambda p, x, r: jm.apply(p, x, rng=r, mask_type=mask_type,
                                             **RATIOS))
    j_loss, j_pred, j_mask = apply(params, jnp.asarray(imgs), rng)
    with torch.no_grad():
        loss, pred, mask = port(torch.from_numpy(imgs),
                                torch.from_numpy(_noise(rng, mask_type)),
                                mask_type, **RATIOS)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    scale = np.abs(np.asarray(j_pred)).max()
    assert np.abs(pred.numpy() - np.asarray(j_pred)).max() <= (
        1e-5 * scale)


@pytest.mark.parametrize("mask_type", ["random", "region"])
def test_mae_train_steps_match_jax(mask_type):
    steps, lr = 3, 1e-3
    jm, params, port = _pair(seed=4)
    imgs = _images(5)

    def jax_loss(p, b, r):
        return jm.apply(p, b["images"], rng=r, mask_type=mask_type,
                        deterministic=False, **RATIOS)[0]

    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(lr, 1, steps),
                              weight_decay=0.05, grad_clip=1.0,
                              params_for_mask=params)
    state = jax_ts.TrainState.create(params, tx)
    step = jax_ts.make_train_step(jax_loss, tx, donate=False)
    rng = jax.random.PRNGKey(7)
    want = []
    for _ in range(steps):
        state, metrics = step(state, {"images": jnp.asarray(imgs)}, rng)
        want.append((float(metrics["loss"]), float(metrics["grad_norm"])))

    m = make_config({"model": {"task": "mae", "mask_type": mask_type,
                               **RATIOS}}).model
    named = flax_named_parameters(port)
    ptx = optim.make_adamw(named, optim.warmup_cosine(lr, 1, steps),
                           weight_decay=0.05, grad_clip=1.0)
    pstate = train_state.TrainState(named, ptx)
    pstep = train_state.make_train_step(loop.mae_loss_fn(port, m))
    for i, (loss, norm) in enumerate(want):
        noise = _noise(jax.random.fold_in(rng, i), mask_type)
        got = pstep(pstate, {"images": torch.from_numpy(imgs),
                             "mask_noise": torch.from_numpy(noise)})
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(got["grad_norm"]), norm, rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")


def _cli_argv(save_dir, epochs, extra=()):
    sets = ["data.dataset=synthetic", f"data.input_size={SIZE}",
            "data.batch_size=8", "data.num_workers=2", "model.task=mae",
            "model.mask_type=region", "model.mask_ratio_inner=0.5",
            "model.vision_kwargs={embed_dim: 32, depth: 1, num_heads: 2, "
            "decoder_embed_dim: 16, decoder_depth: 1, decoder_num_heads: 2}",
            f"train.epochs={epochs}", "train.lr=1e-3", "train.warmup_steps=2",
            "train.log_every=100", f"train.save_dir={save_dir}", *extra]
    argv = ["--device", "cpu"]
    for item in sets:
        argv += ["--set", item]
    return argv


def test_cli_train_mae_and_kill_and_resume(tmp_path):
    """3 epochs straight against 2 epochs plus an auto-resume for the 3rd:
    the same final train state (the batches of an epoch depend on (seed,
    epoch), the masking noise of a step on (seed, step))."""
    from medical_image_analysis_tpu_torch.cli import train as cli_train

    out = cli_train.main(_cli_argv(tmp_path / "a", 3))
    assert set(out) == {"loss"} and np.isfinite(out["loss"])
    with open(tmp_path / "a" / "log.txt") as f:
        steps = [r for r in map(json.loads, f) if "step" in r]
    assert len(steps) == 12 and all(np.isfinite(r["loss"]) for r in steps)
    assert steps[-1]["step"] == 12 and steps[0]["lr"] == 0.0

    cli_train.main(_cli_argv(tmp_path / "b", 3,
                             ["train.max_epochs_this_run=2"]))
    cli_train.main(_cli_argv(tmp_path / "b", 3, ["train.resume=auto"]))

    def final(d):
        obj = torch.load(d / "state_epoch00002.pt", weights_only=True)
        return obj["epoch"], obj["state"]

    (ea, a), (eb, b) = final(tmp_path / "a"), final(tmp_path / "b")
    assert ea == eb == 2 and a["step"] == b["step"] == 12
    assert a["params"].keys() == b["params"].keys()
    for n in a["params"]:
        torch.testing.assert_close(a["params"][n], b["params"][n], rtol=2e-5,
                                   atol=2e-6, msg=n)
        torch.testing.assert_close(a["opt"]["mu"][n], b["opt"]["mu"][n],
                                   rtol=2e-5, atol=2e-6, msg=n)


def test_preset_builds_as_fit_mae_does():
    """``fit_mae`` hard-codes patch 16 and 3 channels (the preset's comment
    says patch 64); the encoder then runs 1 + 1100 + 300 tokens and the
    decoder 6401."""
    cfg = load_config(str(PRESET))
    model = loop.build_mae_model(cfg, device="meta")
    assert model.patch_size == 16 and model.in_chans == 3
    assert len(model.blocks) == 12 and len(model.decoder_blocks) == 8
    n = sum(p.numel() for p in model.parameters())
    assert n == 111_655_680
    idx_out, idx_in = vit.region_split((1280 // 16) ** 2)
    assert (len(idx_out), len(idx_in)) == (4400, 2000)
    keep = (int(len(idx_out) * (1 - cfg.model.mask_ratio))
            + int(len(idx_in) * (1 - cfg.model.mask_ratio_inner)))
    assert keep == 1400
    names = flax_named_parameters(model)
    assert "block0/qkv_kernel" in names and "dec_block7/fc2_bias" in names
    decay = optim.no_decay_mask(names)
    assert decay["block0/qkv_kernel"] and not decay["block0/ln1_scale"]
    assert not decay["cls_token"] and not decay["mask_token"]
    assert not decay["decoder_embed/bias"] and decay["decoder_pred/kernel"]
