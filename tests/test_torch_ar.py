"""MambaXray-VL stage 1 (AR pretraining) of the port against the JAX package
on CPU, at a tiny size.

(a) ``to_clusters`` and ``cluster_causal_mask`` equal the JAX functions;
    ``AR_CONFIGS`` and the ``skip`` layers are the JAX ones.
(b) A tiny ``VisionMambaAR`` (patch 4, embed 16 or 32, depth 2, 32x32
    images: a grid of 8, so 4 clusters and 3 of them fed to the encoder)
    from one JAX ``init``: the loss within 1e-5 relative, and every
    parameter's gradient within 1e-4 of that tensor's largest (the ARM
    parity tests' bound). The JAX side takes its CPU ``ref`` route, the
    port the plain versions of the fused layer (K=1). The decoder's key
    biases have a gradient of 0 in exact arithmetic (a softmax is
    unchanged by a shift along its keys), so there both sides must stay
    within 1e-8 of 0 instead.
(c) The recipe: ``fit_ar`` on the ``ar_pretrain`` preset (tiny widths, 3
    steps of 10 images) from the JAX parameters, against the JAX
    ``make_train_step`` with ``make_adamw`` over the same batches: loss
    within 1e-5 relative, grad norm within 1e-4, then every parameter's
    change from the start within 1e-3 of that tensor's largest change (Adam
    divides by the root of the second moment, so where a gradient is near
    zero a reordered sum moves the step more than the gradient). The key
    biases' gradients of rounding noise move each side by under a tenth of
    the learning rate a step, in signs of their own.
"""

import json
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.models import vision_mamba_ar as jax_ar
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu.train import train_state as jax_ts
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    load_jax_params,
    state_dict_from_jax,
)
from medical_image_analysis_tpu_torch.configs.config import load_config
from medical_image_analysis_tpu_torch.data import datasets
from medical_image_analysis_tpu_torch.models import vision_mamba_ar as ar
from medical_image_analysis_tpu_torch.train import loop

PRESETS = (Path(__file__).resolve().parents[1]
           / "medical_image_analysis_tpu_torch" / "configs" / "presets")
KEY_BIAS_ATOL = 1e-8


def _params(shapes, seed):
    """Random parameters of the JAX tree's shapes: norm scales near 1,
    ``A_log`` as the mixer's init (log 1..N), the rest N(0, 0.2^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "scale":
            return jnp.asarray(1.0 + 0.1 * v)
        if path[-1].key == "A_log":
            n = leaf.shape[-1]
            return jnp.asarray(np.broadcast_to(
                np.log(np.arange(1, n + 1, dtype=np.float32)), leaf.shape))
        return jnp.asarray(0.2 * v)

    return jax.tree_util.tree_map_with_path(fill, shapes)



@pytest.fixture(autouse=True)
def one_thread():
    """The port's many tiny ops run faster on one thread, and the parallel
    test run shares the cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# --------------------------------------------------------------------------
# (a) clusters, mask, configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [8, 12])
def test_to_clusters_equals_jax(grid):
    x = np.random.default_rng(grid).standard_normal(
        (2, grid * grid, 3)).astype(np.float32)
    want = np.asarray(jax_ar.to_clusters(jnp.asarray(x), grid))
    got = ar.to_clusters(torch.from_numpy(x), grid).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,tokens", [(3, 2), (8, 16)])
def test_cluster_causal_mask_equals_jax(n, tokens):
    got = ar.cluster_causal_mask(n, tokens)
    np.testing.assert_array_equal(got, jax_ar.cluster_causal_mask(n, tokens))
    # every row keeps its own cluster's block
    assert (np.diagonal(got) == 0).all() and got.shape == (n * tokens,) * 2


@pytest.mark.parametrize("depth", [1, 2, 5, 12, 24])
def test_ar_configs_and_skip_layers_are_the_jax_ones(depth):
    assert ar.AR_CONFIGS == jax_ar.AR_CONFIGS
    assert (ar.VisionMambaAR(patch_size=4, embed_dim=8, depth=depth,
                             dec_embed_dim=8, dec_heads=2, d_state=4,
                             device="meta").skip
            == jax_ar.VisionMambaAR(depth=depth).skip)


# --------------------------------------------------------------------------
# (b) the model: loss and every gradient
# --------------------------------------------------------------------------


def _tiny(embed):
    return dict(patch_size=4, embed_dim=embed, depth=2, dec_embed_dim=16,
                d_state=4, dec_heads=2)


@pytest.mark.parametrize("embed", [16, 32])
def test_vision_mamba_ar_loss_and_grads_match_jax(embed):
    x = np.random.default_rng(embed).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    jm = jax_ar.VisionMambaAR(**_tiny(embed), scan_backend="ref")
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    jnp.asarray(x)), embed + 1)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, jnp.asarray(x))))(params)
    want = state_dict_from_jax(grads)

    port = ar.VisionMambaAR(**_tiny(embed))
    load_jax_params(port, params)
    got = port(torch.from_numpy(x))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        err = (p.grad - want[name]).abs().max().item()
        if name.endswith(".k.bias"):
            assert want[name].abs().max() <= KEY_BIAS_ATOL, name
            assert p.grad.abs().max() <= KEY_BIAS_ATOL, name
            continue
        assert err <= 1e-4 * want[name].abs().max().item(), (name, err)


# --------------------------------------------------------------------------
# (c) the recipe
# --------------------------------------------------------------------------


@pytest.fixture
def fixed_pixels(monkeypatch):
    """The synthetic pixels seeded by CRC-32 of the sample id in place of
    Python's per-process string hash (ROADMAP.md, section 3); both packages
    read the port's batcher here, so they see the same images."""
    monkeypatch.setattr(datasets, "hash",
                        lambda s: zlib.crc32(s.encode()), raising=False)


BATCH, BLR = 10, 0.05  # 32 synthetic train samples: 3 steps


def test_fit_ar_matches_jax(tmp_path, fixed_pixels):
    kw = _tiny(16)
    cfg = load_config(str(PRESETS / "ar_pretrain.yaml"), [
        "data.dataset=synthetic", f"data.batch_size={BATCH}",
        "data.input_size=32", "data.num_workers=2",
        "model.vision_kwargs=" + json.dumps(kw), "train.epochs=1",
        f"train.blr={BLR}", "train.warmup_steps=1", "train.log_every=100",
        f"train.save_dir={tmp_path}"])
    t = cfg.train
    assert (cfg.model.task, t.grad_clip, t.weight_decay) == ("ar", 3.0, 0.05)
    jm = jax_ar.VisionMambaAR(**kw)  # scan_backend auto: its ref route here
    params = _params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    jnp.zeros((1, 32, 32, 3))), 7)

    _, _, batcher, _ = loop.build_data(cfg)
    train_b = batcher("train")
    try:
        batches = list(train_b.batches(epoch=0))
    finally:
        train_b.close()
    steps = len(batches)
    assert steps == 3
    lr = jax_optim.scaled_lr(BLR, BATCH)
    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(lr, 1, steps),
                              weight_decay=t.weight_decay,
                              grad_clip=t.grad_clip, params_for_mask=params)
    state = jax_ts.TrainState.create(params, tx)
    step = jax_ts.make_train_step(
        lambda p, b, rng: jm.apply(p, b["images"][:, 0]), tx, donate=False)
    want = []
    for batch in batches:
        state, m = step(state, {"images": jnp.asarray(batch["images"])},
                        jax.random.PRNGKey(0))
        want.append((float(m["loss"]), float(m["grad_norm"])))

    seen = {}

    def on_start(model, _):
        load_jax_params(model, params)
        seen["model"] = model

    out = loop.fit(cfg, "cpu", on_start=on_start)
    with open(tmp_path / "log.txt") as f:
        got = [r for r in map(json.loads, f) if "step" in r]
    assert len(got) == steps
    for i, (r, (loss, norm)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(r["grad_norm"], norm, rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")
    assert out["loss"] == pytest.approx(np.mean([r["loss"] for r in got]))
    assert sorted(p.name for p in tmp_path.glob("state_epoch*.pt")) == [
        "state_epoch00000.pt"]
    start, final = state_dict_from_jax(params), state_dict_from_jax(
        state.params)
    for name, p in seen["model"].named_parameters():
        want_move = (final[name] - start[name]).numpy()
        got_move = (p.detach() - start[name]).numpy()
        if name.endswith(".k.bias"):
            # a gradient of rounding noise, far under Adam's eps: both
            # sides move by a small fraction of lr a step, in signs of
            # their own
            for move in (got_move, want_move):
                assert np.abs(move).max() <= 0.1 * lr * steps, name
            continue
        err = np.abs(got_move - want_move).max()
        assert err <= 1e-3 * max(np.abs(want_move).max(), 1e-12), (name, err)
