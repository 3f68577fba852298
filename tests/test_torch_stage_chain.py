"""Stage chaining of the port (``ckpt/bridge.py`` and ``model.vision_init``)
against the JAX package on CPU, at a tiny size.

(a) ``ar_encoder_to_arm`` and ``mae_encoder_to_vit`` give exactly the JAX
    functions' numbers on one numpy tree (a JAX ``init``'s shapes, random
    values), and ``resolve_vision_overlay`` picks the same subtree of every
    kind of artifact for each tower family.
(b) ``graft``, ``ar_encoder_to_arm`` and ``resolve_vision_overlay`` raise
    where the JAX functions raise, with the same exception types.
(c) ``load_pretrain_params`` reads the port's own artifacts: a train state
    (trainable and frozen tensors) and a delta.
(d) Three chains end to end through ``loop.fit``, as the JAX package's
    ``tests/test_stage_chain.py`` runs them: AR -> CLIP -> r2gengpt, MAE ->
    dp_finetune, and a VSSM classifier -> a VSSM classifier. Before its
    first step each later stage holds the earlier stage's trained tower
    exactly (the AR mixers tiled to four directions), and each run ends
    with finite results.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.ckpt import bridge as jax_bridge
from medical_image_analysis_tpu.models import vision_mamba_ar as jax_ar
from medical_image_analysis_tpu.models import vit as jax_vit
from medical_image_analysis_tpu_torch.ckpt import bridge
from medical_image_analysis_tpu_torch.ckpt.checkpoint import (
    auto_resume_helper,
    save_delta,
    save_train_state,
)
from medical_image_analysis_tpu_torch.configs.config import make_config
from medical_image_analysis_tpu_torch.train import loop

TINY_AR = dict(patch_size=4, embed_dim=16, depth=2, d_state=4,
               dec_embed_dim=16, dec_heads=2)
TINY_ARM = dict(patch_size=4, embed_dim=16, depth=2, d_state=4,
                drop_path_rate=0.0)
TINY_LLM = dict(dim=32, n_layers=1, n_heads=4, n_kv_heads=4, hidden_dim=64)
TINY_MAE = dict(embed_dim=16, depth=1, num_heads=2, decoder_embed_dim=16,
                decoder_depth=1, decoder_num_heads=2)
TINY_VIT = dict(patch_size=16, embed_dim=16, depth=1, num_heads=2)
TINY_VSSM = dict(depths=[1, 1, 1, 1], dims=[8, 16, 32, 64])


def _numpy_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _plain(tree):
    """A flax tree as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _same(got: dict, want: dict):
    g, w = bridge.flatten(got), bridge.flatten(_plain(want))
    assert set(g) == set(w)
    for name in g:
        np.testing.assert_array_equal(np.asarray(g[name]), w[name],
                                      err_msg=name)


# --------------------------------------------------------------------------
# (a) the surgery and the overlay's choice
# --------------------------------------------------------------------------


def _ar_tree():
    jm = jax_ar.VisionMambaAR(**TINY_AR, scan_backend="ref")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    return _plain(_numpy_tree(shapes, 1))["params"]


def _mae_tree():
    jm = jax_vit.MAE(**TINY_MAE)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)),
                            jax.random.PRNGKey(1))
    return _plain(_numpy_tree(shapes, 2))["params"]


def test_ar_encoder_to_arm_equals_jax():
    tree = _ar_tree()
    want = jax_bridge.ar_encoder_to_arm(tree)
    got = bridge.ar_encoder_to_arm(_torch(tree))
    _same(got, want)
    a_log = got["layers_1"]["mixer"]["A_log"]
    assert a_log.shape[0] == 4 and all(
        torch.equal(a_log[i], torch.from_numpy(
            tree["layers_1"]["mixer"]["A_log"][0])) for i in range(4))
    assert "enc2dec" not in got and "ar_token" not in got


def test_mae_encoder_to_vit_equals_jax():
    tree = _mae_tree()
    _same(bridge.mae_encoder_to_vit(_torch(tree)),
          jax_bridge.mae_encoder_to_vit(tree))


def _leaf():
    return np.zeros((2, 3), np.float32)


ARTIFACTS = {  # kind -> (family, tree)
    "clip": ("arm", {"visual_encoder": {"norm_f": {"scale": _leaf()}},
                     "head": {"logit_scale": _leaf()}}),
    "sft-arm": ("arm", {"vision": {"arm": {"norm_f": {"scale": _leaf()}}},
                        "proj": {"kernel": _leaf()}}),
    "bare-arm": ("arm", {"layers_0": {"norm": {"scale": _leaf()}},
                         "norm_f": {"scale": _leaf()}}),
    "mae": ("vit", {"encoder_norm": {"scale": _leaf()},
                    "block0": {"ln1_scale": _leaf()},
                    "cls_token": _leaf(), "decoder_pred": {"bias": _leaf()}}),
    "sft-vit": ("vit", {"vision": {"vit": {"norm": {"scale": _leaf()}}}}),
    "dp": ("vit", {"encoder": {"norm": {"scale": _leaf()}},
                   "head": {"bias": _leaf()}}),
    "bare-vit": ("vit", {"block0": {"ln1_scale": _leaf()},
                         "norm": {"scale": _leaf()}}),
    "vssm-cls": ("vssm", {"backbone": {"patch_embed": {"bias": _leaf()}},
                          "head": {"bias": _leaf()}}),
    "sft-vssm": ("vssm", {"vision": {"vssm": {"layers_0": {"x": _leaf()}}}}),
    "bare-vssm": ("vssm", {"patch_embed": {"bias": _leaf()}}),
}


@pytest.mark.parametrize("kind", sorted(ARTIFACTS))
def test_resolve_vision_overlay_picks_as_jax(kind):
    family, tree = ARTIFACTS[kind]
    _same(bridge.resolve_vision_overlay(_torch(tree), family),
          jax_bridge.resolve_vision_overlay(tree, family))


# --------------------------------------------------------------------------
# (b) refusals
# --------------------------------------------------------------------------


def _two_direction_ar():
    return {"patch_embed": {}, "layers_0": {
        "mixer": {"A_log": np.zeros((2, 4, 4), np.float32)}, "norm": {}}}


REFUSALS = {  # case -> (call on a package's bridge, exception type)
    "ar-two-directions": (lambda b, t: b.ar_encoder_to_arm(
        t(_two_direction_ar())), ValueError),
    "graft-unknown-leaf": (lambda b, t: b.graft(
        t({"a": {"x": np.zeros(2)}}), ("a",), t({"y": np.zeros(2)})),
        KeyError),
    "graft-shape": (lambda b, t: b.graft(
        t({"a": {"x": np.zeros(2)}}), ("a",), t({"x": np.zeros(3)})),
        ValueError),
    "graft-unknown-subtree": (lambda b, t: b.graft(
        t({"a": {"x": np.zeros(2)}}), ("b",), t({"x": np.zeros(2)})),
        KeyError),
    "resolve-nothing": (lambda b, t: b.resolve_vision_overlay(
        t({"something": {}}), "arm"), ValueError),
    "resolve-wrong-family": (lambda b, t: b.resolve_vision_overlay(
        t({"backbone": {}}), "vit"), ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_bridge_raises_where_jax_raises(case):
    call, exc = REFUSALS[case]
    with pytest.raises(exc) as want:
        call(jax_bridge, lambda t: t)
    with pytest.raises(exc) as got:
        call(bridge, _torch)
    assert type(got.value) is type(want.value)


# --------------------------------------------------------------------------
# (c) the port's artifacts
# --------------------------------------------------------------------------


def test_load_pretrain_params_reads_states_and_deltas(tmp_path):
    a, b = torch.arange(4.0), torch.ones(2, 2)
    path = save_train_state(str(tmp_path), {
        "step": 3, "params": {"vision/arm/norm_f/scale": a},
        "frozen": {"llm/tok/embedding": b}, "opt": {}, "ema": None}, 0)
    tree = bridge.load_pretrain_params(path)
    assert torch.equal(tree["vision"]["arm"]["norm_f"]["scale"], a)
    assert torch.equal(tree["llm"]["tok"]["embedding"], b)
    save_delta(str(tmp_path / "delta.pt"), {"head/logit_scale": a[0]})
    tree = bridge.load_pretrain_params(str(tmp_path / "delta.pt"))
    assert torch.equal(tree["head"]["logit_scale"], a[0])


# --------------------------------------------------------------------------
# (d) the chains
# --------------------------------------------------------------------------


@pytest.fixture
def one_thread():
    """The plain scans' many tiny ops run faster on one thread, and the
    parallel test run shares the cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(save_dir, task, batch=4, **model):
    return make_config({
        "data": {"dataset": "synthetic", "batch_size": batch, "input_size": 32,
                 "max_len": 16, "vocab_min_freq": 1, "num_workers": 2},
        "model": {"task": task, **model},
        "train": {"epochs": 1, "lr": 1e-3, "warmup_steps": 2,
                  "log_every": 100, "save_dir": str(save_dir)},
        "generate": {"num_beams": 1, "max_new_tokens": 4,
                     "min_new_tokens": 1, "max_cache_len": 160},
    })


def _trained(save_dir) -> dict:
    """The parameters a recipe's last train state holds, by flax path."""
    state = torch.load(auto_resume_helper(str(save_dir)), weights_only=True)
    return {**state["state"]["frozen"], **state["state"]["params"]}


def _holds(named: dict, prefix: str, source: dict, tile: int = 1):
    """Every tensor of ``source`` sits at ``prefix``/name in ``named``
    (a mixer's direction-leading tensors tiled ``tile`` times)."""
    for name, want in source.items():
        leaf = name.rsplit("/", 1)[-1]
        if tile > 1 and "/mixer/" in name and leaf in bridge._K_LEADING:
            want = want.repeat(tile, *([1] * (want.dim() - 1)))
        got = named[f"{prefix}/{name}"].detach()
        assert torch.equal(got, want.to(got.dtype)), name


def _encoder_of(trained, drop):
    return {n: t for n, t in trained.items()
            if not n.startswith(drop) and not n.startswith("norm_")}


def test_ar_to_clip_to_r2gengpt_chain(tmp_path, one_thread):
    loop.fit(_cfg(tmp_path / "ar", "ar", 8, vision_kwargs=TINY_AR), "cpu")
    ar_params = _trained(tmp_path / "ar")
    ar_state = auto_resume_helper(str(tmp_path / "ar"))

    def check_clip(model, state):
        from medical_image_analysis_tpu_torch.ckpt.from_jax import (
            flax_named_parameters,
        )

        named = flax_named_parameters(model)
        _holds(named, "visual_encoder", _encoder_of(
            ar_params, ("enc2dec", "ar_", "dec_block")), tile=4)
        assert named["head/logit_scale"].item() == pytest.approx(
            math.log(1 / 0.07))

    clip_cfg = _cfg(tmp_path / "clip", "clip", 8, vision_size="base",
                    vision_kwargs=TINY_ARM, vision_init=ar_state)
    vocab = loop.build_data(clip_cfg)[1].vocab_size
    clip_cfg.model.task_kwargs = {"proj_dim": 8, "text_kwargs": dict(
        vocab_size=vocab, dim=16, depth=2, num_heads=2, max_len=16)}
    out = loop.fit(clip_cfg, "cpu", on_start=check_clip)
    assert np.isfinite(out["loss"])
    clip_params = _trained(tmp_path / "clip")
    tower = {n.split("/", 1)[1]: t for n, t in clip_params.items()
             if n.startswith("visual_encoder/")}

    def check_sft(model, state):
        from medical_image_analysis_tpu_torch.ckpt.from_jax import (
            flax_named_parameters,
        )

        _holds(flax_named_parameters(model), "vision/arm", tower)

    scores = loop.fit(_cfg(
        tmp_path / "sft", "r2gengpt", vision="arm", vision_kwargs=TINY_ARM,
        llm_kwargs=TINY_LLM, vision_init=auto_resume_helper(
            str(tmp_path / "clip"))), "cpu", on_start=check_sft)
    assert "Bleu_4" in scores and np.isfinite(scores["val_score"])


def test_mae_to_dp_chain(tmp_path, one_thread):
    loop.fit(_cfg(tmp_path / "mae", "mae", vision_kwargs=TINY_MAE), "cpu")
    mae = _trained(tmp_path / "mae")
    encoder = {("norm/" + n.split("/", 1)[1] if n.startswith("encoder_norm/")
                else n): t for n, t in mae.items()
               if n.startswith(("block", "cls_token", "patch_embed",
                                "encoder_norm"))}

    def check(model, state):
        _holds(state.params, "encoder", encoder)

    res = loop.fit(_cfg(tmp_path / "dp", "dp", vision="vit",
                        vision_kwargs=TINY_VIT,
                        vision_init=auto_resume_helper(str(tmp_path / "mae"))),
                   "cpu", on_start=check)
    assert "instance_f1" in res and np.isfinite(res["loss"])


def test_vssm_classifier_to_vssm_classifier_chain(tmp_path, one_thread):
    loop.fit(_cfg(tmp_path / "a", "swinchex", 8, vision="vssm",
                  vision_kwargs=TINY_VSSM), "cpu")
    backbone = {n.split("/", 1)[1]: t
                for n, t in _trained(tmp_path / "a").items()
                if n.startswith("backbone/")}

    def check(model, state):
        _holds(state.params, "backbone", backbone)
        assert not torch.equal(state.params["head/kernel"].detach(),
                               _trained(tmp_path / "a")["head/kernel"])

    res = loop.fit(_cfg(tmp_path / "b", "swinchex", 8, vision="vssm",
                        vision_kwargs=TINY_VSSM,
                        vision_init=auto_resume_helper(str(tmp_path / "a"))),
                   "cpu", on_start=check)
    assert np.isfinite(res["loss"]) and 0.0 <= res["auc_mean"] <= 1.0
