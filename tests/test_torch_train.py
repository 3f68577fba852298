"""The port's training slice against the JAX package on CPU, at tiny sizes.

(a) The fused Mamba layer's backward (``MambaFusedFn``: ``scan_bwd_plain``
    and the PyTorch closure) against ``jax.grad`` of the JAX layer in
    Pallas interpret mode, and ``scan_bwd_plain`` against autograd of
    ``scan_plain``. fp32 with the same formulas on both sides; only the
    order of sums and libm ulps differ: 1e-5 of the largest gradient.
(b) Three train steps of a tiny R2GenGPT (ARM tower, fp32 LLM with LoRA r2
    on q/v, frozen LLM, accumulation 2, remat, warmup 1) from one JAX init
    and one JAX LoRA tree, against ``make_train_step`` + ``make_adamw``:
    loss, grad norm (restricted to the trainable leaves) and every
    trainable tensor after the steps. Tolerances are stated at the test.
(c) ``compute_nlg_scores`` and ``clinical_efficacy`` equal the JAX ones.
(d) ``fit`` on synthetic data at ``tests/test_loop.py``'s sizes: scores,
    files, and a kill-and-resume run landing on the same state.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.evalx import chexbert as jax_chexbert
from medical_image_analysis_tpu.evalx import nlg as jax_nlg
from medical_image_analysis_tpu.models import llm as jax_llm
from medical_image_analysis_tpu.models import mrg as jax_mrg
from medical_image_analysis_tpu.ops.mamba_fused import (
    mamba_fused_dirs as jax_mamba_fused_dirs,
)
from medical_image_analysis_tpu.peft import lora as jax_lora
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu.train import loop as jax_loop
from medical_image_analysis_tpu.train import train_state as jax_ts
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    flax_named_parameters,
    load_jax_params,
    lora_from_jax,
)
from medical_image_analysis_tpu_torch.configs.config import make_config
from medical_image_analysis_tpu_torch.evalx.chexbert import clinical_efficacy
from medical_image_analysis_tpu_torch.evalx.nlg import compute_nlg_scores
from medical_image_analysis_tpu_torch.models import llm, mrg
from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
from medical_image_analysis_tpu_torch.peft.lora import (
    apply_lora,
    llama_qv_rules,
)
from medical_image_analysis_tpu_torch.train import loop, optim, train_state

GRAD_RTOL = 1e-5  # (a): relative to the largest gradient of the tensor


def _rand(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _fused_inputs(k_dirs, seed=0, b=2, l=10, d=8, n=4, r=4):
    rng = np.random.default_rng(seed)
    xr = _rand(rng, b, l, d)
    xc = _rand(rng, b, l, d) if k_dirs == 4 else None
    p = dict(
        conv_w=_rand(rng, k_dirs, 4, d), conv_b=_rand(rng, k_dirs, d),
        x_proj_w=_rand(rng, k_dirs, r + 2 * n, d),
        dt_proj_w=_rand(rng, k_dirs, d, r), dt_bias=_rand(rng, k_dirs, d),
        A=-np.exp(_rand(rng, k_dirs, d, n, scale=0.3)),
        D=_rand(rng, k_dirs, d),
    )
    w = _rand(rng, b, k_dirs, l, d)
    return xr, xc, p, w


def _assert_grad_close(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= GRAD_RTOL * scale, (name, err, scale)


# --------------------------------------------------------------------------
# (a) the fused layer's backward
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "k_dirs,use_conv", [(1, True), (2, True), (4, True), (4, False)],
    ids=["k1", "k2", "k4", "k4-noconv"],
)
def test_fused_grads_match_jax(k_dirs, use_conv):
    xr, xc, p, w = _fused_inputs(k_dirs, seed=k_dirs)
    names = sorted(p)

    def jax_loss(xr_, xc_, *vals):
        y = jax_mamba_fused_dirs(
            xr_, xc_, **dict(zip(names, vals)), chunk=4, block_d=8,
            interpret=True, use_conv=use_conv,
        )
        return jnp.sum(jnp.sin(y) * w)

    args = [jnp.asarray(xr), None if xc is None else jnp.asarray(xc)]
    args += [jnp.asarray(p[k]) for k in names]
    argnums = tuple(i for i, a in enumerate(args) if a is not None)
    want = jax.grad(jax_loss, argnums=argnums)(*args)

    leaves = [None if a is None else torch.tensor(a, requires_grad=True)
              for a in [xr, xc] + [p[k] for k in names]]
    y = mf.mamba_fused_dirs(leaves[0], leaves[1],
                            **dict(zip(names, leaves[2:])), use_conv=use_conv)
    assert y.grad_fn is not None
    (torch.sin(y) * torch.from_numpy(w)).sum().backward()
    labels = ["xr", "xc", *names]
    for i, g in zip(argnums, want):
        _assert_grad_close(labels[i], leaves[i].grad, g)


@pytest.mark.parametrize("k_dirs", [1, 4])
def test_scan_bwd_plain_matches_autograd_of_scan_plain(k_dirs):
    """x_dbl is an input of the scan here, so its gradient (the dB, dC and
    dt_r sums) is compared directly; the grads w.r.t. the sources and the
    conv come from the closure with the x_proj path left out."""
    xr, xc, p, w = _fused_inputs(k_dirs, seed=10 + k_dirs)
    t = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    xr_t = torch.tensor(xr, requires_grad=True)
    xc_t = None if xc is None else torch.tensor(xc, requires_grad=True)
    with torch.no_grad():
        x_dbl = mf.xdbl_plain(xr_t, xc_t, t["conv_w"], t["conv_b"],
                              t["x_proj_w"])
    x_dbl.requires_grad_()
    args = (xr_t, xc_t, x_dbl, t["conv_w"], t["conv_b"], t["dt_proj_w"],
            t["dt_bias"], t["A"], t["D"])
    dy = torch.from_numpy(w)
    y = mf.scan_plain(*args)
    inputs = [a for a in args if a is not None]
    want = dict(zip(
        ["xr", "xc", "xdbl", "conv_w", "conv_b", "dt_proj_w", "dt_bias", "A",
         "D"] if xc is not None else
        ["xr", "xdbl", "conv_w", "conv_b", "dt_proj_w", "dt_bias", "A", "D"],
        torch.autograd.grad(y, inputs, dy),
    ))
    with torch.no_grad():
        du, u, ds, dxdbl, d_a, d_d, ddb, ddtw = mf.scan_bwd_plain(
            *[a.detach() if a is not None else None for a in args], dy)
        _assert_grad_close("xdbl", dxdbl, want["xdbl"])
        dxr, dxc, dconv_w, dconv_b, _, ddtw_k, ddb_k, da_k, dd_k = (
            mf._close_bwd(xr_t, xc_t, t["conv_w"], t["x_proj_w"], True, du,
                          u, ds, torch.zeros_like(dxdbl), d_a, d_d, ddb,
                          ddtw))
    got = dict(xr=dxr, xc=dxc, conv_w=dconv_w, conv_b=dconv_b,
               dt_proj_w=ddtw_k, dt_bias=ddb_k, A=da_k, D=dd_k)
    for name, g in got.items():
        if name in want:
            _assert_grad_close(name, g, want[name])


# --------------------------------------------------------------------------
# (b) three train steps against the JAX step
# --------------------------------------------------------------------------

ARM_KW = dict(patch_size=16, embed_dim=32, depth=2, d_state=4, remat=True)
STEPS, LR, ACCUM = 3, 1e-3, 2


def _tiny_train_pair():
    c = jax_llm.LLM_CONFIGS["tiny_test"]
    fields = dict(vocab_size=c.vocab_size, dim=c.dim, n_layers=c.n_layers,
                  n_heads=c.n_heads, n_kv_heads=c.n_kv_heads,
                  hidden_dim=c.hidden_dim)
    jm = jax_mrg.R2GenGPT(
        llm_cfg=jax_llm.LLMConfig(**fields, dtype=jnp.float32, remat=True),
        chosen="arm", vision_kwargs=ARM_KW,
    )
    port = mrg.R2GenGPT(
        llm.LLMConfig(**fields, dtype=torch.float32, remat=True),
        chosen="arm", vision_kwargs=dict(ARM_KW, img_size=32),
    ).eval()
    rng = np.random.default_rng(7)
    batch = dict(
        images=rng.standard_normal((4, 2, 32, 32, 3)).astype(np.float32),
        before_ids=rng.integers(4, c.vocab_size, (4, 5)).astype(np.int32),
        after_ids=rng.integers(4, c.vocab_size, (4, 3)).astype(np.int32),
        target_ids=rng.integers(4, c.vocab_size, (4, 6)).astype(np.int32),
        target_mask=np.array([[1] * 6, [1] * 4 + [0] * 2, [1] * 5 + [0],
                              [1] * 3 + [0] * 3], np.int32),
    )
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              *(jnp.asarray(v) for v in batch.values()))
    load_jax_params(port, params)
    rules = jax_lora.llama_qv_rules(rank=2)
    lora = jax_lora.init_lora(jax.random.PRNGKey(2), params, rules)
    # a non-zero b, so that the merge moves the loss from the first step
    lora = {k: {"a": v["a"], "b": jnp.asarray(_rand(rng, *v["b"].shape,
                                                     scale=0.05))}
            for k, v in lora.items()}
    return jm, params, lora, rules, port, batch


def test_train_steps_match_jax():
    jm, params, lora, rules, port, batch = _tiny_train_pair()

    # JAX: make_train_step + make_adamw, as fit_mrg builds them
    train_params = {"base": params, "lora": lora}
    mask = {"base": jax_loop.trainable_mask(params, True, False),
            "lora": jax.tree_util.tree_map(lambda _: True, lora)}
    sched = jax_optim.warmup_cosine(LR, 1, STEPS)
    tx = jax_optim.make_adamw(sched, weight_decay=0.05, grad_clip=1.0,
                              params_for_mask=train_params,
                              trainable_mask=mask)

    def jax_loss(p, b, rng):
        return jm.apply(jax_lora.apply_lora(p["base"], p["lora"], rules),
                        *(b[k] for k in batch))

    state = jax_ts.TrainState.create(train_params, tx)
    step = jax_ts.make_train_step(jax_loss, tx, accum_steps=ACCUM,
                                  donate=False)
    vag = jax.jit(jax_ts._accum_value_and_grad(jax_loss, ACCUM))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(1)
    want = []
    for _ in range(STEPS):
        _, grads = vag(state.params, jbatch, rng)
        masked = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda g, m: g if m else jnp.zeros(()), grads, mask))
        state, metrics = step(state, jbatch, rng)
        want.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                     float(jnp.sqrt(sum(jnp.sum(g * g) for g in masked)))))

    # the port: the same recipe as loop.fit_mrg builds it
    named = flax_named_parameters(port)
    tmask = loop.trainable_mask(named, True, False)
    for n, p in named.items():
        p.requires_grad_(tmask[n])
    plora = lora_from_jax(lora)
    apply_lora(port, plora, llama_qv_rules(rank=2))
    trainable = {f"base/{n}": p for n, p in named.items() if tmask[n]}
    for key, ab in plora.items():
        for part, tensor in ab.items():
            trainable[f"lora/{key}/{part}"] = tensor
    ptx = optim.make_adamw(trainable, optim.warmup_cosine(LR, 1, STEPS),
                           weight_decay=0.05, grad_clip=1.0)
    pstate = train_state.TrainState(trainable, ptx)
    pstep = train_state.make_train_step(lambda b: port(*b.values()), ACCUM)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = [pstep(pstate, tbatch) for _ in range(STEPS)]

    for i, ((loss, jax_norm, masked_norm), m) in enumerate(zip(want, got)):
        # fp32 on both sides, summation order only
        np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), masked_norm,
                                   rtol=1e-4, err_msg=f"grad_norm, step {i}")
        # JAX's reported norm also counts the frozen LLM's gradients
        assert jax_norm > float(m["grad_norm"])

    # Every trainable tensor after the steps. Adam divides each gradient
    # element by its own running RMS, so where an element's gradient is
    # near the summation noise of the others, a reordered sum moves its
    # update by a fraction of lr itself: 5e-2 of lr over the three steps.
    jbase = flax_named_parameters_of_tree(state.params["base"]["params"])
    for name, tensor in trainable.items():
        kind, rest = name.split("/", 1)
        if kind == "base":
            want_v = np.asarray(jbase[rest])
            if rest.endswith("/kernel") and want_v.ndim == 2:
                want_v = want_v.T
            elif rest.endswith("/kernel") and want_v.ndim == 4:
                want_v = want_v.transpose(3, 2, 0, 1)
        else:
            key, part = rest.rsplit("/", 1)
            want_v = np.asarray(state.params["lora"]["params/" + key][part])
        np.testing.assert_allclose(tensor.detach().numpy(), want_v, rtol=0,
                                   atol=5e-2 * LR, err_msg=name)
        moved = np.abs(want_v - np.asarray(_initial(name, params, lora)))
        assert moved.max() > 0, f"{name} did not move"


def flax_named_parameters_of_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(flax_named_parameters_of_tree(v, path))
        else:
            out[path] = v
    return out


def _initial(name, params, lora):
    kind, rest = name.split("/", 1)
    if kind == "lora":
        key, part = rest.rsplit("/", 1)
        return lora["params/" + key][part]
    v = np.asarray(flax_named_parameters_of_tree(params["params"])[rest])
    if rest.endswith("/kernel") and v.ndim == 2:
        return v.T
    if rest.endswith("/kernel") and v.ndim == 4:
        return v.transpose(3, 2, 0, 1)
    return v


def test_optimizer_pieces_match_optax():
    """The schedule is 0 at count 0 (one step proves nothing), and the
    clip scales by max/norm only when norm >= max, over the given leaves."""
    ours = optim.warmup_cosine(1e-3, 3, 10)
    theirs = jax_optim.warmup_cosine(1e-3, 3, 10)
    for count in range(12):
        np.testing.assert_allclose(ours(count), float(theirs(count)),
                                   rtol=1e-6, atol=1e-12)
    assert ours(0) == 0.0
    names = ["vision/arm/layers_0/norm/scale", "proj/kernel", "proj/bias",
             "vision/arm/layers_0/mixer/D", "vision/arm/layers_0/mixer/A_log",
             "vision/arm/layers_0/mixer/x_proj_w",
             "llm/embed_tokens/embedding"]
    tree = {}
    for n in names:
        node = tree
        parts = n.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.zeros(1)
    jmask = flax_named_parameters_of_tree(jax_optim.no_decay_mask(tree))
    assert optim.no_decay_mask(names) == jmask

    import optax

    for scale in (0.5, 3.0):  # below and above the clip
        g = {"a": np.full((3,), scale, np.float32),
             "b": np.full((2, 2), -scale, np.float32)}
        clip = optax.clip_by_global_norm(1.0)
        want, _ = clip.update({k: jnp.asarray(v) for k, v in g.items()},
                              clip.init(g))
        p = {k: torch.zeros(v.shape) for k, v in g.items()}
        tx = optim.AdamW(p, lambda _: 1.0, weight_decay=0.0, b1=0.0,
                         b2=0.0, eps=0.0, grad_clip=1.0)
        tx.step({k: torch.from_numpy(v) for k, v in g.items()})
        # b1 = b2 = 0, eps = 0: the update is -sign(clipped g), and mu
        # holds the clipped gradient itself
        for k in g:
            np.testing.assert_allclose(tx.mu[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6)


def test_data_layer_matches_jax(tmp_path):
    """Annotations, report cleaning, the chexbert csv, two-view grouping,
    the corpus tokenizer, fixed-shape batches and the disk loader give
    what the JAX package's give."""
    import PIL.Image

    from medical_image_analysis_tpu.data import datasets as jd
    from medical_image_analysis_tpu.data.tokenizer import (
        WordTokenizer as JaxTokenizer,
    )
    from medical_image_analysis_tpu_torch.data import datasets as pd
    from medical_image_analysis_tpu_torch.data.tokenizer import WordTokenizer

    rng = np.random.default_rng(3)
    for i in range(3):
        img = rng.integers(0, 255, (40 + i, 36, 3), dtype=np.uint8)
        PIL.Image.fromarray(img).save(tmp_path / f"v{i}.png")
    recs = [
        {"id": i, "study_id": i // 2, "image_path": [f"v{i}.png"],
         "report": f"The heart is normal.  No effusion ({i}).\n1. ok"}
        for i in range(3)
    ] + [{"id": 9, "image_path": "v0.png", "report": "ok."}]
    ann_path = tmp_path / "annotation.json"
    ann_path.write_text(json.dumps({"train": recs, "val": recs[:1]}))
    (tmp_path / "chex.csv").write_text(
        "id,image_path,A,B,C\n0,x,1,-1,\n1,y,0,1.0,1\n")

    ja = jd.load_annotations(str(ann_path), "mimic_cxr")
    pa = pd.load_annotations(str(ann_path), "mimic_cxr")
    assert [vars(s) for s in pa["train"]] == [vars(s) for s in ja["train"]]
    assert [s.id for s in pd.drop_unclear_reports(pa["train"])] == [
        s.id for s in jd.drop_unclear_reports(ja["train"])]
    jc = jd.load_chexbert_csv(str(tmp_path / "chex.csv"))
    pc = pd.load_chexbert_csv(str(tmp_path / "chex.csv"))
    assert jc.keys() == pc.keys() and all(
        np.array_equal(jc[k], pc[k]) for k in jc)
    jg = jd.group_study_two_views(ja["train"], np.random.default_rng(1))
    pg = pd.group_study_two_views(pa["train"], np.random.default_rng(1))
    assert [s.image_paths for s in pg] == [s.image_paths for s in jg]

    reports = [s.report for s in pa["train"]]
    jtok = JaxTokenizer.from_corpus(reports, min_freq=1)
    ptok = WordTokenizer.from_corpus(reports, min_freq=1)
    assert ptok.itos == jtok.itos
    ptok.save(str(tmp_path / "vocab.json"))
    assert JaxTokenizer.load(str(tmp_path / "vocab.json")).itos == jtok.itos

    for jload, pload in (
        (jd.disk_image_loader(str(tmp_path), 32),
         pd.disk_image_loader(str(tmp_path), 32)),
        (jd.synthetic_image_loader(16, 2), pd.synthetic_image_loader(16, 2)),
    ):
        jb = jd.MRGBatcher(jg, jtok, jload, 2, max_len=8, num_workers=1,
                           regroup_views=True)
        pb = pd.MRGBatcher(pg, ptok, pload, 2, max_len=8, num_workers=1,
                           regroup_views=True)
        for want, got in zip(jb.batches(epoch=1, drop_last=False),
                             pd.prefetch(pb.batches(epoch=1,
                                                    drop_last=False))):
            assert want.keys() == got.keys()
            for k in want:
                if isinstance(want[k], np.ndarray):
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                else:
                    assert got[k] == want[k], k


def test_clip_decay_and_ema_match_jax():
    """A small least-squares problem where the clip triggers, with one
    decayed and one undecayed tensor, accumulation 2 and EMA 0.9, through
    ``make_train_step`` on both sides."""
    rng = np.random.default_rng(5)
    w0, b0 = _rand(rng, 3, 4), _rand(rng, 4)
    x, y = _rand(rng, 4, 3, scale=2.0), _rand(rng, 4, 4)
    lr, decay = 0.1, 0.9

    def jloss(p, b, _rng):
        return jnp.sum((b["x"] @ p["w/kernel"] + p["w/bias"] - b["y"]) ** 2)

    jp = {"w/kernel": jnp.asarray(w0), "w/bias": jnp.asarray(b0)}
    jtx = jax_optim.make_adamw(jax_optim.warmup_cosine(lr, 1, 4),
                               weight_decay=0.05, grad_clip=0.1,
                               params_for_mask=jp)
    jstate = jax_ts.TrainState.create(jp, jtx, ema=True)
    jstep = jax_ts.make_train_step(jloss, jtx, accum_steps=2, donate=False,
                                   ema_decay=decay)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    pp = {"w/kernel": torch.tensor(w0, requires_grad=True),
          "w/bias": torch.tensor(b0, requires_grad=True)}
    ptx = optim.make_adamw(pp, optim.warmup_cosine(lr, 1, 4),
                           weight_decay=0.05, grad_clip=0.1)
    pstate = train_state.TrainState(pp, ptx, ema=True)
    pstep = train_state.make_train_step(
        lambda b: torch.sum((b["x"] @ pp["w/kernel"] + pp["w/bias"]
                             - b["y"]) ** 2), 2, ema_decay=decay)
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    for _ in range(4):
        jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(0))
        pm = pstep(pstate, tb)
        assert float(jm["grad_norm"]) > 0.1  # the clip acts
        # fp32 on both sides: last-bit differences of the gradients, which
        # Adam's division by their own RMS carries into the next steps
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    for n in pp:  # as above: 1e-4 of lr
        np.testing.assert_allclose(pp[n].detach().numpy(),
                                   np.asarray(jstate.params[n]), rtol=0,
                                   atol=1e-4 * lr, err_msg=n)
        np.testing.assert_allclose(pstate.ema_params[n].numpy(),
                                   np.asarray(jstate.ema_params[n]),
                                   rtol=0, atol=1e-4 * lr, err_msg=n)


# --------------------------------------------------------------------------
# (c) metrics
# --------------------------------------------------------------------------

GTS = {
    "1": ["the lungs are clear . no pleural effusion or pneumothorax ."],
    "2": ["mild cardiomegaly is present . there is a small left pleural "
          "effusion ."],
    "3": ["no acute cardiopulmonary abnormality . degenerative changes of "
          "the spine ."],
}
RES = {
    "1": ["the lungs are clear . no pneumothorax ."],
    "2": ["heart size is normal . small left effusion is present ."],
    "3": ["no acute cardiopulmonary process . the spine is unremarkable ."],
}


def test_metrics_equal_jax():
    assert compute_nlg_scores(GTS, RES) == jax_nlg.compute_nlg_scores(
        GTS, RES)
    assert clinical_efficacy(GTS, RES) == jax_chexbert.clinical_efficacy(
        GTS, RES)


# --------------------------------------------------------------------------
# (d) the whole loop
# --------------------------------------------------------------------------


def _fit_cfg(save_dir, epochs=1):
    return make_config({
        "data": {"dataset": "synthetic", "batch_size": 4, "input_size": 32,
                 "max_len": 16, "vocab_min_freq": 1, "num_workers": 2},
        "model": {
            "task": "r2gengpt", "vision": "arm",
            "vision_kwargs": dict(patch_size=8, embed_dim=16, depth=1,
                                  d_state=4, drop_path_rate=0.0),
            "llm_kwargs": dict(dim=32, n_layers=1, n_heads=4, n_kv_heads=4,
                               hidden_dim=64),
        },
        "train": {"epochs": epochs, "lr": 1e-3, "warmup_steps": 2,
                  "log_every": 100, "save_dir": str(save_dir),
                  "lora_llm": True, "lora_rank": 2, "accum_steps": 2,
                  "remat": True},
        "generate": {"num_beams": 1, "max_new_tokens": 4,
                     "min_new_tokens": 1, "max_cache_len": 64},
    })


def test_fit_scores_and_files(tmp_path):
    """Then ``cli.train --validate`` resumes the saved state and scores
    the val split again: the same weights give the same reports."""
    from medical_image_analysis_tpu_torch.cli import train as cli_train
    from medical_image_analysis_tpu_torch.configs.config import save_config

    cfg = _fit_cfg(tmp_path)
    scores = loop.fit(cfg, "cpu")
    jax_keys = set(jax_nlg.compute_nlg_scores(GTS, RES)) | set(
        jax_chexbert.clinical_efficacy(GTS, RES)) | {"val_score"}
    assert set(scores) == jax_keys
    assert all(np.isfinite(v) for v in scores.values())
    files = os.listdir(tmp_path)
    assert any(f.startswith("checkpoint_epoch0_") for f in files)
    assert "checkpoint_best.pt" in files
    with open(tmp_path / "best.json") as f:
        assert json.load(f)["val_score"] == scores["val_score"]
    with open(tmp_path / "log.txt") as f:
        steps = [r for r in map(json.loads, f) if "step" in r]
    assert len(steps) == 8 and all(np.isfinite(r["loss"]) for r in steps)

    save_config(cfg, str(tmp_path / "run.yaml"))
    again = cli_train.main(["--config", str(tmp_path / "run.yaml"),
                            "--validate", "--device", "cpu"])
    assert again == {k: v for k, v in scores.items() if k != "val_score"}
    assert (tmp_path / "result_val.json").exists()


def test_kill_and_resume_reproduces_run(tmp_path):
    """3 epochs straight vs 2 epochs + auto-resume for the 3rd: the same
    final train state (the batches of an epoch depend on (seed, epoch))."""
    loop.fit(_fit_cfg(tmp_path / "a", 3), "cpu")
    kill = _fit_cfg(tmp_path / "b", 3)
    kill.train.max_epochs_this_run = 2
    loop.fit(kill, "cpu")
    resume = _fit_cfg(tmp_path / "b", 3)
    resume.train.resume = "auto"
    loop.fit(resume, "cpu")

    def final(d):
        obj = torch.load(d / "state_epoch00002.pt", weights_only=True)
        return obj["epoch"], obj["state"]

    (ea, a), (eb, b) = final(tmp_path / "a"), final(tmp_path / "b")
    assert ea == eb == 2 and a["step"] == b["step"] == 24
    for part in ("params", "frozen"):
        assert a[part].keys() == b[part].keys()
        for n in a[part]:
            torch.testing.assert_close(a[part][n], b[part][n], rtol=2e-5,
                                       atol=2e-6, msg=n)
    for n in a["opt"]["mu"]:
        torch.testing.assert_close(a["opt"]["mu"][n], b["opt"]["mu"][n],
                                   rtol=2e-5, atol=2e-6, msg=n)
