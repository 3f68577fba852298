"""The port's multi-process training and serving against the JAX package.

The JAX side runs on the 8-device virtual CPU mesh of ``tests/conftest.py``;
the port's runs are 2 or 4 processes on the CPU, joined by a gloo group
(``tests/torch_ranks.py``: every spawn binds a free port and every wait has
a timeout, so a dead rank fails its test). Tolerances:

- one sharded step against another (the port's over a grid against its
  one-process run, or against JAX's sharded step): the loss and the
  post-step parameter norm within 1e-5 relative (the bound of JAX's
  ``dryrun_multichip``), the grad norm within 1e-4 relative;
- every tensor of the port's sharded run within 1e-5 of its largest value
  of the one-process run's plus 5e-2 of the learning rate (fp32; the
  collectives only reorder sums, but Adam divides an element's gradient by
  its own running RMS, so a reordered sum moves an element whose gradient
  is near the others' rounding by a fraction of lr: ``tests/
  test_torch_train.py``'s bound for its steps against JAX, which the
  tensors here meet against JAX as well).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as tr
from medical_image_analysis_tpu.models import llm as jax_llm
from medical_image_analysis_tpu.models import mrg as jax_mrg
from medical_image_analysis_tpu.parallel import mesh as jax_mesh
from medical_image_analysis_tpu.parallel import tp as jax_tp
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu.train import train_state as jax_ts
from medical_image_analysis_tpu_torch.ckpt import hf_load
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    flax_named_parameters,
    to_port_layout,
)
from medical_image_analysis_tpu_torch.models import llm
from medical_image_analysis_tpu_torch.parallel import mesh as port_mesh
from medical_image_analysis_tpu_torch.parallel import tp as port_tp
from medical_image_analysis_tpu_torch.train import loop, train_state

PRESETS = os.path.join(os.path.dirname(__file__), "..",
                       "medical_image_analysis_tpu_torch", "configs",
                       "presets")
STEPS, ACCUM, LR = 2, 2, 1e-4


def fake_mesh(data, model, rank=0):
    """A grid without process groups, for what needs only its shape."""
    return port_mesh.Mesh(data, model, rank, groups=False)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if hasattr(v, "items") else {path: v})
    return out


def _spec(p):
    return tuple(p) if len(tuple(p)) else ()


def _port_named(flax_tree):
    """flax path -> numpy array in the port's layout."""
    return {n: to_port_layout(n.split("/"), torch.from_numpy(
        np.asarray(v, np.float32))).numpy()
        for n, v in _flat(flax_tree).items()}


# --------------------------------------------------------------------------
# (a) specs
# --------------------------------------------------------------------------


def test_zero_opt_specs_match_jax_on_the_conv_case():
    """JAX's ``tests/test_train_parallel.py`` case: the 16x16x3x32 patch
    embed shards its output channels, never a spatial axis; ties go to the
    last axis. The port reads its OIHW tensor in the flax layout."""
    mesh = jax_mesh.make_mesh(data=8, model=1)
    tree = {"conv/kernel": np.zeros((16, 16, 3, 32)),
            "emb/embedding": np.zeros((256, 64)),
            "small/kernel": np.zeros((8, 8))}
    want = jax_ts.zero_opt_specs({k: jnp.zeros(v.shape)
                                  for k, v in tree.items()}, mesh, min_size=1)
    port = {k: to_port_layout(k.split("/"), torch.zeros(v.shape))
            for k, v in tree.items()}
    got = train_state.zero_opt_specs(port, 8, min_size=1)
    assert got == {k: _spec(v) for k, v in want.items()}
    assert got["conv/kernel"] == (None, None, None, "data")
    plan = train_state.state_shardings(
        types.SimpleNamespace(params=port), fake_mesh(8, 1, 3),
        min_size=1)
    assert plan.zero["conv/kernel"] == (0, 3 * 4, 4)  # OIHW's O


def _dryrun_jax():
    c = dict(tr.DRYRUN_LLM)
    model = jax_mrg.R2GenGPT(
        llm_cfg=jax_llm.LLMConfig(**c, dtype=jnp.float32), chosen="arm",
        vision_kwargs=tr.DRYRUN_ARM)
    rng = np.random.default_rng(5)
    b = 8
    lens = [8, 3, 6, 1, 8, 5, 2, 7]  # ragged: data ranks hold other counts
    batch = dict(
        images=rng.standard_normal((b, 1, 32, 32, 3)).astype(np.float32),
        before_ids=rng.integers(3, 256, (b, 8)).astype(np.int32),
        after_ids=rng.integers(3, 256, (b, 4)).astype(np.int32),
        target_ids=rng.integers(3, 256, (b, 8)).astype(np.int32),
        target_mask=np.array([[1] * n + [0] * (8 - n) for n in lens],
                             np.int32))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 **{k: jnp.asarray(v)
                                    for k, v in batch.items()})
    return model, params, batch


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """The JAX sharded step of ``dryrun_multichip`` (data 2 x model 2, TP
    specs, ZeRO, accumulation 2, two steps) on ragged target masks; the
    port's the same on 4 gloo processes and in one process, each saving
    ``save_full`` after the first step; then the 4-process file restored
    onto a (1, 2) grid for the second step."""
    model, params, batch = _dryrun_jax()
    mesh = jax_mesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    specs = jax_tp.param_specs(params, mesh=mesh)
    tx = jax_optim.make_adamw(LR, params_for_mask=params)
    state = jax_ts.shard_state(jax_ts.TrainState.create(params, tx), mesh,
                               specs, zero_opt=True)
    step = jax_ts.make_train_step(
        lambda p, b, r: model.apply(p, **b), tx, mesh=mesh,
        param_specs=specs, accum_steps=ACCUM, zero_opt=True,
        state_for_shardings=state, donate=False)
    sb = jax_mesh.shard_batch(mesh, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    jax_metrics = []
    for _ in range(STEPS):
        state, m = step(state, sb, jax.random.PRNGKey(1))
        jax_metrics.append((float(m["loss"]), float(m["grad_norm"])))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    d = tmp_path_factory.mktemp("dryrun")
    one = tr.sharded_steps(0, 1, np_params, batch, (1, 1), STEPS, ACCUM,
                           save_path=str(d / "one.pt"))
    four = tr.spawn(tr.sharded_steps, 4, np_params, batch, (2, 2), STEPS,
                    ACCUM, 1 << 10, str(d / "four.pt"))
    resumed = tr.spawn(tr.sharded_steps, 2, np_params, batch, (1, 2), 1,
                       ACCUM, 1 << 10, None, 0, str(d / "four.pt"))
    return {"jax": jax_metrics,
            "jax_params": _port_named(state.params["params"]),
            "one": one, "four": four, "resumed": resumed, "dir": d}


def _norm(named):
    return float(np.sqrt(sum(np.sum(np.asarray(v, np.float64) ** 2)
                             for v in named.values())))


def test_sharded_step_losses_match_jax_and_one_process(dryrun):
    """Each step's loss and grad norm, on every rank; ``make_eval_step``'s
    loss of the global batch (before the steps) from each rank's rows."""
    one, four = dryrun["one"]["metrics"], dryrun["four"]
    assert all(r["metrics"] == four[0]["metrics"] for r in four)
    for r in four:
        np.testing.assert_allclose(r["eval_loss"], dryrun["one"]["eval_loss"],
                                   rtol=1e-6)
    for i, ((jl, jn), (ol, on), (fl, fn)) in enumerate(zip(
            dryrun["jax"], one, four[0]["metrics"])):
        np.testing.assert_allclose(fl, ol, rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(fl, jl, rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(fn, on, rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(fn, jn, rtol=1e-4, err_msg=f"step {i}")


def test_sharded_step_tensors_match_one_process_and_jax(dryrun):
    """Every tensor after two steps, and the parameter norm."""
    one = {k: v.numpy() for k, v in dryrun["one"]["state"].items()}
    four = dryrun["four"][0]["state"]
    jx = dryrun["jax_params"]
    assert one.keys() == four.keys() == jx.keys()
    np.testing.assert_allclose(_norm(four), _norm(one), rtol=1e-5)
    np.testing.assert_allclose(_norm(four), _norm(jx), rtol=1e-5)
    for n in one:
        bound = 1e-5 * np.abs(one[n]).max() + 5e-2 * LR
        assert np.abs(four[n] - one[n]).max() <= bound, n
        np.testing.assert_allclose(four[n], jx[n], rtol=0, atol=5e-2 * LR,
                                   err_msg=n)


def test_sharded_step_cut_zero_and_collectives(dryrun):
    """The 4-process run cut the LLM, kept ZeRO slices of its moments and
    moved bytes through every kind of collective it uses."""
    four = dryrun["four"]
    assert all(r["zero_slices"] > 0 for r in four)
    assert all(r["traffic"]["all_reduce"] > 0 and r["traffic"]["all_gather"]
               > 0 for r in four)


def test_save_full_is_the_one_process_file_and_resumes_on_another_grid(
        dryrun):
    d = dryrun["dir"]
    one = torch.load(d / "one.pt", weights_only=True)["state"]
    four = torch.load(d / "four.pt", weights_only=True)["state"]
    assert one["step"] == four["step"] == 1
    for part in ("params", "frozen"):
        assert one[part].keys() == four[part].keys()
    for key in ("mu", "nu"):
        assert one["opt"][key].keys() == four["opt"][key].keys()
        for n, v in one["opt"][key].items():
            assert four["opt"][key][n].shape == v.shape, n
            torch.testing.assert_close(four["opt"][key][n], v, rtol=1e-4,
                                       atol=1e-9, msg=n)
    for n, v in one["params"].items():
        assert four["params"][n].shape == v.shape, n
        assert (four["params"][n] - v).abs().max() <= (
            1e-5 * v.abs().max() + 5e-2 * LR), n
    # the (2, 2) file restored onto (1, 2): the second step's loss
    resumed = dryrun["resumed"][0]["metrics"][0][0]
    np.testing.assert_allclose(resumed, dryrun["four"][0]["metrics"][1][0],
                               rtol=1e-5)


def test_param_specs_match_jax():
    """``LLM_TP_RULES`` on the dryrun model, in the port's layout and
    names, against JAX's specs on its tree; the leaf whose sharded axis
    does not divide (an odd vocabulary) stays replicated on both sides."""
    for vocab in (256, 255):
        c = dict(tr.DRYRUN_LLM, vocab_size=vocab)
        jm = jax_llm.TransformerLM(jax_llm.LLMConfig(**c))
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 4), jnp.int32))
        mesh = jax_mesh.make_mesh(data=4, model=2)
        want = {n: _spec(s) for n, s in _flat(jax_tp.param_specs(
            shapes["params"], mesh=mesh)).items()}
        port = flax_named_parameters(llm.TransformerLM(llm.LLMConfig(**c),
                                                       device="meta"))
        got = port_tp.param_specs(port, mesh=fake_mesh(4, 2))
        assert got == want
        assert (got["lm_head/kernel"] == ()) == (vocab % 2 == 1)
        local = port_tp.shard_params(fake_mesh(4, 2, 1), port, got)
        for n, t in port.items():
            cut = "model" in got[n]
            assert local[n].numel() * (2 if cut else 1) == t.numel(), n


# --------------------------------------------------------------------------
# (b) tensor parallelism: GQA, EMRRG's hybrid layers, beam search
# --------------------------------------------------------------------------


@pytest.mark.parametrize("task", ["r2gengpt", "emrrg"])
def test_tp_loss_grads_and_beam_tokens_match_one_process(task):
    """A (1, 2) grid against one process: the loss, every gradient
    (gathered) within 1e-5 of its largest, and the beam-3 tokens (the
    split ancestry cache holding each rank's heads)."""
    rng = np.random.default_rng(0)
    inputs = dict(
        images=rng.standard_normal((2, 1, 32, 32, 3)).astype(np.float32),
        before_ids=rng.integers(4, 64, (2, 5)),
        after_ids=rng.integers(4, 64, (2, 3)),
        target_ids=rng.integers(4, 64, (2, 6)),
        target_mask=np.array([[1] * 6, [1] * 3 + [0] * 3]))
    gen = dict(num_beams=3, max_new_tokens=6, min_new_tokens=2, eos_id=2)
    a = tr.tp_check(0, 1, task, inputs, gen)
    b = tr.spawn(tr.tp_check, 2, task, inputs, gen)
    assert b[0]["cut"] and np.array_equal(b[0]["tokens"], b[1]["tokens"])
    np.testing.assert_array_equal(b[0]["tokens"], a["tokens"].numpy())
    np.testing.assert_allclose(b[0]["loss"], a["loss"].numpy(), rtol=1e-6)
    for n, g in a["grads"].items():
        g = g.numpy()
        err = np.abs(b[0]["grads"][n] - g).max()
        assert err <= 1e-5 * max(np.abs(g).max(), 1e-30), (n, err)


# --------------------------------------------------------------------------
# (c) every recipe over 2 data ranks; fit_mrg over 2 model ranks
# --------------------------------------------------------------------------


def _p(name):
    return os.path.join(PRESETS, name)


COMMON = ["data.num_workers=0", "train.epochs=1", "train.warmup_steps=1",
          "train.log_every=100", "train.val_max_batches=1"]
ARM0 = "{patch_size: 16, embed_dim: 16, depth: 1, d_state: 4, " \
       "drop_path_rate: 0.0}"


def _recipes(root: str, mesh_sets=()):
    def r(name, preset, sets):
        return (name, preset, [*COMMON, *sets, f"train.save_dir={root}/{name}",
                               *mesh_sets])

    mrg = {"data": {"dataset": "synthetic", "batch_size": 8,
                    "input_size": 32, "max_len": 12, "vocab_min_freq": 1},
           "model": {"task": "r2gengpt", "vision": "arm",
                     "vision_kwargs": json.loads(
                         '{"patch_size": 16, "embed_dim": 16, "depth": 1, '
                         '"d_state": 4, "drop_path_rate": 0.0}'),
                     "llm_kwargs": dict(dim=32, n_layers=1, n_heads=4,
                                        n_kv_heads=2, hidden_dim=64,
                                        dtype="float32")},
           "train": {"lr": 1e-3, "lora_llm": True, "lora_rank": 2,
                     "accum_steps": 2, "ema_decay": 0.9},
           "generate": {"num_beams": 3, "max_new_tokens": 4,
                        "min_new_tokens": 1, "max_cache_len": 64}}
    return [
        r("mrg", mrg, []),
        r("r2gen", _p("r2gen_iu.yaml"), [
            "data.dataset=synthetic", "data.batch_size=16",
            "data.input_size=32", "data.max_len=12", "data.vocab_min_freq=1",
            "model.vision_kwargs={embed_dim: 32, depth: 1, num_heads: 2}",
            "model.task_kwargs={r2gen_kwargs: {d_model: 32, d_ff: 48, "
            "num_layers: 1, num_heads: 4, rm_num_slots: 3, rm_num_heads: 4}}",
            "train.lr=1e-3", "generate.max_new_tokens=4"]),
        r("mae", _p("mae_hd_1280.yaml"), [
            "data.dataset=synthetic", "data.input_size=32",
            "data.batch_size=16", "model.mask_type=region",
            "model.mask_ratio_inner=0.5",
            "model.vision_kwargs={embed_dim: 32, depth: 1, "
            "num_heads: 2, decoder_embed_dim: 16, decoder_depth: 1, "
            "decoder_num_heads: 2}", "train.lr=1e-3", "train.accum_steps=2"]),
        r("ar", _p("ar_pretrain.yaml"), [
            "data.dataset=synthetic", "data.batch_size=16",
            "data.input_size=32",
            "model.vision_kwargs={patch_size: 4, embed_dim: 16, depth: 2, "
            "dec_embed_dim: 16, d_state: 4, dec_heads: 2}",
            "train.blr=0.05"]),
        r("clip", _p("clip_align.yaml"), [
            "data.dataset=synthetic", "data.batch_size=16",
            "data.input_size=32", "data.max_len=12", "data.vocab_min_freq=1",
            f"model.vision_kwargs={ARM0}", "train.lr=1e-3"]),
        r("swinchex", _p("swinchex.yaml"), [
            "data.dataset=synthetic_learnable", "data.input_size=56",
            "data.batch_size=8", "data.synthetic_train_size=16",
            "model.vision_kwargs={embed_dim: 16, depths: [2, 2], "
            "num_heads: [2, 4], drop_path_rate: 0.0}", "train.lr=1e-3",
            "train.mixup=0.8", "train.ema_decay=0.9"]),
        r("lm_sft", _p("mamba_lm_sft.yaml"), [
            "data.dataset=synthetic", "data.batch_size=16",
            "data.input_size=8", "data.max_len=24", "data.vocab_min_freq=1",
            "model.lm_kwargs={d_model: 16, depth: 2, d_state: 4}",
            "train.lr=1e-3"]),
    ]


NAMES = [r[0] for r in _recipes("")]


@pytest.fixture(scope="module")
def recipe_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipes")
    one = tr.spawn(tr.fit_runs, 1, _recipes(f"{root}/one"))[0]
    two = tr.spawn(tr.fit_runs, 2, _recipes(
        f"{root}/two", ["train.mesh_data=2"]))[0]
    tp = tr.spawn(tr.fit_runs, 2, [_recipes(
        f"{root}/tp", ["train.mesh_model=2"])[0]])[0]
    return one, two, tp


def _compare_runs(a, b, name):
    lr = max(r["lr"] for r in a["records"] if "lr" in r)
    la = [r["loss"] for r in a["records"] if "step" in r]
    lb = [r["loss"] for r in b["records"] if "step" in r]
    assert len(la) == len(lb) > 0, name
    np.testing.assert_allclose(lb, la, rtol=1e-5, err_msg=name)
    assert a["scores"].keys() == b["scores"].keys()
    for k, v in a["scores"].items():
        np.testing.assert_allclose(b["scores"][k], v, rtol=1e-5,
                                   err_msg=f"{name} {k}")
    sa, sb = a["state"], b["state"]
    for part in ("params", "frozen", "ema"):
        if sa.get(part) is None:
            assert sb.get(part) is None
            continue
        assert sa[part].keys() == sb[part].keys(), (name, part)
        for n, v in sa[part].items():
            bound = 1e-5 * float(np.abs(v).max()) + 5e-2 * lr
            err = float(np.abs(sb[part][n] - v).max())
            assert err <= bound, (name, part, n, err)


@pytest.mark.parametrize("name", NAMES)
def test_recipe_over_two_data_ranks_matches_one_process(recipe_runs, name):
    """Losses, validation scores and every final tensor (parameters, frozen
    tensors, EMA) of each recipe at ``train.mesh_data=2`` (ZeRO on)
    against its one-process run: the masked means, CLIP's contrastive loss
    over the global batch, MAE's mask noise rows and the global batch's
    mixup are the one-process run's."""
    one, two, _ = recipe_runs
    _compare_runs(one[name], two[name], name)


def test_fit_mrg_over_two_model_ranks_matches_one_process(recipe_runs):
    """``fit_mrg`` with ``train.mesh_model=2``: the LoRA-merged q/v cut
    over the model axis, the adapters' partial gradients summed over the
    model group; losses, beam-3 scores and tensors as one process's."""
    one, _, tp = recipe_runs
    _compare_runs(one["mrg"], tp["mrg"], "mrg tp")


# --------------------------------------------------------------------------
# (d) the grid, the batch's rows, sliced checkpoint reads
# --------------------------------------------------------------------------


def test_mesh_for_clamps_as_jax_and_one_process_has_no_grid(capsys):
    assert port_mesh.init_distributed() is False
    assert loop._mesh_for(8, -1, 1) is None
    assert loop._mesh_for(8, 2, 3) is None  # one process: (1, 1)
    assert "does not divide 1 processes; using model=1" in capsys.readouterr(
    ).out


def test_shard_rows_cut_the_micro_batches_as_jax():
    """Each data rank's rows: its rows of every micro-batch of the global
    batch (JAX reshapes the global batch into micro-batches, then shards
    each over ``data``)."""
    x = np.arange(16)
    got = [port_mesh.shard_rows(x, fake_mesh(4, 1, r * 1), 2)
           for r in range(4)]
    micro = x.reshape(2, 8)
    for r, rows in enumerate(got):
        want = np.concatenate([micro[k, 2 * r : 2 * r + 2] for k in range(2)])
        np.testing.assert_array_equal(rows, want)
    assert port_mesh.shard_rows(x, None, 2) is x


def _write_safetensors(path, tensors: dict):
    head, off, blobs = {}, 0, []
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                                  else t.dtype).numpy().tobytes()
        head[name] = {"dtype": {torch.bfloat16: "BF16",
                                torch.float32: "F32"}[t.dtype],
                      "shape": list(t.shape),
                      "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(head).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h + b"".join(blobs))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_load_llm_params_slices_equal_the_full_load(tmp_path, int8):
    """``load_llm_params(mesh=)`` at model=2: each rank's tensors are its
    slices of the full load's (int8: ``kernel_q`` and ``scale`` of the
    rank's rows quantised alone), read with fewer bytes."""
    hc = {"architectures": ["Qwen2ForCausalLM"], "hidden_size": 32,
          "intermediate_size": 64, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "vocab_size": 96, "tie_word_embeddings": False}
    g = torch.Generator().manual_seed(0)
    tensors = {}
    d, h, v, kv = 32, 64, 96, 16
    tensors["model.embed_tokens.weight"] = torch.randn(v, d, generator=g)
    for i in range(2):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj.weight", (d, d)),
                            ("self_attn.q_proj.bias", (d,)),
                            ("self_attn.k_proj.weight", (kv, d)),
                            ("self_attn.k_proj.bias", (kv,)),
                            ("self_attn.v_proj.weight", (kv, d)),
                            ("self_attn.v_proj.bias", (kv,)),
                            ("self_attn.o_proj.weight", (d, d)),
                            ("mlp.gate_proj.weight", (h, d)),
                            ("mlp.up_proj.weight", (h, d)),
                            ("mlp.down_proj.weight", (d, h)),
                            ("input_layernorm.weight", (d,)),
                            ("post_attention_layernorm.weight", (d,))):
            tensors[p + name] = torch.randn(*shape, generator=g)
    tensors["model.norm.weight"] = torch.randn(d, generator=g)
    tensors["lm_head.weight"] = torch.randn(v, d, generator=g)
    _write_safetensors(tmp_path / "model.safetensors",
                       {k: t.bfloat16() for k, t in tensors.items()})
    (tmp_path / "config.json").write_text(json.dumps(hc))
    lcfg = hf_load.read_hf_config(str(tmp_path), dtype=torch.bfloat16,
                                  quant_int8=int8)

    full = llm.TransformerLM(lcfg)
    hf_load.load_llm_params(str(tmp_path), full)
    whole = {n: p.detach() for n, p in flax_named_parameters(full).items()}
    for rank in range(2):
        part = llm.TransformerLM(lcfg)
        hf_load.load_llm_params(str(tmp_path), part, mesh=fake_mesh(1, 2,
                                                                    rank))
        assert part.bytes_read < full.bytes_read
        got = flax_named_parameters(part)
        assert got.keys() == whole.keys()
        for n, w in whole.items():
            how = part.tp_cut.get(n)
            want = w if how is None else port_tp.tp_slice(
                w, how[0], 2, rank, how[1])
            assert torch.equal(got[n].detach(), want), n
        assert any("kernel" in n for n in part.tp_cut)
