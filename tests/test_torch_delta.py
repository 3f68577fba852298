"""The JAX package's msgpack deltas in the port, on CPU.

(a) The port's msgpack decoder against ``flax.serialization
    .msgpack_restore`` on a tree of every type ``msgpack_serialize``
    writes: ints of each width, floats, str, bytes, None, booleans, lists,
    numpy scalars (ext 3), arrays of each dtype including bfloat16 (ext 1)
    and flax's chunked arrays (its chunk size made small); exact.
(b) A tiny ``r2gengpt`` delta with LoRA on the LLM's q/v and a trainable
    tower, written by JAX ``save_delta`` in fp32 and in bf16: the port's
    ``load_delta`` and ``merge_delta`` over the run's tensors
    (``mrg_trainables``) give every JAX leaf bit for bit in the port's
    layout; the frozen leaves (empty arrays) are skipped; ``train.
    init_delta`` merges the same file into an eval-only state.
(c) The demo with ``--delta`` (the JAX file, no LoRA: the tower and the
    projector) over an HF checkpoint and an HF tokenizer: the report ids
    and text equal the JAX demo pipeline's (fp32 LLM, beam 3).
(d) ``cli.mac_refine`` with a JAX ``mac_rrg`` delta (LoRA, the tower,
    the heads): every merged tensor equals the file's, bit for bit.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from medical_image_analysis_tpu.ckpt import checkpoint as jax_ckpt
from medical_image_analysis_tpu.ckpt import hf_load as jax_hf
from medical_image_analysis_tpu.cli import demo as jax_demo
from medical_image_analysis_tpu.configs import config as jax_config
from medical_image_analysis_tpu.data.hf_tokenizer import (
    HFTokenizer as JaxHFTokenizer,
)
from medical_image_analysis_tpu.models import mrg as jax_mrg
from medical_image_analysis_tpu.peft import lora as jax_lora
from medical_image_analysis_tpu.train import loop as jax_loop
from medical_image_analysis_tpu_torch.ckpt import checkpoint
from medical_image_analysis_tpu_torch.ckpt.from_jax import to_port_layout
from medical_image_analysis_tpu_torch.ckpt.msgpack import msgpack_restore
from medical_image_analysis_tpu_torch.cli import demo, mac_refine
from medical_image_analysis_tpu_torch.configs.config import make_config
from medical_image_analysis_tpu_torch.data.datasets import (
    synthetic_annotations,
)
from medical_image_analysis_tpu_torch.train import loop
from medical_image_analysis_tpu_torch.train.train_state import TrainState

st = pytest.importorskip("safetensors.torch")
pytest.importorskip("tokenizers")

ROOT = Path(__file__).resolve().parents[1]
LLM_KW = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=64)
ARM = "{patch_size: 8, embed_dim: 16, depth: 1, d_state: 4}"
RANK = 2


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return t


def _same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert isinstance(got, torch.Tensor)
        assert tuple(got.shape) == np.shape(want)
        assert np.array_equal(_to_np(got), np.asarray(want, np.float32)
                              if want.dtype == jnp.bfloat16 else want)
        assert str(got.dtype).endswith(str(np.asarray(want).dtype))
    else:
        assert got == want and type(got) is type(want)


def test_msgpack_matches_flax(monkeypatch):
    rng = np.random.default_rng(0)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32,
                 -33, -129, -32769, -2**31 - 1, 2**63 - 1],
        "floats": [0.5, -1e300, float("inf")], "s": "é" * 40, "b": b"\x00ab",
        "none": None, "t": True, "f": False,
        "scalars": [np.float32(1.5), np.int64(-7), np.int32(3)],
        "arrays": {n: rng.standard_normal((3, 5)).astype(n) for n in (
            "float32", "float16", "float64", "int8", "int64", "uint8")},
        "bf16": jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16),
        "empty": np.zeros(0, np.float32),
        "big": rng.standard_normal((7, 9)).astype(np.float32),
        "nested": {f"k{i}": {"v": np.arange(i + 1)} for i in range(20)},
    }
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    want = serialization.msgpack_restore(blob)
    _same(msgpack_restore(blob), want)
    assert msgpack_restore(blob)["bf16"].dtype == torch.bfloat16


# shared set-up: an HF checkpoint, an HF tokenizer, a config ---------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("delta")
    reports = [s.report for s in synthetic_annotations()["train"]]
    tok = JaxHFTokenizer.train_bpe(reports * 2, vocab_size=300)
    tok_dir = tmp / "tok"
    tok_dir.mkdir()
    tok.save(str(tok_dir / "tokenizer.json"))
    # a tiny Qwen2 checkpoint in HF's names, bf16
    d, hd, v = LLM_KW["dim"], LLM_KW["hidden_dim"], 320
    kv = d // LLM_KW["n_heads"] * LLM_KW["n_kv_heads"]
    gen = torch.Generator().manual_seed(0)

    def w(*shape):
        return (torch.randn(*shape, generator=gen) * 0.2).bfloat16()

    sd = {"model.embed_tokens.weight": w(v, d), "model.norm.weight": 1 + w(d),
          "lm_head.weight": w(v, d)}
    for i in range(LLM_KW["n_layers"]):
        p = f"model.layers.{i}."
        for n, shape in (("q_proj", (d, d)), ("k_proj", (kv, d)),
                         ("v_proj", (kv, d)), ("o_proj", (d, d))):
            sd[f"{p}self_attn.{n}.weight"] = w(*shape)
            if n != "o_proj":
                sd[f"{p}self_attn.{n}.bias"] = w(shape[0])
        for n, shape in (("gate_proj", (hd, d)), ("up_proj", (hd, d)),
                         ("down_proj", (d, hd))):
            sd[f"{p}mlp.{n}.weight"] = w(*shape)
        sd[f"{p}input_layernorm.weight"] = 1 + w(d)
        sd[f"{p}post_attention_layernorm.weight"] = 1 + w(d)
    llm_dir = tmp / "llm"
    llm_dir.mkdir()
    st.save_file(sd, str(llm_dir / "model.safetensors"))
    (llm_dir / "config.json").write_text(json.dumps({
        "architectures": ["Qwen2ForCausalLM"], "vocab_size": v,
        "hidden_size": d, "num_hidden_layers": LLM_KW["n_layers"],
        "num_attention_heads": LLM_KW["n_heads"],
        "num_key_value_heads": LLM_KW["n_kv_heads"],
        "intermediate_size": hd, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-6, "tie_word_embeddings": False}))
    return {"tmp": tmp, "tok": str(tok_dir), "llm": str(llm_dir)}


def _sets(files, *extra):
    return ["data.dataset=synthetic", "data.input_size=32",
            "data.batch_size=4", "data.max_len=16",
            "model.task=r2gengpt", "model.vision=arm",
            f"model.vision_kwargs={ARM}", f"model.llm_weights_dir={files['llm']}",
            f"data.tokenizer_dir={files['tok']}", "generate.max_new_tokens=5",
            "generate.min_new_tokens=2", *extra]


@pytest.fixture
def fp32_llm(monkeypatch):
    """Both packages build the checkpoint's LLM in fp32."""
    jax_read, port_read = jax_hf.read_hf_config, loop.read_hf_config
    monkeypatch.setattr(jax_hf, "read_hf_config", lambda d, **kw: jax_read(
        d, **{**kw, "dtype": jnp.float32}))
    monkeypatch.setattr(loop, "read_hf_config", lambda d, **kw: port_read(
        d, **{**kw, "dtype": torch.float32}))


def _fill(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(leaf):
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim >= 2:
            v = v / np.sqrt(np.prod(leaf.shape[:-1]))
        return jnp.asarray(v * 0.5)
    return jax.tree_util.tree_map(fill, shapes)


def _jax_shapes(cfg, *extra):
    """The JAX model of ``cfg`` and its parameters' shapes, traced on
    dummy inputs (B=2: two views of 32^2, a prompt of 3 ids each side, 5
    target ids); ``extra`` are the arrays after the images."""
    model = jax_loop.build_mrg_model(cfg, 300)
    ids = jnp.ones((2, 3), jnp.int32)
    args = (jnp.zeros((2, 2, 32, 32, 3)), *extra, ids, ids,
            jnp.ones((2, 5), jnp.int32), jnp.ones((2, 5), jnp.int32))
    return model, jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                    *args))


def _lora(params, seed):
    """JAX ``init_lora``'s tree on the LLM's q/v (its keys and shapes),
    filled from ``seed`` with a nonzero B."""
    return _fill(jax.eval_shape(lambda: jax_lora.init_lora(
        jax.random.PRNGKey(0), params, jax_lora.llama_qv_rules(rank=RANK))),
        seed)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if hasattr(v, "items") else {name: v})
    return out


@pytest.mark.parametrize("bf16", [False, True])
def test_lora_delta_merges_bit_for_bit(files, bf16, fp32_llm):
    sets = _sets(files, "train.lora_llm=true", f"train.lora_rank={RANK}")
    jcfg = jax_config.make_config({}, sets)
    _, shapes = _jax_shapes(jcfg)
    params = _fill(shapes, 1)
    lora = _lora(params, 2)
    tree = {"base": params, "lora": lora}
    mask = {"base": jax_loop.trainable_mask(params, freeze_llm=True),
            "lora": jax.tree_util.tree_map(lambda _: True, lora)}
    if bf16:
        tree = jax.tree_util.tree_map(  # numpy's cast: nothing to compile
            lambda x: np.asarray(x).astype(jnp.bfloat16), tree)
    path = str(files["tmp"] / f"delta_{int(bf16)}.msgpack")
    jax_ckpt.save_delta(path, tree, mask, config={"task": "r2gengpt"},
                        epoch=3, step=12)

    delta, meta = checkpoint.load_delta(path)
    assert meta == {"config": {"task": "r2gengpt"}, "epoch": 3, "step": 12}
    kept = {n for n, t in delta.items() if t.numel()}
    assert any(n.startswith("lora/llm/layers_0/self_attn/q_proj/kernel/")
               for n in kept)
    assert not any(n.startswith("base/llm/") for n in kept)
    if bf16:
        assert all(delta[n].dtype == torch.bfloat16 for n in kept)

    cfg = make_config({}, sets)
    model = loop.init_mrg_model(cfg, 300, {}, "cpu")
    named, mask_t = loop.mrg_trainables(cfg, model)
    frozen_llm = {n: p.detach().clone() for n, p in named.items()
                  if n.startswith("base/llm/")}
    checkpoint.merge_delta(named, delta)
    want = _flat(tree)
    for n in kept:
        jname = n.replace("base/", "base/params/", 1).replace(
            "lora/", "lora/params/", 1)
        ref = torch.from_numpy(np.asarray(want[jname], np.float32))
        ref = to_port_layout(n.split("/"), ref)
        assert torch.equal(named[n].detach().float(),
                           ref.to(named[n].dtype).float()), n
    for n, p in frozen_llm.items():
        assert torch.equal(named[n], p), n
    assert sum(mask_t.values()) == len(kept)

    # train.init_delta, as an eval-only run merges it
    trainable = {n: p for n, p in named.items() if mask_t[n]}
    with torch.no_grad():
        for p in trainable.values():
            p.zero_()
    state = TrainState(trainable, torch.optim.SGD(
        list(trainable.values()), lr=0.0), ema=False)
    cfg.train.init_delta = path
    loop._load_eval_only_weights(state, cfg.train)
    for n in kept:
        assert torch.equal(state.params[n].detach(), named[n].detach())
        assert state.params[n].abs().sum() > 0


def test_demo_delta_matches_jax_demo(files, fp32_llm, monkeypatch):
    sets = _sets(files)
    jcfg = jax_config.make_config({}, sets)
    _, shapes = _jax_shapes(jcfg)
    params = _fill(shapes, 5)
    path = str(files["tmp"] / "tower.msgpack")
    jax_ckpt.save_delta(path, params,
                        jax_loop.trainable_mask(params, freeze_llm=True),
                        config={"task": "r2gengpt"})
    cfg_path = files["tmp"] / "demo.yaml"
    raw = {}
    for item in sets:
        key, value = item.split("=", 1)
        sect, name = key.split(".")
        raw.setdefault(sect, {})[name] = yaml.safe_load(value)
    cfg_path.write_text(yaml.safe_dump(raw))

    seen = []
    decode = JaxHFTokenizer.decode
    monkeypatch.setattr(JaxHFTokenizer, "decode", lambda self, ids: (
        seen.append([int(i) for i in ids]), decode(self, ids))[1])

    class InitFromShapes:
        """The JAX demo's model, its ``init`` returning zeros of the
        traced shapes: every leaf is overwritten by the checkpoint's LLM
        and the delta (the rest), so no eager init is compiled."""

        generate = jax_mrg.R2GenGPT.generate

        def __init__(self, model):
            self._model = model

        def __getattr__(self, name):
            return getattr(self._model, name)

        def init(self, *args):
            return jax.tree_util.tree_map(
                lambda x: jnp.zeros(x.shape, x.dtype), shapes)

    build = jax_loop.build_mrg_model
    monkeypatch.setattr(jax_loop, "build_mrg_model",
                        lambda *a: InitFromShapes(build(*a)))
    ns = type("A", (), dict(config=str(cfg_path), vocab=None, delta=path,
                            image=None, serve=0, device="cpu", seed=0,
                            vocab_size=None))
    jax_report = jax_demo.build_pipeline(ns)
    pipe = demo.build_pipeline(ns)
    rng = np.random.default_rng(3)
    for _ in range(2):
        img = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
        want_text = jax_report(img)
        got = pipe(img)
        assert got["ids"] == seen[-1]
        assert got["report"] == want_text
    assert pipe.model.llm_cfg.vocab_size == 320


def test_mac_refine_takes_a_jax_delta(files, tmp_path, monkeypatch,
                                      fp32_llm):
    preset = "mac_rrg_mimic.yaml"
    side = {"dim": 12, "max_chunks": 4, "max_entities": 3}
    swin = {"embed_dim": 8, "depths": [1, 1], "num_heads": [2, 2],
            "window_size": 4}
    sets = ["data.dataset=synthetic", "data.input_size=32",
            "data.batch_size=5", "data.max_len=16",
            f"model.vision_kwargs={json.dumps(swin)}",
            f"model.side_inputs={json.dumps(side)}",
            f"model.llm_weights_dir={files['llm']}",
            f"data.tokenizer_dir={files['tok']}", f"train.lora_rank={RANK}",
            "generate.num_beams=2", "generate.max_new_tokens=3",
            "generate.min_new_tokens=1", f"train.save_dir={tmp_path}"]
    jcfg = jax_config.load_config(
        str(ROOT / "medical_image_analysis_tpu/configs/presets" / preset),
        sets)
    _, shapes = _jax_shapes(jcfg, jnp.zeros((2, 4, 12)),
                            jnp.zeros((2, 3, 12)))
    params = _fill(shapes, 9)
    lora = _lora(params, 3)
    tree = {"base": params, "lora": lora}
    mask = {"base": jax_loop.trainable_mask(params, freeze_llm=True),
            "lora": jax.tree_util.tree_map(lambda _: True, lora)}
    path = str(tmp_path / "mac.msgpack")
    jax_ckpt.save_delta(path, tree, mask, config={"task": "mac_rrg"})
    want = {n: v for n, v in _flat(tree).items()
            if not n.startswith("base/params/llm/")}
    seen = {}

    def on_start(model, named, ctx):
        for jname, v in want.items():
            n = jname.replace("/params/", "/", 1)
            ref = to_port_layout(n.split("/"), torch.from_numpy(
                np.asarray(v, np.float32)))
            assert torch.equal(named[n].detach(), ref.to(named[n].dtype)), n
        seen["n"] = len(want)

    out = mac_refine.main([
        "--config", str(ROOT / "medical_image_analysis_tpu_torch/configs"
                        / "presets" / preset),
        *sum((["--set", s] for s in sets), []), "--delta", path,
        "--max-batches", "1", "--device", "cpu"], on_start=on_start)
    assert seen["n"] > 10 and len(out["reports"]) == 5
