"""HF checkpoints in the port against the JAX package on CPU: the
safetensors reader, ``load_llm_params`` in bf16 and int8, the LLM's
logits, and ``model.llm_weights_dir`` through the recipes.

A tiny Qwen2 (q/k/v biases, untied head, fp32, several shards with
``model.safetensors.index.json``) and a tiny Llama (bf16, tied
embeddings, one shard) are saved by ``save_pretrained`` once per module.

(a) The reader's tensors equal the ``safetensors`` package's bit for bit
    (bf16 stays bf16); ``read_hf_config`` equals JAX's.
(b) JAX ``load_llm_params`` and the port's loader give equal tensors and
    dtypes, in the model dtype and in int8 (``kernel_q`` and ``scale``
    bit-equal; ``_quantize`` bit-equal to JAX's numpy on a random
    matrix), and the key map covers what the JAX ``llama_hf_to_flax``
    maps, plus Qwen2's biases.
(c) The port's ``TransformerLM`` and the JAX one give the same logits in
    fp32 from the same files, int8 included (1e-5 relative to the largest
    logit); the JAX tree, int8 too, loads strictly into the port through
    ``ckpt.from_jax``; a chunked ``lm_head`` gives what one product gives.
(d) ``model.llm_weights_dir`` and ``data.tokenizer_dir`` through
    ``init_mrg_model``: the LLM equals the file; int8 with LoRA, int8 on
    emrrg and a tokenizer wider than the checkpoint are refused; EMRRG's
    graft keeps its hybrid-only tensors. ``fit_mrg`` on a tiny r2gengpt
    (LoRA, frozen LLM) leaves every frozen LLM tensor equal to the file.
(e) The config fields parse as in the JAX package.
"""

import dataclasses
import os

os.environ.setdefault("USE_TF", "0")  # transformers: no TensorFlow import

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.ckpt import hf_load as jax_hf
from medical_image_analysis_tpu.ckpt import torch_import as jax_import
from medical_image_analysis_tpu.configs import config as jax_config
from medical_image_analysis_tpu.models import llm as jax_llm
from medical_image_analysis_tpu_torch.ckpt import hf_load
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    flax_named_parameters,
    load_jax_params,
    to_port_layout,
)
from medical_image_analysis_tpu_torch.ckpt.safetensors import (
    SafetensorsIndex,
    shard_files,
)
from medical_image_analysis_tpu_torch.configs import config as port_config
from medical_image_analysis_tpu_torch.data.hf_tokenizer import HFTokenizer
from medical_image_analysis_tpu_torch.models import llm
from medical_image_analysis_tpu_torch.train import loop

transformers = pytest.importorskip("transformers")
st = pytest.importorskip("safetensors.torch")
pytest.importorskip("tokenizers")

RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _save(tmp, name, cls_name, cfg_kw, dtype, shard=None):
    cls = getattr(transformers, cls_name)
    cfg_cls = getattr(transformers, cls_name.replace("ForCausalLM",
                                                     "Config"))
    torch.manual_seed(0)
    model = cls(cfg_cls(**cfg_kw)).eval().to(dtype)
    d = tmp / name
    kw = {"max_shard_size": shard} if shard else {}
    model.save_pretrained(d, safe_serialization=True, **kw)
    return str(d)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hf")
    base = dict(vocab_size=300, hidden_size=64, intermediate_size=96,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128)
    qwen = _save(tmp, "qwen", "Qwen2ForCausalLM",
                 dict(base, tie_word_embeddings=False, rope_theta=1e6,
                      rms_norm_eps=1e-6), torch.float32, shard="60KB")
    llama = _save(tmp, "llama", "LlamaForCausalLM",
                  dict(base, tie_word_embeddings=True), torch.bfloat16)
    return {"qwen": qwen, "llama": llama}


def _jax_named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_jax_named(v, name))
        else:
            out[name] = v
    return out


_DT = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.int8): torch.int8}


def _port_lm(d, int8, dtype):
    cfg = hf_load.read_hf_config(d, dtype=dtype, quant_int8=int8)
    lm = llm.TransformerLM(cfg)
    hf_load.load_llm_params(d, lm)
    return lm


def _jax_params(d, int8, dtype):
    cfg = jax_hf.read_hf_config(d, dtype=dtype, quant_int8=int8)
    return cfg, jax_hf.load_llm_params(d, cfg, dtype=dtype, int8=int8)


def test_reader_and_config(ckpts):
    from safetensors import safe_open

    for d in ckpts.values():
        sd = SafetensorsIndex(d)
        for f in shard_files(d):
            with safe_open(f, framework="pt") as ref:
                for k in ref.keys():
                    want = ref.get_tensor(k)
                    got = sd[k]
                    assert got.dtype == want.dtype and torch.equal(got, want)
        got = hf_load.read_hf_config(d)
        want = jax_hf.read_hf_config(d)
        for f in dataclasses.fields(got):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
    # 12 tensors a layer (4 kernels, 3 biases, 3 MLP kernels, 2 norms)
    assert len(SafetensorsIndex(ckpts["qwen"])) == 2 * 12 + 3
    assert len(shard_files(ckpts["qwen"])) > 1
    assert os.path.exists(f"{ckpts['qwen']}/model.safetensors.index.json")


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", ["qwen", "llama"])
def test_loader_matches_jax(ckpts, name, int8):
    d = ckpts[name]
    _, want = _jax_params(d, int8, jnp.bfloat16)
    lm = _port_lm(d, int8, torch.bfloat16)
    got = flax_named_parameters(lm)
    want = _jax_named(want["params"])
    want = {(n[:-len("/kernel")] + "/kernel" if n.endswith("/kernel")
             else n): v for n, v in want.items()}
    assert set(got) == set(want)
    for n, v in want.items():
        t = torch.from_numpy(np.asarray(v, np.float32))
        t = to_port_layout(n.split("/"), t)
        assert got[n].dtype == _DT[jnp.dtype(v.dtype)], n
        assert torch.equal(got[n].float(), t), n


def test_quantize_bit_equal():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((48, 40)) * rng.uniform(0.01, 3, 40)).astype(
        np.float32)
    w[:, 3] = 0.0  # an all-zero column takes the 1e-8 floor
    want = jax_hf._quantize(w)
    got = hf_load._quantize(torch.from_numpy(w))
    assert np.array_equal(got["kernel_q"].numpy(), want["kernel_q"])
    assert np.array_equal(got["scale"].numpy(), want["scale"])


def test_key_map_matches_llama_hf_to_flax(ckpts):
    d = ckpts["qwen"]
    sd = SafetensorsIndex(d)
    np_sd = {k: sd[k].float().numpy() for k in sd}
    ref = _jax_named(jax_import.llama_hf_to_flax(np_sd, 2)["params"])
    cfg = hf_load.read_hf_config(d)
    km = hf_load.llm_key_map(cfg, sd)
    mapped = {(p + "/kernel" if kind == "kernel" else p)
              for p, (_, kind) in km.items()}
    biases = {p for p, (_, kind) in km.items() if kind == "bias"}
    assert mapped - biases == set(ref) and len(biases) == 6


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", ["qwen", "llama"])
def test_logits_match_jax(ckpts, name, int8):
    d = ckpts[name]
    cfg, params = _jax_params(d, int8, jnp.float32)
    ids = (np.arange(24, dtype=np.int32).reshape(2, 12) * 7 + 3) % 300
    want = np.asarray(jax.jit(
        lambda p, x: jax_llm.TransformerLM(cfg).apply(p, input_ids=x))(
            params, jnp.asarray(ids)))
    lm = _port_lm(d, int8, torch.float32)
    with torch.no_grad():
        got = lm(input_ids=torch.from_numpy(ids).long()).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= RTOL * scale
    # the JAX tree loads strictly into the port (kernel_q transposed,
    # scale as it is) and gives the loader's tensors
    other = llm.TransformerLM(lm.cfg)
    load_jax_params(other, params)
    mine = flax_named_parameters(lm)
    for n, p in flax_named_parameters(other).items():
        assert torch.equal(p, mine[n].to(p.dtype)), n


def test_chunked_head_matches_one_product(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    q = llm.QuantDense(24, 50, dtype=torch.float32)
    q.kernel_q.copy_(torch.randint(-127, 128, (50, 24), generator=gen))
    q.scale.copy_(torch.rand(50, generator=gen))
    x = torch.randn(3, 24, generator=gen)
    whole = x @ q.dequantized().T
    dense = llm.Dense(24, 50, bias=False, dtype=torch.float32)
    dense.weight.data = torch.randn(50, 24, generator=gen).bfloat16()
    dense_whole = x @ dense.weight.float().T
    monkeypatch.setattr(llm, "CHUNK_ELEMS", 24 * 7)  # 7 rows a piece
    assert llm.transient_bytes(50, 24, torch.float32) == 7 * 24 * 4
    torch.testing.assert_close(q(x), whole, rtol=1e-6, atol=0)
    torch.testing.assert_close(dense(x), dense_whole, rtol=1e-6, atol=0)


# (d) the recipes ----------------------------------------------------------

def _tok_dir(tmp, vocab):
    from medical_image_analysis_tpu.data.hf_tokenizer import HFTokenizer

    from medical_image_analysis_tpu_torch.data.datasets import (
        synthetic_annotations,
    )

    reports = [s.report for s in synthetic_annotations()["train"]]
    tok = HFTokenizer.train_bpe(reports * 2, vocab_size=vocab)
    d = tmp / f"tok{vocab}"
    d.mkdir()
    tok.save(str(d / "tokenizer.json"))
    return str(d)


def _cfg(d, tok, task="r2gengpt", **sets):
    items = {"data.dataset": "synthetic", "data.input_size": 32,
             "data.batch_size": 4, "data.max_len": 16,
             "model.task": task, "model.vision": "arm",
             "model.vision_kwargs": "{patch_size: 8, embed_dim: 16, depth: 1, "
                                    "d_state: 4}",
             "model.llm_weights_dir": d, "data.tokenizer_dir": tok,
             "train.epochs": 1, "train.log_every": 1,
             "generate.max_new_tokens": 4, "generate.min_new_tokens": 1,
             **sets}
    return port_config.make_config({}, [f"{k}={v}" for k, v in items.items()])


def _file_tensors(d, lm_names):
    cfg = hf_load.read_hf_config(d)
    sd = SafetensorsIndex(d)
    out = {}
    for path, (hf, kind) in hf_load.llm_key_map(cfg, sd).items():
        out[path + "/kernel" if kind == "kernel" else path] = sd[hf]
    assert set(out) <= set(lm_names)
    return out


def test_init_mrg_model_splices(ckpts, tmp_path):
    tok = _tok_dir(tmp_path, 200)
    d = ckpts["qwen"]
    cfg = _cfg(d, tok)
    ann, tk, _, _ = loop.build_data(cfg)
    assert isinstance(tk, HFTokenizer) and tk.vocab_size < 300
    model = loop.init_mrg_model(cfg, tk.vocab_size, {}, "cpu")
    named = flax_named_parameters(model.llm)
    assert model.llm_cfg.vocab_size == 300 and model.llm_cfg.attn_bias
    for n, t in _file_tensors(d, named).items():
        assert torch.equal(named[n].detach(), t.to(named[n].dtype)), n
    assert named["lm_head/kernel"].dtype == torch.bfloat16
    assert named["norm/scale"].dtype == torch.float32
    with pytest.raises(ValueError, match="lora_llm with model.llm_int8"):
        loop.init_mrg_model(_cfg(d, tok, **{"model.llm_int8": True,
                                            "train.lora_llm": True}),
                            tk.vocab_size, {}, "cpu")
    with pytest.raises(ValueError, match="unsupported for emrrg"):
        loop.init_mrg_model(_cfg(d, tok, task="emrrg",
                                 **{"model.llm_int8": True}),
                            tk.vocab_size, {}, "cpu")
    with pytest.raises(ValueError, match="exceeds the checkpoint"):
        loop.build_mrg_model(cfg, 301)
    q = loop.init_mrg_model(_cfg(d, tok, **{"model.llm_int8": True}),
                            tk.vocab_size, {}, "cpu")
    qn = flax_named_parameters(q.llm)
    assert qn["lm_head/kernel_q"].dtype == torch.int8
    assert qn["layers_0/self_attn/q_proj/bias"].dtype == torch.float32


def test_emrrg_graft_keeps_hybrid_tensors(ckpts, tmp_path):
    tok = _tok_dir(tmp_path, 200)
    d = ckpts["qwen"]
    cfg = _cfg(d, tok, task="emrrg",
               **{"model.task_kwargs": "{cross_every: 2}"})
    model = loop.build_mrg_model(cfg, 200).eval()
    from medical_image_analysis_tpu_torch.models.common import init_params

    init_params(model, torch.Generator().manual_seed(0))
    before = {n: p.detach().clone()
              for n, p in flax_named_parameters(model.llm).items()}
    written = set(loop.splice_llm_weights(model, cfg))
    named = flax_named_parameters(model.llm)
    hybrid = [n for n in named if "cross_attn" in n]
    assert hybrid and not written & set(hybrid)
    for n in hybrid:
        assert torch.equal(named[n], before[n])
    for n, t in _file_tensors(d, named).items():
        assert torch.equal(named[n].detach(), t.to(named[n].dtype)), n


def test_fit_mrg_keeps_the_file(ckpts, tmp_path):
    tok = _tok_dir(tmp_path, 200)
    d = ckpts["llama"]
    cfg = _cfg(d, tok, **{"train.lora_llm": True, "train.lora_rank": 2,
                          "train.save_dir": str(tmp_path / "run"),
                          "train.val_max_batches": 1})
    seen = {}

    def on_start(model, state):
        seen["model"] = model
        seen["start"] = {n: p.detach().clone()
                         for n, p in state.params.items()}
        seen["state"] = state

    loop.fit_mrg(cfg, device="cpu", on_start=on_start)
    named = flax_named_parameters(seen["model"].llm)
    for n, t in _file_tensors(d, named).items():
        assert torch.equal(named[n].detach(), t.to(named[n].dtype)), n
    state = seen["state"]
    moved = [n for n, p in state.params.items()
             if not torch.equal(p, seen["start"][n])]
    assert any(n.startswith("lora/") for n in moved)
    assert any(n.startswith("base/vision/") for n in moved)


def test_config_fields_parse_as_jax():
    sets = ["data.tokenizer_dir=/x/tok", "model.llm_weights_dir=/x/llm",
            "model.llm_int8=true", "train.init_delta=/x/d.msgpack"]
    got = port_config.make_config({}, sets)
    want = jax_config.make_config({}, sets)
    for sect, key in (("data", "tokenizer_dir"), ("model", "llm_weights_dir"),
                      ("model", "llm_int8"), ("train", "init_delta")):
        assert getattr(getattr(got, sect), key) == \
            getattr(getattr(want, sect), key)
    assert got.model.llm_int8 is True
