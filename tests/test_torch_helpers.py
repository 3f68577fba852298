"""The port's last helpers against the JAX package's, on the CPU.

- ``data/packed.py``: ``pack_images`` writes the JAX writer's bytes (index
  and shards, PNG and DICOM items), each package reads the other's shards,
  and ``packed_image_loader`` returns the JAX loader's arrays;
- ``HFTokenizer.train_bpe``: the vocabulary and merges of ``tokenizers``'
  trainer (the JAX ``train_bpe``) on the synthetic reports and on a corpus
  of their words in random orders, at vocabulary 300 and 1000; the saved
  file reads to the same ids in ``tokenizers`` and the port;
- ``make_lars`` and ``make_adamw(layer_decay=)``: 5 steps against optax
  (JAX's ``make_lars`` and ``make_adamw``) within 1e-6 of each tensor's
  largest value (fp32 elementwise arithmetic, the norms summed in another
  order);
- ``zip_image_loader``: the JAX loader's arrays from one archive (bit for
  bit: the same decode and normalisation in numpy);
- ``cross_scan_1d`` / ``cross_merge_1d``: JAX's, exactly (layout only).
"""

import io
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicom_files import make_dicom
from medical_image_analysis_tpu.data import datasets as jax_ds
from medical_image_analysis_tpu.data import packed as jax_packed
from medical_image_analysis_tpu.ops import cross_scan as jax_cs
from medical_image_analysis_tpu.train import optim as jax_optim
from medical_image_analysis_tpu_torch.data import datasets as port_ds
from medical_image_analysis_tpu_torch.data import packed as port_packed
from medical_image_analysis_tpu_torch.data.hf_tokenizer import HFTokenizer
from medical_image_analysis_tpu_torch.ops import cross_scan as port_cs
from medical_image_analysis_tpu_torch.train import optim


def _png(rng, h, w) -> bytes:
    import PIL.Image

    buf = io.BytesIO()
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    PIL.Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _items(rng):
    pix = (rng.random((40, 48)) * 4000).astype(np.uint16)
    return [("a.png", _png(rng, 50, 70)), ("b.png", _png(rng, 32, 32)),
            ("c.dcm", make_dicom(pix)), ("d.png", _png(rng, 90, 40)),
            ("e.png", _png(rng, 64, 64))]


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_pack_images_writes_the_jax_bytes_and_both_read_both(tmp_path):
    items = _items(np.random.default_rng(0))
    port_packed.pack_images(items, str(tmp_path / "port"), 24,
                            shard_records=2)
    jax_packed.pack_images(items, str(tmp_path / "jax"), 24,
                           shard_records=2)
    port_files, jax_files = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert list(port_files) == list(jax_files) == [
        "index.json", "shard-00000.u8", "shard-00001.u8", "shard-00002.u8"]
    assert port_files == jax_files
    for reader in (port_packed.PackedDataset, jax_packed.PackedDataset):
        for d in ("port", "jax"):
            ds = reader(str(tmp_path / d))
            assert len(ds) == 5
            want = jax_packed.decode_any(items[2][1], 24)
            np.testing.assert_array_equal(ds.by_id("c.dcm"), want)
            np.testing.assert_array_equal(
                port_packed.PackedDataset(str(tmp_path / d)).batch([4, 0]),
                jax_packed.PackedDataset(str(tmp_path / d)).batch([4, 0]))
    sample = jax_ds.Sample(id="s", image_paths=["x/a.png", "c.dcm"],
                           report="r")
    np.testing.assert_array_equal(
        port_packed.packed_image_loader(str(tmp_path / "jax"), 24)(sample),
        jax_packed.packed_image_loader(str(tmp_path / "port"), 24)(sample))
    batches = list(port_packed.PackedDataset(str(tmp_path / "port"))
                   .iter_batches(2, shuffle=True, seed=3))
    want = list(jax_packed.PackedDataset(str(tmp_path / "port"))
                .iter_batches(2, shuffle=True, seed=3))
    assert len(batches) == len(want) == 2
    for a, b in zip(batches, want):
        np.testing.assert_array_equal(a, b)


def _reports():
    return [s.report for ann in (jax_ds.synthetic_annotations(),
                                 jax_ds.learnable_synthetic_annotations())
            for split in ("train", "val", "test") for s in ann[split]]


def _shuffled(reports):
    rng = np.random.default_rng(0)
    words = sorted({w for r in reports for w in r.split()})
    return [" ".join(rng.choice(words, 10)) + "." for _ in range(400)]


@pytest.mark.parametrize("vocab", [300, 1000])
@pytest.mark.parametrize("corpus", ["reports", "shuffled"])
def test_train_bpe_is_the_trainers(tmp_path, vocab, corpus):
    tokenizers = pytest.importorskip("tokenizers")
    from medical_image_analysis_tpu.data.hf_tokenizer import (
        HFTokenizer as JaxHF,
    )

    texts = _reports()
    if corpus == "shuffled":
        texts = _shuffled(texts)
    want_tok = JaxHF.train_bpe(texts, vocab)
    want_tok.save(str(tmp_path / "want.json"))
    import json

    want = json.load(open(tmp_path / "want.json", encoding="utf-8"))
    got = HFTokenizer.train_bpe(texts, vocab)
    assert got.spec["model"]["vocab"] == want["model"]["vocab"]
    assert got.spec["model"]["merges"] == want["model"]["merges"]
    assert {k: v for k, v in got.spec.items() if k != "model"} == {
        k: v for k, v in want.items() if k != "model"}
    got.save(str(tmp_path / "got.json"))
    theirs = tokenizers.Tokenizer.from_file(str(tmp_path / "got.json"))
    mine = HFTokenizer.load(str(tmp_path / "got.json"))
    assert mine.vocab_size == theirs.get_vocab_size() == want_tok.vocab_size
    for text in texts[:20] + ["No acute cardiopulmonary process, 12 mm."]:
        ids = theirs.encode(text, add_special_tokens=False).ids
        assert mine.encode(text) == ids
        assert mine.decode(ids) == want_tok.decode(ids)


NAMES = ["encoder/block0/attn/qkv/kernel", "encoder/block1/mlp/fc1/kernel",
         "encoder/block1/norm/scale", "head/kernel", "head/bias",
         "llm/layers_0/self_attn/q_proj/kernel", "llm/layers_1/mlp/bias",
         "pos_embed"]


def _tree(values):
    tree = {}
    for n, v in values.items():
        node = tree
        parts = n.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def _leaf(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return np.asarray(tree)


def _run_both(jax_tx, port_tx_of, steps=5, zero_grad_at=()):
    rng = np.random.default_rng(1)
    shapes = {n: (3, 4) if n.endswith("kernel") else (4,) for n in NAMES}
    p0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in shapes.items()}
    p0["head/bias"] = np.zeros(4, np.float32)  # a zero norm: trust ratio 1
    jp = _tree(p0)
    state = jax_tx.init(jp)
    tp = {n: torch.tensor(v) for n, v in p0.items()}
    ptx = port_tx_of(tp)
    for k in range(steps):
        g = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
        for n in zero_grad_at:
            g[n] = np.zeros_like(g[n])
        upd, state = jax_tx.update(_tree(g), state, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, upd)
        ptx.step({n: torch.from_numpy(v) for n, v in g.items()})
    for n in NAMES:
        want = _leaf(jp, n)
        err = np.abs(tp[n].numpy() - want).max()
        assert err <= 1e-6 * max(np.abs(want).max(), 1e-30), (n, err)


@pytest.mark.parametrize("momentum,wd", [(0.9, 0.0), (0.5, 1e-2)])
def test_make_lars_follows_optax(momentum, wd):
    sched = jax_optim.warmup_cosine(0.1, 2, 5)
    _run_both(jax_optim.make_lars(sched, weight_decay=wd, momentum=momentum),
              lambda p: optim.make_lars(p, optim.warmup_cosine(0.1, 2, 5),
                                        weight_decay=wd, momentum=momentum),
              zero_grad_at=("llm/layers_1/mlp/bias",))


def test_make_adamw_layer_decay_follows_optax():
    jax_p = _tree({n: np.zeros((3, 4) if n.endswith("kernel") else (4,),
                               np.float32) for n in NAMES})
    tx = jax_optim.make_adamw(jax_optim.warmup_cosine(1e-2, 1, 5),
                              params_for_mask=jax_p, layer_decay=(0.75, 2))
    scales = jax.tree_util.tree_leaves_with_path(
        jax_optim.layer_decay_scales(jax_p, 0.75, 2))
    want = {"/".join(str(k.key) for k in path): float(v)
            for path, v in scales}
    assert optim.layer_decay_scales(NAMES, 0.75, 2) == want
    assert len(set(want.values())) == 3
    _run_both(tx, lambda p: optim.make_adamw(
        p, optim.warmup_cosine(1e-2, 1, 5), layer_decay=(0.75, 2)))


def test_zip_image_loader_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "images.zip")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("p/a.png", _png(rng, 40, 50))
        zf.writestr("p/b.png", _png(rng, 30, 30))
    sample = jax_ds.Sample(id="s", image_paths=["p/a.png", "p/b.png"],
                           report="r")
    mine = port_ds.zip_image_loader(path, 24)
    theirs = jax_ds.zip_image_loader(path, 24)
    got, want = mine(sample), theirs(sample)
    assert got.shape == (2, 24, 24, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    mine.close()
    theirs.close()


def test_cross_scan_1d_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 7, 5)).astype(np.float32)
    ys = port_cs.cross_scan_1d(torch.from_numpy(x))
    np.testing.assert_array_equal(ys.numpy(),
                                  np.asarray(jax_cs.cross_scan_1d(x)))
    np.testing.assert_array_equal(
        port_cs.cross_merge_1d(ys).numpy(),
        np.asarray(jax_cs.cross_merge_1d(jnp.asarray(ys.numpy()))))
