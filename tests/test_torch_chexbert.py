"""The learned CheXbert labeler in the port, on CPU.

A CheXbert state dict in the released layout (``tests/ref_ckpt_files.py:
chexbert_sd``, ``module.``-prefixed, pooler included, a tiny BERT), saved as
the released ``.pth`` (``model_state_dict`` beside an epoch and an
optimizer) and read by ``load_torch_state_dict``:
``chexbert_torch_to_flax`` equals the JAX map leaf for leaf; the port's
``CheXbert`` loads it strictly and its 14 heads' logits equal the JAX
model's within 2e-5 of the largest (fp32); ``chexbert_labels`` equals JAX's;
the learned labeler labels each report as JAX's does and gives the same
``clinical_efficacy``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.data.tokenizer import (
    WordTokenizer as JaxWordTokenizer,
)
from medical_image_analysis_tpu.evalx import chexbert_model as jax_cm
from medical_image_analysis_tpu.models.bert import BertConfig as JaxBertConfig
from medical_image_analysis_tpu_torch.ckpt.from_jax import load_jax_params
from medical_image_analysis_tpu_torch.ckpt.torch_import import (
    load_torch_state_dict,
)
from medical_image_analysis_tpu_torch.data.tokenizer import WordTokenizer
from medical_image_analysis_tpu_torch.evalx import chexbert_model as cm
from medical_image_analysis_tpu_torch.evalx.chexbert import clinical_efficacy
from medical_image_analysis_tpu_torch.models.bert import BertConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
import ref_ckpt_files as ref  # noqa: E402

BERT = dict(vocab_size=40, dim=24, n_layers=2, n_heads=4, intermediate=40,
            max_position=32)
WORDS = ("no acute cardiopulmonary process heart size is enlarged small "
         "left pleural effusion right lung opacity mild edema pneumothorax "
         "support devices tube").split()
REPORTS = ["no acute cardiopulmonary process .",
           "heart size is enlarged . small left pleural effusion .",
           "right lung opacity and mild edema .",
           "no pneumothorax . support devices tube ."]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """The state dict as a released file holds it, read back."""
    sd = ref.chexbert_sd(np.random.default_rng(0), n_layers=2, dim=24,
                         intermediate=40, vocab=40, max_position=32)
    # larger heads, so that the argmax differs between reports
    for k in sd:
        if k.startswith("module.linear_heads."):
            sd[k] = sd[k] * 50
    path = tmp_path_factory.mktemp("chexbert") / "chexbert.pth"
    ref.save_pth(path, sd, wrap="model_state_dict")
    return load_torch_state_dict(str(path))


def test_map_and_logits_equal_jax(released):
    want = jax_cm.chexbert_torch_to_flax(released, n_layers=2)
    got = cm.chexbert_torch_to_flax(released, n_layers=2)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (p, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(p))
    model = load_jax_params(cm.CheXbert(BertConfig(**BERT)).eval(), got)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 40, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[2, 7:] = 0
    ref_logits = jax.jit(jax_cm.CheXbert(JaxBertConfig(**BERT)).apply)(
        want, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        logits = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert [tuple(lg.shape) for lg in logits] == [(3, 4)] * 13 + [(3, 2)]
    for lg, w in zip(logits, ref_logits):
        w = np.asarray(w)
        assert np.abs(lg.numpy() - w).max() <= 2e-5 * max(1.0,
                                                          np.abs(w).max())
    np.testing.assert_array_equal(
        cm.chexbert_labels(logits),
        jax_cm.chexbert_labels([np.asarray(w) for w in ref_logits]))


def test_labels_semantics_equal_jax():
    logits = [np.random.default_rng(i).standard_normal((5, 4))
              for i in range(13)]
    logits.append(np.random.default_rng(13).standard_normal((5, 2)))
    got = cm.chexbert_labels([torch.from_numpy(x) for x in logits])
    np.testing.assert_array_equal(got, jax_cm.chexbert_labels(logits))
    assert got.dtype == np.int32 and got.shape == (5, 14)


def test_learned_labeler_in_clinical_efficacy(released):
    tok = WordTokenizer(list(WORDS))
    model = load_jax_params(cm.CheXbert(BertConfig(**BERT)),
                            cm.chexbert_torch_to_flax(released, 2))
    labeler = cm.make_learned_labeler(model, tok, max_len=16)
    jax_labeler = jax_cm.make_learned_labeler(
        jax_cm.chexbert_torch_to_flax(released, 2),
        JaxWordTokenizer(list(WORDS)), max_len=16,
        cfg=JaxBertConfig(**BERT))
    labels = [labeler(r) for r in REPORTS]
    for r, lab in zip(REPORTS, labels):
        np.testing.assert_array_equal(lab, jax_labeler(r), err_msg=r)
    assert len({tuple(lab) for lab in labels}) > 1  # the heads discriminate
    gts = {str(i): [r] for i, r in enumerate(REPORTS)}
    res = {str(i): [REPORTS[(i + 1) % 4]] for i in range(4)}
    got = clinical_efficacy(gts, res, labeler=labeler)
    from medical_image_analysis_tpu.evalx.chexbert import (
        clinical_efficacy as jax_ce,
    )
    assert got == jax_ce(gts, res, labeler=jax_labeler)
