"""The learned CheXbert labeler: the trained clinical-efficacy model.

Counterpart of ``medical_image_analysis_tpu/evalx/chexbert_model.py``
(``CheXbert``, ``chexbert_torch_to_flax``, ``chexbert_labels``,
``make_learned_labeler``). stanfordmlgroup's CheXbert is BERT-base and 14
linear heads on the CLS state: 13 conditions of four classes (blank,
positive, negative, uncertain) and "No Finding" of two. ``compute_ce``
maps positive to 1 and the rest to 0 before the micro P/R/F1 of
``evalx/chexbert.py:clinical_efficacy``, which takes the labeler through
``labeler=``; the rule labeler stays its default.

Weights come from a CheXbert ``.pth`` (``ckpt/torch_import.py:
load_torch_state_dict``) through :func:`chexbert_torch_to_flax` and
``ckpt/from_jax.py:load_jax_params``. The released file's BERT carries HF's
tanh pooler, which the heads do not read; the model has it so that the file
loads strictly.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

from ..ckpt.torch_import import bert_hf_to_flax
from ..models.bert import BertConfig, BertModel
from .chexbert import CHEXPERT_LABELS

# CheXbert's head order (stanfordmlgroup/CheXbert src/constants.py)
CHEXBERT_CONDITIONS = list(CHEXPERT_LABELS)

CLS_BLANK, CLS_POSITIVE, CLS_NEGATIVE, CLS_UNCERTAIN = 0, 1, 2, 3


class CheXbert(nn.Module):
    """BERT and 14 heads (13 four-way, one two-way) on the CLS state;
    ``forward(input_ids, attention_mask)`` -> a list of 14 (B, 4 | 2)
    logits."""

    def __init__(self, cfg: BertConfig = BertConfig(), device=None):
        super().__init__()
        self.bert = BertModel(cfg, device, pooler=True)
        for i in range(14):
            self.add_module(f"head_{i}", nn.Linear(cfg.dim, 4 if i < 13 else 2,
                                                   device=device))

    def forward(self, input_ids, attention_mask) -> list[torch.Tensor]:
        cls = self.bert(input_ids=input_ids,
                        attention_mask=attention_mask)[:, 0]
        return [getattr(self, f"head_{i}")(cls) for i in range(14)]


def chexbert_torch_to_flax(sd: Mapping[str, np.ndarray],
                           n_layers: int = 12) -> dict:
    """A CheXbert ``.pth`` state dict (``module.``-prefixed, the ``bert.*``
    tower, ``linear_heads.{i}.*``) -> ``{"params": tree}`` of numpy
    arrays, equal to the JAX map's."""
    clean = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in sd.items()}
    bert_sd = {k[len("bert."):]: v for k, v in clean.items()
               if k.startswith("bert.")}
    params = {"bert": bert_hf_to_flax(bert_sd, n_layers)["params"]}
    for i in range(14):
        params[f"head_{i}"] = {
            "kernel": np.ascontiguousarray(
                np.asarray(clean[f"linear_heads.{i}.weight"]).T),
            "bias": np.asarray(clean[f"linear_heads.{i}.bias"]),
        }
    return {"params": params}


def chexbert_labels(logits: list) -> np.ndarray:
    """Each head's argmax -> (B, 14) int32 labels as ``compute_ce`` reads
    them: positive 1, blank, negative and uncertain 0; the No Finding head
    its class."""
    out = [np.argmax(np.asarray(lg), -1) == CLS_POSITIVE
           for lg in logits[:-1]]
    out.append(np.argmax(np.asarray(logits[-1]), -1) == 1)
    return np.stack(out, axis=1).astype(np.int32)


def make_learned_labeler(model: CheXbert, tokenizer, max_len: int = 128):
    """``labeler(report) -> (14,)`` for ``clinical_efficacy(labeler=)``: one
    report a call, tokenised by ``tokenizer`` (``encode``, ``pad``) to
    ``max_len`` and run through ``model`` on its device. Where the JAX
    function takes the parameters and a config, this takes the loaded
    module."""
    device = next(model.parameters()).device
    model.eval()

    def labeler(report: str) -> np.ndarray:
        ids, mask = tokenizer.pad(tokenizer.encode(report, max_len=max_len),
                                  max_len)
        with torch.no_grad():
            logits = model(torch.tensor([ids], device=device),
                           torch.tensor([mask], device=device))
        return chexbert_labels([lg.float().cpu() for lg in logits])[0]

    return labeler
