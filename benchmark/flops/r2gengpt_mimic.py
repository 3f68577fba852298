"""Model FLOPs of one R2GenGPT fine-tuning step, counted from the shapes.

A multiply-add is two. Counted: the forward; the activation gradients
wherever something trainable lies upstream (the adapters sit in every
LLM layer and the tower feeds the LLM, so every product but the tower's
patch embedding); the weight gradients of the trainable tensors only (the
tower, the projector, the adapters; not the frozen LLM). Recomputation
(remat of the tower's and the LLM's blocks) is not counted. Attention's
two products count in full at every position; the head counts at the
positions that predict a report token (the report's padded length). The selective scan's own
operations (the S6 update and readout 7N, the skip 2, the conv 2 a tap,
SiLU and softplus 4 each, a channel, direction and row) count on the
CUDA cores; everything else is a product. Precisions: the tower, the
projector and the head in fp32; the LLM's layers in bf16.
"""

from __future__ import annotations

import math


def _shape(cfg, wl):
    m = cfg["model"]
    t, llm = m["tower"], m["llm"]
    tr = wl["traffic"]
    b = tr["batch"]
    images = b * tr["images"]["views"]
    tokens = (m["image_size"] // t["patch_size"]) ** 2 + 1
    prompt = (len(tr["prompt"]["before"].split()) + 1
              + len(tr["prompt"]["after"].split()))
    seq = prompt + tokens + tr["report"]["max_len"]
    return m, t, llm, b, images, tokens, seq


def forward_parts(cfg: dict, wl: dict) -> dict[str, float]:
    """The forward's products a step, by part, and the scan's own
    operations (``scan``)."""
    m, t, llm, b, images, tokens, seq = _shape(cfg, wl)
    d, depth, n, p = t["embed_dim"], t["depth"], t["d_state"], t["patch_size"]
    di = d * t["expand"]
    rank = t["dt_rank"] or math.ceil(d / 16)
    k, taps = t["directions"], t["d_conv"]
    rows = images * tokens
    layer = 2.0 * rows * (d * 2 * di + di * d
                          + k * di * (rank + 2 * n) + k * rank * di)
    h, ff, vocab = (llm["hidden_size"], llm["intermediate_size"],
                    llm["vocab_size"])
    lora = m["lora"]
    per_tok = (2.0 * (4 * h * h + 3 * h * ff) + 4.0 * seq * h
               + 2.0 * len(lora["targets"]) * 2 * h * lora["rank"])
    return {
        "patch": 2.0 * images * (tokens - 1) * 3 * p * p * d,
        "tower": depth * layer,
        "scan": depth * images * k * tokens * di * (7 * n + 2 + 2 * taps + 8),
        "projector": 2.0 * b * tokens * d * h,
        "llm": llm["num_hidden_layers"] * b * seq * per_tok,
        "lora": (llm["num_hidden_layers"] * b * seq
                 * 2.0 * len(lora["targets"]) * 2 * h * lora["rank"]),
        # the head at the positions that predict a report token
        "head": 2.0 * b * wl["traffic"]["report"]["max_len"] * h * vocab,
    }


def step_parts(cfg: dict, wl: dict) -> list[tuple[str, float, str]]:
    f = forward_parts(cfg, wl)
    return [
        # weight and activation gradients of every tower product but the
        # patch embedding's activation gradient
        ("tower", 3.0 * (f["tower"] + f["patch"]) - f["patch"], "fp32"),
        # the forward and a backward of about twice its work
        ("scan", 3.0 * f["scan"], "fp32_cuda_core"),
        ("projector", 3.0 * f["projector"], "fp32"),
        # forward and activation gradients, and the adapters' weight
        # gradients
        ("llm", 2.0 * f["llm"] + f["lora"], "bf16"),
        ("head", 2.0 * f["head"], "fp32"),
    ]


def mamba_fused_calls(cfg: dict, wl: dict) -> list[tuple[str, int, dict]]:
    """The fused layer's wrapper calls of one step: each tower block's
    forward twice a micro-batch under remat (the forward and the backward's
    recomputation), its backward once."""
    m, t, llm, b, images, tokens, seq = _shape(cfg, wl)
    accum = cfg["train"]["accum_steps"]
    shape = dict(b=images // accum, k=t["directions"], l=tokens,
                 d=t["embed_dim"] * t["expand"], n=t["d_state"],
                 rank=t["dt_rank"] or math.ceil(t["embed_dim"] / 16),
                 taps=t["d_conv"])
    fwd = t["depth"] * accum * (2 if t["remat"] else 1)
    return [("xdbl", fwd, shape), ("scan", fwd, shape),
            ("scan_bwd", t["depth"] * accum, shape)]
