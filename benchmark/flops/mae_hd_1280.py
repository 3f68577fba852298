"""Model FLOPs of one MAE pretraining step, counted from the shapes.

Matrix products only (a multiply-add is two): the forward; the
activation gradients wherever something trainable lies upstream (all of
MAE but the pixels, so every product but the patch embedding's); the
weight gradients of every tensor (all train). Attention's two products
count in full at every position. Recomputation is not counted. Every
product of this configuration computes in fp32.
"""

from __future__ import annotations

import math


def vit_layer(tokens: int, seq: int, dim: int, hidden: int) -> float:
    """Forward products of one pre-LN block over ``tokens`` rows in
    sequences of ``seq``: qkv, out-projection, the MLP, then q.k and p.v."""
    return 2.0 * tokens * dim * (4 * dim + 2 * hidden) + 4.0 * tokens * seq * dim


def kept(l: int, ratio_outer: float, ratio_inner: float) -> int:
    """Patches region masking keeps of an l-patch grid."""
    s = math.isqrt(l)
    inner = ((int(s * 0.75) + 1) - (int(s * 0.25) + 1)) * (
        (int(s * 0.75) + 1) - (int(s * 0.125) + 1))
    return (int((l - inner) * (1 - ratio_outer))
            + int(inner * (1 - ratio_inner)))


def step_parts(cfg: dict, wl: dict) -> list[tuple[str, float, str]]:
    m = cfg["model"]
    b = wl["traffic"]["batch"]
    p, c = m["patch_size"], m["in_chans"]
    l = (m["image_size"] // p) ** 2
    d, dd = m["embed_dim"], m["decoder_embed_dim"]
    enc_seq = 1 + kept(l, m["mask_ratio"], m["mask_ratio_inner"])
    dec_seq = 1 + l
    enc = m["depth"] * vit_layer(b * enc_seq, enc_seq, d,
                                 int(d * m["mlp_ratio"]))
    dec = m["decoder_depth"] * vit_layer(b * dec_seq, dec_seq, dd,
                                         int(dd * m["mlp_ratio"]))
    patch = 2.0 * b * l * (p * p * c) * d
    embed = 2.0 * b * enc_seq * d * dd
    pred = 2.0 * b * dec_seq * dd * (p * p * c)
    fwd = enc + dec + patch + embed + pred
    # backward: weight gradients of every product, activation gradients of
    # every product but the patch embedding's
    bwd = 2.0 * fwd - patch
    return [("forward", fwd, "fp32"), ("backward", bwd, "fp32")]


def vit_block_calls(cfg: dict, wl: dict) -> list[tuple[str, int, dict]]:
    """The ViT block sub-layer calls of one step: (kind, calls a step,
    shape), the encoder's and the decoder's, forward and backward (no
    recomputation: each sub-layer runs once each way a micro-batch)."""
    m = cfg["model"]
    accum = cfg["train"]["accum_steps"]
    mb = wl["traffic"]["batch"] // accum
    l = (m["image_size"] // m["patch_size"]) ** 2
    shapes = [
        (m["depth"], dict(bsz=mb, seq=1 + kept(l, m["mask_ratio"],
                                               m["mask_ratio_inner"]),
                          d=m["embed_dim"], heads=m["num_heads"],
                          hidden=int(m["embed_dim"] * m["mlp_ratio"]))),
        (m["decoder_depth"], dict(bsz=mb, seq=1 + l,
                                  d=m["decoder_embed_dim"],
                                  heads=m["decoder_num_heads"],
                                  hidden=int(m["decoder_embed_dim"]
                                             * m["mlp_ratio"]))),
    ]
    return [(kind, n * accum, shape)
            for kind in ("attn_fwd", "mlp_fwd", "attn_bwd", "mlp_bwd")
            for n, shape in shapes]
