"""``roofline_pct.vit_block``: the ViT block sub-layers' share of their
roofline (``roofline.py``), in %.

The work of a call is a frozen copy of ``ops/vit_block.py:work`` of the
program: products and other operations counted from the shapes (a
backward that keeps only its inputs recomputes the forward's products
once; what the kernels compute beyond that is not counted). Bytes: the
sub-layer's input, weights and output once each (the backward: input,
weights and dy in, dx and the weight gradients out), fp32.
"""

from roofline import share

KERNELS = ("gemm_tc_kernel", "ln_stats_kernel", "ln_apply_kernel",
           "attn_tc_fwd_kernel", "attn_dkv_tc_kernel", "attn_dq_tc_kernel",
           "colsum_kernel", "ln_bwd_kernel")
COUNTER = {"attn_fwd": "vit_attn_fwd", "mlp_fwd": "vit_mlp_fwd",
           "attn_bwd": "vit_attn_bwd", "mlp_bwd": "vit_mlp_bwd"}


def work(kind, bsz, seq, d, heads, hidden):
    rows = bsz * seq
    scores = bsz * heads * seq * seq
    if kind == "attn_fwd":
        return 2 * rows * d * 4 * d + 4 * rows * seq * d, 4 * scores
    if kind == "mlp_fwd":
        return 4 * rows * d * hidden, 10 * rows * hidden
    if kind == "attn_bwd":
        return (2 * rows * d * (3 * d + d + d + 3 * d + 3 * d)
                + 2 * bsz * seq * seq * d * 6, 7 * scores)
    if kind == "mlp_bwd":
        return 2 * rows * d * hidden * 5, 20 * rows * hidden
    raise ValueError(kind)


def nbytes(kind, bsz, seq, d, heads, hidden, elt=4):
    act = bsz * seq * d
    if kind.startswith("attn"):
        weights = d * 3 * d + 3 * d + d * d + d + 2 * d
    else:
        weights = d * hidden + hidden + hidden * d + d + 2 * d
    if kind.endswith("fwd"):
        return elt * (2 * act + weights)
    return elt * (3 * act + 2 * weights)


def read(ctx):
    calls_of = getattr(ctx["flops"], "vit_block_calls", None)
    if calls_of is None:
        return None
    return share(ctx, calls_of(ctx["config"], ctx["workload"]), COUNTER,
                 KERNELS, work, nbytes)
