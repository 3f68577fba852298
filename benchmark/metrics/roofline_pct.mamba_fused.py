"""``roofline_pct.mamba_fused``: the fused Mamba layer's kernels' share of
their roofline (``roofline.py``), in %.

The work of a call is a frozen copy of the program's ``chip_smoke.py``
counts (``_xdbl_work``, ``_mamba_ops``, ``_mamba_bwd_ops``), per
(image, direction, row, channel): x_dbl's 2C products on the tensor
cores and the conv and SiLU's 13 operations; the scan's conv and SiLU
13, dt_proj 2R, softplus 4, the N-state update and readout 7N, the skip
2, all on the CUDA cores; the backward, which keeps only its inputs,
recomputes that forward and runs the adjoint (2R + 10N). Bytes: each
wrapper's inputs and outputs once, fp32.
"""

from roofline import share

KERNELS = ("mamba_xdbl_kernel", "mamba_xdbl_sum_kernel",
           "mamba_scan_sums_kernel", "mamba_scan_carry_kernel",
           "mamba_scan_kernel", "mamba_scan_bwd_sums_kernel",
           "mamba_scan_bwd_carry_kernel", "mamba_scan_bwd_grad_kernel")
COUNTER = {"xdbl": "mamba_xdbl", "scan": "mamba_scan",
           "scan_bwd": "mamba_scan_bwd"}


def _ops(rank, n):
    return 13 + 2 * rank + 4 + 7 * n + 2


def work(kind, b, k, l, d, n, rank, taps):
    elems = b * k * l * d
    c = rank + 2 * n
    if kind == "xdbl":
        return 2.0 * elems * c, 13.0 * elems
    if kind == "scan":
        return 0.0, elems * _ops(rank, n)
    if kind == "scan_bwd":
        return 0.0, elems * (2 * _ops(rank, n) + 2 * rank + 10 * n)
    raise ValueError(kind)


def nbytes(kind, b, k, l, d, n, rank, taps, elt=4):
    c = rank + 2 * n
    src = 2 * b * l * d
    xdbl = b * k * l * c
    conv = k * taps * d + k * d
    if kind == "xdbl":
        return elt * (src + conv + k * c * d + xdbl)
    weights = conv + k * d * rank + k * d + k * d * n + k * d
    y = b * k * l * d
    if kind == "scan":
        return elt * (src + xdbl + weights + y)
    grads = 3 * y + xdbl + b * k * d * (n + 2 + rank)
    return elt * (src + xdbl + weights + y + grads)


def read(ctx):
    calls_of = getattr(ctx["flops"], "mamba_fused_calls", None)
    if calls_of is None:
        return None
    return share(ctx, calls_of(ctx["config"], ctx["workload"]), COUNTER,
                 KERNELS, work, nbytes)
