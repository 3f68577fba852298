"""The Swin block's window-attention sub-layer: a CUDA kernel and its plain
version.

Counterpart of ``medical_image_analysis_tpu/ops/swin_block.py``
(``fused_swin_attn_block``, ``_swin_attn_unfused``)::

    y = x + proj(WindowMHA(LN(x)) + rel-pos bias + shift mask)

over windows ``x`` (B*nW, L = ws*ws, C) in ``window_partition`` order, so
row ``r`` belongs to the in-image window ``r % nW``. Weights are in (in,
out) layout and in x's dtype; ``bias`` (heads, L, L) and ``mask`` (nW, L,
L) are fp32, the mask zeros (1, L, L) for an unshifted block. LayerNorm is
fp32 with eps 1e-5 (the ViT block's is 1e-6).

- ``swin_attn_fwd`` (kernel ``swin_attn_fwd``): fp32 or bf16. In bf16 it
  rounds where the TPU kernel rounds: h to x's dtype, q, k and v to it
  after the fp32 bias, scores from fp32 q and k, p to v's dtype before
  p.v, each head's output to x's dtype, the out-projection summed in fp32
  with its bias and rounded before the residual add.
- ``swin_attn_block_plain``: the same function in plain PyTorch, all heads
  at once, as ``_swin_attn_unfused`` computes it.

The wrapper runs the kernel on a CUDA tensor and the plain version on a CPU
tensor; there is no fallback between the two. The sub-layer is five
launches: ``csrc/vit_block.cu``'s LayerNorm statistics and LN(x) in x's
dtype, its tensor-core GEMM (``gemm_tc_kernel``: fp32 in 3xTF32, bf16 as
it is) with the bias epilogue for q, k and v, the window-attention core of
``csrc/swin_block.cu``, whose header says what bounds the sub-layer on the
H100, and the GEMM again with the bias + residual epilogue for the output.
``launches["swin_attn_fwd"]`` counts wrapper calls that launched them (one
call is one sub-layer). The output is a new tensor: the TPU call aliases it
to x, but the Swin block reads x afterwards.

There is no backward kernel and no ``autograd.Function``: the JAX package
has none either (its custom VJP recomputes through the unfused path and is
never on a hot path). ``models.swin.SwinBlock`` takes this sub-layer only
in eval mode and where no gradient is needed through it; training goes
through the unfused route in ordinary PyTorch ops.
"""

from __future__ import annotations

import ctypes

import torch

from . import vit_block as vb
from .build import load_library

KERNEL_SOURCE = "medical_image_analysis_tpu_torch/csrc/swin_block.cu"
launches = {"swin_attn_fwd": 0}

EPS = 1e-5
HEAD_DIMS = (8, 16, 32, 64)  # the head widths the core kernel takes
MAX_L = 64  # the window tokens it takes (kMaxL): windows up to 8 x 8
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build() -> tuple[ctypes.CDLL, str]:
    """Build (or reuse) the core kernel's library, and the ViT block's whose
    LayerNorm kernels and GEMM the sub-layer launches; returns ``(lib,
    nvcc log of this source)``. This source is built first, so that a
    caller building every source at once runs both nvcc's together."""
    lib, log = load_library("swin_block")
    vb.build()
    lib.mia_swin_attn_core.argtypes = [
        _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P,
    ]
    lib.mia_swin_attn_core.restype = _I
    return lib, log


def swin_attn_block_plain(x, wqkv, bqkv, wo, bo, g, b, bias, mask, heads):
    """Plain version of :func:`swin_attn_fwd` (``_swin_attn_unfused``, with
    the TPU kernel's rounding points): fp32 scores and sums, every head at
    once."""
    bn, l, d = x.shape
    hd = d // heads
    h = vb._ln(x, g, b, EPS).to(x.dtype)
    qkv = (vb._mm(h, wqkv) + bqkv.float()).to(x.dtype)
    q, k, v = qkv.reshape(bn, l, 3, heads, hd).unbind(2)
    s = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * hd**-0.5
    s = s + bias.float()[None]
    nw = mask.shape[0]
    s = (s.reshape(bn // nw, nw, heads, l, l)
         + mask.float()[None, :, None]).reshape(bn, heads, l, l)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bhls,bshd->blhd", p.float(), v.float()).to(x.dtype)
    return x + (vb._mm(o.reshape(bn, l, d), wo) + bo.float()).to(x.dtype)


def _check(x, wqkv, bqkv, wo, bo, g, b, bias, mask, heads):
    """Raise on what the kernels do not take."""
    d = x.shape[-1]
    vb._check("swin_attn_fwd", x,
              dict(wqkv=wqkv, bqkv=bqkv, wo=wo, bo=bo, ln_g=g, ln_b=b),
              [(d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,)])
    if heads < 1 or d % heads or d // heads not in HEAD_DIMS:
        raise ValueError(f"swin_attn_fwd: head width {d}/{heads} is not one "
                         f"of {HEAD_DIMS}")
    bn, l, _ = x.shape
    if l > MAX_L:
        raise ValueError(f"swin_attn_fwd: {l} tokens a window, above {MAX_L}")
    nw = mask.shape[0] if mask.ndim == 3 else 0
    for name, t, shape in (("bias", bias, (heads, l, l)),
                           ("mask", mask, (nw, l, l))):
        if (t.dtype != torch.float32 or t.device != x.device
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"swin_attn_fwd: {name} must be a contiguous fp32 tensor of "
                f"shape {shape} on {x.device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if nw < 1 or bn % nw:
        raise ValueError(f"swin_attn_fwd: {bn} windows are not a multiple of "
                         f"the mask's {nw}")


def swin_attn_fwd(x, wqkv, bqkv, wo, bo, g, b, bias, mask, heads):
    """``x + proj(WindowMHA(LN(x)) + bias + mask) + bo``: (B*nW, L, C) in
    x's dtype (fp32 or bf16), a new tensor. Weights in x's dtype, (in, out)
    layout; ``bias`` (heads, L, L), ``mask`` (nW, L, L) fp32; the head width
    must be one of ``HEAD_DIMS``."""
    if vb._on_cpu(x):
        return swin_attn_block_plain(x, wqkv, bqkv, wo, bo, g, b, bias, mask,
                                     heads)
    _check(x, wqkv, bqkv, wo, bo, g, b, bias, mask, heads)
    bn, l, d = x.shape
    rows = bn * l
    lib, _ = build()
    run = vb._Launcher(x)
    x2 = x.view(rows, d)
    mu, rstd = run.ln_stats(x2, EPS)
    h = run.ln_apply(x2, mu, rstd, g, b)
    qkv = run.gemm(h, wqkv, rows, 3 * d, d, epi=vb.EPI_BIAS, bias=bqkv,
                   out=run.like(rows, 3 * d))
    del h  # the caching allocator reuses it in stream order
    o = run.like(rows, d)
    vb._raise_on(lib.mia_swin_attn_core(
        run.bf16, qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(),
        o.data_ptr(), bn, l, heads, d // heads, mask.shape[0],
        (d // heads) ** -0.5, run.stream), "swin_attn_fwd core")
    y = run.gemm(o, wo, rows, d, d, epi=vb.EPI_BIAS_RESID, bias=bo,
                 resid=x2, out=run.like(bn, l, d))
    launches["swin_attn_fwd"] += 1
    return y


def work(windows: int, l: int, d: int, heads: int) -> tuple[float, float]:
    """Floating-point operations one sub-layer call needs (a multiply-add is
    two), counted from the shapes, as ``(products, other)``: the QKV and
    output projections, the scores and p.v; and 6 per score for the bias
    and mask adds and the softmax (max, exp, sum, scale)."""
    rows = windows * l
    return (2 * rows * d * 4 * d + 4 * rows * l * d,
            6 * windows * heads * l * l)


def flops(windows: int, l: int, d: int, heads: int) -> float:
    """All of :func:`work`'s operations, products and the rest."""
    return float(sum(work(windows, l, d, heads)))
