"""Fused short-sequence attention: the CUDA kernel, its plain version and the
JAX package's dispatch.

Counterpart of ``medical_image_analysis_tpu/ops/attention.py``
(``fused_attention`` and ``_attn_kernel``). ``attention_fwd`` (the
tensor-core core of ``csrc/attn_tc.cuh``, launched by ``csrc/attention.cu``;
the header says what bounds it on the H100 and how its design answers
that) computes, per (batch, head), ``softmax(q k^T * scale + mask) v``:
fp32 scores, the products in 3xTF32 for fp32 operands and in bf16 for bf16
ones, an online softmax in fp32 with p rounded to v's dtype before the
product, fp32 accumulation, the output in q's dtype.
``attention_plain`` is its plain version. The wrapper launches the kernel
on a CUDA tensor, or raises (dtype, shape, layout, head width, or a launch
error), and runs the plain version on a CPU tensor; there is no fallback
between the two. ``launches`` counts kernel launches.

:func:`fused_attention` keeps the JAX function's dispatch exactly: the
kernel route only when S == L and ``g * L * S * 4 <= 8 MiB`` (``g`` halved
from ``group`` until it divides B * H), else the einsum route in the input
dtype (bf16 scores in bf16). That is a dispatch by shape, as the reference
has it. The kernel is forward only, as in the JAX package: under a
gradient the kernel route takes ``attention_plain``, which autograd
differentiates, by a gate that reads the grad mode and ``requires_grad``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library

KERNEL_SOURCE = "medical_image_analysis_tpu_torch/csrc/attn_tc.cuh"
launches = {"fused_attention": 0}

HEAD_DIMS = (16, 32, 64, 128)  # the head widths the kernel takes
MAX_L = 1448  # the longest sequence it takes (kMaxL): L * L * 4 <= 8 MiB
_TILE_BYTES = 8 * 1024 * 1024  # the TPU kernel's fp32 score tile budget
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build() -> tuple[ctypes.CDLL, str]:
    """Build (or reuse) the kernel's library; returns ``(lib, nvcc log)``."""
    lib, log = load_library("attention")
    lib.mia_attention_fwd.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _L, _L, ctypes.c_float, _P,
    ]
    lib.mia_attention_fwd.restype = _I
    return lib, log


def attention_plain(q, k, v, mask=None, scale=None):
    """Plain version of the kernel: q, k, v (B, L, H, hd), mask (L, L) or
    None; returns (B, L, H, hd) in q's dtype, rounded where ``_attn_kernel``
    rounds (``attention.py:29-45``)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * scale
    if mask is not None:
        s = s + mask.float()
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhls,bshd->blhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _einsum_route(q, k, v, mask, scale):
    """The JAX function's route off the kernel (``attention.py:66-72``): the
    input dtype throughout, bf16 scores in bf16."""
    attn = torch.einsum("blhd,bshd->bhls", q, k) * scale
    if mask is not None:
        attn = attn + mask[None, None].to(attn.dtype)
    attn = torch.softmax(attn, dim=-1)
    return torch.einsum("bhls,bshd->blhd", attn.to(v.dtype), v)


def _check(q, k, v, mask):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention: dtype {q.dtype} is not f32/bf16")
    if q.ndim != 4:
        raise ValueError(f"fused_attention: q must be (B, L, H, hd); got "
                         f"{tuple(q.shape)}")
    b, l, h, hd = q.shape
    if hd not in HEAD_DIMS or l > MAX_L:
        raise ValueError(f"fused_attention: head width {hd}, L={l} "
                         f"unsupported (widths {HEAD_DIMS}, L <= {MAX_L})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride(3) != 1 or t.stride(2) != hd):
            raise ValueError(
                f"fused_attention: {name} must be a {q.dtype} (B, L, H, hd) "
                f"tensor of q's shape on {q.device} with heads and head dims "
                f"contiguous; got {t.dtype} {tuple(t.shape)} strides "
                f"{t.stride()}")
    if mask is not None and (mask.dtype != torch.float32
                             or mask.device != q.device
                             or tuple(mask.shape) != (l, l)
                             or not mask.is_contiguous()):
        raise ValueError(f"fused_attention: mask must be a contiguous fp32 "
                         f"({l}, {l}) tensor on {q.device}")
    return b, l, h, hd


def _aligned(t):
    """``t`` when each of its rows starts on a 16-byte boundary (the
    kernel's cp.async copies move 16 bytes at a time), else a contiguous
    copy of it."""
    e = t.element_size()
    if t.data_ptr() % 16 == 0 and t.stride(0) * e % 16 == 0 and (
            t.stride(1) * e % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def attention_fwd(q, k, v, mask=None, scale=None):
    """``softmax(q k^T * scale + mask) v`` through the kernel: q, k, v
    (B, L, H, hd) read in place (any batch and token strides whose rows
    start on 16 bytes; others are copied first); mask (L, L) fp32 or None.
    Returns a contiguous (B, L, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    b, l, h, hd = _check(q, k, v, mask)
    scale = scale if scale is not None else hd**-0.5
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty(b, l, h, hd, device=q.device, dtype=q.dtype)
    lib, _ = build()
    err = lib.mia_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, h, l, hd,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_attention: kernel launch failed with "
                           f"cudaError {err}")
    launches["fused_attention"] += 1
    return out


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def fused_attention(q, k, v, mask=None, scale=None, group: int = 8,
                    plain: bool = False):
    """q (B, L, H, hd), k and v (B, S, H, hd), mask (L, S) additive or
    None. Returns (B, L, H, hd).

    The kernel route when S == L and the fp32 score tile of ``g`` heads
    fits 8 MiB, else the einsum route (the JAX function's dispatch). On the
    kernel route, ``plain`` or a gradient through q, k, v or the mask takes
    ``attention_plain``."""
    b, l, h, hd = q.shape
    s_len = k.shape[1]
    scale = scale if scale is not None else hd**-0.5
    g = group
    bh = b * h
    while g > 1 and bh % g != 0:
        g //= 2
    use_kernel = (
        l == s_len
        and bh % g == 0
        and g * l * s_len * 4 <= _TILE_BYTES  # the TPU's scores tile in VMEM
    )
    if not use_kernel:
        return _einsum_route(q, k, v, mask, scale)
    if plain or _needs_grad(q, k, v, mask):
        return attention_plain(q, k, v, mask, scale)
    m = None if mask is None else mask.float().contiguous()
    return attention_fwd(q, k, v, m, scale)


def work(b: int, l: int, h: int, hd: int) -> tuple[float, float]:
    """Operations of one call as ``(products, other)``: the two products,
    2 * L * L * hd each per (batch, head), and the softmax's max,
    subtraction, exp, sum and division, 5 per score."""
    scores = b * h * l * l
    return 4 * hd * scores, 5 * scores


def flops(b: int, l: int, h: int, hd: int) -> float:
    """All of :func:`work`'s operations, products and the rest."""
    return float(sum(work(b, l, h, hd)))
