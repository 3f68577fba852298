"""The pre-LN ViT block's two sub-layers: CUDA kernels and plain versions.

Counterpart of ``medical_image_analysis_tpu/ops/vit_block.py``
(``fused_attn_block``, ``fused_mlp_block`` and their custom VJPs)::

    attention:  y = x + proj(MHA(LN(x)))              (_attn_block_kernel)
    MLP:        y = x + fc2(gelu_tanh(fc1(LN(x))))    (_mlp_block_kernel)

Weights are in (in, out) layout, as the JAX block keeps them. LayerNorm is
fp32 with eps 1e-6, and the GELU is the tanh approximation, as both the
TPU kernels and the JAX package's unfused path compute it.

- ``attn_block_fwd`` / ``mlp_block_fwd`` (kernels ``vit_attn_fwd``,
  ``vit_mlp_fwd``): fp32 or bf16. In bf16 they round where the TPU kernel
  rounds: h to x's dtype, q, k and v to it after the fp32 bias, scores from
  q and k with fp32 sums, p to v's dtype before p.v, each head's output to
  x's dtype, the out-projection summed in fp32 with its bias and rounded
  before the residual add; the MLP likewise (h, the GELU output, fc2's
  output).
- ``attn_block_bwd`` / ``mlp_block_bwd`` (``vit_attn_bwd``, ``vit_mlp_bwd``):
  fp32. They recompute the forward from x (no stored probabilities or
  hidden activations) and return dx and fp32 weight gradients.

All four, and ``swin_block``'s sub-layer, run every product on the tensor
cores (``gemm_tc_kernel``, ``csrc/attn_tc.cuh``'s core, the attention
backward's two passes): fp32 in 3xTF32, bf16 as it is. Each writes LN(x)
once in x's dtype (``ln_apply_kernel``) for the products that read it.

The kernels are in ``csrc/vit_block.cu``, whose header says what bounds
them on the H100 and how their design answers that. Each wrapper runs its
kernels on a CUDA tensor and its plain version (``*_plain``) on a CPU
tensor; there is no fallback between the two. ``launches`` counts wrapper
calls that launched their kernels: one call is one sub-layer, several CUDA
launches. ``AttnBlockFn`` and ``MlpBlockFn`` save the sub-layer's inputs
and run the backward wrappers. The TPU's batch blocking, VMEM planning
(``fused_bwd_fits``) and its XLA backward switch have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import load_library

KERNEL_SOURCE = "medical_image_analysis_tpu_torch/csrc/vit_block.cu"
launches = {"vit_attn_fwd": 0, "vit_mlp_fwd": 0, "vit_attn_bwd": 0,
            "vit_mlp_bwd": 0}

EPS = 1e-6
HEAD_DIMS = (16, 32, 64, 128)  # the head widths the attention kernels take
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build() -> tuple[ctypes.CDLL, str]:
    """Build (or reuse) the kernels' library; returns ``(lib, nvcc log)``."""
    lib, log = load_library("vit_block")
    lib.mia_vit_ln_stats.argtypes = [_P, _I, _P, _P, _I, _I, _F, _P]
    lib.mia_vit_gemm_tc.argtypes = [
        _I,  # is_bf16
        _P, _I, _I,  # a, a_trans, lda
        _P, _I, _I,  # b, b_trans, ldb
        _I, _I, _I, _I,  # M, N, K, k_chunk
        _I, _P, _P, _P, _I,  # epilogue, bias, resid, aux, ld_aux
        _P, _P, _I, _P,  # out, out2, ldc, stream
    ]
    lib.mia_vit_ln_apply.argtypes = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _P]
    lib.mia_vit_attn_core_tc.argtypes = [
        _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P,
    ]
    lib.mia_vit_attn_bwd.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P,
    ]
    lib.mia_vit_colsum.argtypes = [_P, _I, _I, _I, _I, _P, _P]
    lib.mia_vit_ln_bwd.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
    ]
    for fn in (lib.mia_vit_ln_stats, lib.mia_vit_gemm_tc,
               lib.mia_vit_ln_apply, lib.mia_vit_attn_core_tc,
               lib.mia_vit_attn_bwd, lib.mia_vit_colsum, lib.mia_vit_ln_bwd):
        fn.restype = _I
    return lib, log


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def _ln(x, g, b, eps=EPS):
    """fp32 LayerNorm of x over its last axis (``_ln``, vit_block.py:74)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def _ln_fwd32(x, g, b, eps=EPS):
    """(xhat, 1/sigma, fp32 gamma, LN(x)) over the rows of x (``_ln_fwd32``)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (x32 - mu) * inv
    g32 = g.float()
    return xhat, inv, g32, xhat * g32 + b.float()


def _ln_bwd32(dh, xhat, inv, g32):
    """Gradient through LN given dL/dh32 (``_ln_bwd32``): (dx32, dg, db),
    the last two summed over every row."""
    rows = tuple(range(dh.ndim - 1))
    dg = torch.sum(dh * xhat, dim=rows)
    db = torch.sum(dh, dim=rows)
    dxh = dh * g32
    dx32 = (dxh - dxh.mean(-1, keepdim=True)
            - xhat * (dxh * xhat).mean(-1, keepdim=True)) * inv
    return dx32, dg, db


def gelu_tanh(x):
    """tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def _gelu_tanh_grad(x):
    """d/dx of the tanh-approximate GELU, fp32 (``_gelu_tanh_grad``)."""
    c = 0.7978845608028654  # sqrt(2/pi)
    t = torch.tanh(c * (x + 0.044715 * x * x * x))
    return (0.5 * (1.0 + t)
            + 0.5 * x * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * x * x))


def _mm(a, b):
    """fp32 product of two tensors of the working dtype (the kernels' bf16
    operands with fp32 sums)."""
    return a.float() @ b.float()


def _qkv(x, wqkv, bqkv, g, b, heads):
    """h rounded to x's dtype, and q, k, v as (B, heads, L, hd) in it."""
    bsz, seq, d = x.shape
    h = _ln(x, g, b).to(x.dtype)
    qkv = (_mm(h, wqkv) + bqkv.float()).to(x.dtype)
    qkv = qkv.reshape(bsz, seq, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    return h, qkv[0], qkv[1], qkv[2]


def _head_probs(q, k, scale):
    """Softmax probabilities of one head from fp32 q and k, fp32."""
    return torch.softmax(_mm(q, k.transpose(-1, -2)) * scale, dim=-1)


def attn_block_plain(x, wqkv, bqkv, wo, bo, g, b, heads):
    """Plain version of ``attn_block_fwd``: ``x + proj(MHA(LN(x)))`` with the
    TPU kernel's rounding points, one head at a time (the (L, L) scores of
    one head at a time, as the kernel's loop over heads keeps them)."""
    bsz, seq, d = x.shape
    scale = (d // heads) ** -0.5
    _, q, k, v = _qkv(x, wqkv, bqkv, g, b, heads)
    outs = []
    for i in range(heads):
        p = _head_probs(q[:, i], k[:, i], scale)
        outs.append(_mm(p.to(v.dtype), v[:, i]).to(x.dtype))
    o = torch.cat(outs, dim=-1)
    return x + (_mm(o, wo) + bo.float()).to(x.dtype)


def mlp_block_plain(x, w1, b1, w2, b2, g, b):
    """Plain version of ``mlp_block_fwd``: ``x + fc2(gelu_tanh(fc1(LN(x))))``
    with the TPU kernel's rounding points."""
    h = _ln(x, g, b).to(x.dtype)
    hidden = gelu_tanh(_mm(h, w1) + b1.float()).to(x.dtype)
    return x + (_mm(hidden, w2) + b2.float()).to(x.dtype)


def attn_block_bwd_plain(x, wqkv, bqkv, wo, bo, g, b, heads, dy):
    """Plain version of ``attn_block_bwd`` (the body of
    ``_attn_block_bwd_kernel``): recompute from x, then dx in x's dtype and
    fp32 (dwqkv, dbqkv, dwo, dbo, dg, db)."""
    bsz, seq, d = x.shape
    scale = (d // heads) ** -0.5
    xhat, inv, g32, h32 = _ln_fwd32(x, g, b)
    h = h32.to(x.dtype)
    qkv = (_mm(h, wqkv) + bqkv.float()).to(x.dtype)
    q, k, v = (qkv.reshape(bsz, seq, 3, heads, d // heads)
               .permute(2, 0, 3, 1, 4))
    dy32 = dy.float()
    do = (dy32 @ wo.float().t()).to(x.dtype)
    do = do.reshape(bsz, seq, heads, d // heads).transpose(1, 2)
    outs, dqs, dks, dvs = [], [], [], []
    for i in range(heads):
        p = _head_probs(q[:, i], k[:, i], scale)
        pc = p.to(x.dtype)
        outs.append(_mm(pc, v[:, i]).to(x.dtype))
        dvs.append(_mm(pc.transpose(-1, -2), do[:, i]).to(x.dtype))
        dp = _mm(do[:, i], v[:, i].transpose(-1, -2))
        ds = (p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
              * scale).to(x.dtype)
        dqs.append(_mm(ds, k[:, i]).to(x.dtype))
        dks.append(_mm(ds.transpose(-1, -2), q[:, i]).to(x.dtype))
    o = torch.cat(outs, dim=-1).reshape(bsz * seq, d)
    dqkv = torch.cat([torch.cat(t, dim=-1) for t in (dqs, dks, dvs)], dim=-1)
    dqkv = dqkv.reshape(bsz * seq, 3 * d).float()
    dwo = o.float().t() @ dy32.reshape(bsz * seq, d)
    dwqkv = h.reshape(bsz * seq, d).float().t() @ dqkv
    dh = (dqkv @ wqkv.float().t()).reshape(bsz, seq, d)
    dx32, dg, db = _ln_bwd32(dh, xhat, inv, g32)
    return (dy + dx32.to(x.dtype), dwqkv, dqkv.sum(0), dwo,
            dy32.sum(dim=(0, 1)), dg, db)


def mlp_block_bwd_plain(x, w1, b1, w2, b2, g, b, dy):
    """Plain version of ``mlp_block_bwd`` (the body of
    ``_mlp_block_bwd_kernel``, the hidden layer in one piece): dx in x's
    dtype and fp32 (dw1, db1, dw2, db2, dg, db)."""
    d = x.shape[-1]
    xhat, inv, g32, h32 = _ln_fwd32(x, g, b)
    h = h32.to(x.dtype).reshape(-1, d)
    dy32 = dy.float().reshape(-1, d)
    hpre = _mm(h, w1) + b1.float()
    hid = gelu_tanh(hpre).to(x.dtype)
    dw2 = hid.float().t() @ dy32
    dhid = dy32 @ w2.float().t()
    dhpre = (dhid * _gelu_tanh_grad(hpre)).to(x.dtype).float()
    dw1 = h.float().t() @ dhpre
    dh = (dhpre @ w1.float().t()).reshape(x.shape)
    dx32, dg, db = _ln_bwd32(dh, xhat, inv, g32)
    return (dy + dx32.to(x.dtype), dw1, dhpre.sum(0), dw2, dy32.sum(0), dg,
            db)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

# GEMM epilogues: the values of ``enum Epi`` in csrc/vit_block.cu.
(EPI_F32, EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESID, EPI_DGELU, EPI_STORE,
 EPI_BIAS_F32_GELU) = range(7)
_GEMM_TILE = 128  # rows and columns of a GEMM block's output tile
_GEMM_TC_BK = 32  # the tensor-core GEMM's slice (kTcBK): split-K chunks align
_TARGET_BLOCKS = 264  # two waves of the H100's 132 SMs: split-K below that
_COLSUM_ROWS = 512  # rows a block of the column sum adds
_LN_BWD_ROWS = 64  # rows a block of the LN backward handles
_LN_MAX_COLS = 1024  # widths the LN backward kernel takes (kLnMaxCols)


def _on_cpu(x):
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"vit_block: unsupported device {x.device}")
    return False


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def _check(name, x, weights, shapes, dtypes=(torch.float32, torch.bfloat16)):
    """Raise on what the kernels do not take."""
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: x dtype {x.dtype} is not one of {dtypes}")
    if x.ndim != 3 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty contiguous (B, L, d) "
                         f"tensor; got {tuple(x.shape)}")
    for (wname, w), shape in zip(weights.items(), shapes):
        if (w.dtype != x.dtype or w.device != x.device
                or tuple(w.shape) != shape or not w.is_contiguous()):
            raise ValueError(
                f"{name}: {wname} must be a contiguous {x.dtype} tensor of "
                f"shape {shape} on {x.device}; got {w.dtype} "
                f"{tuple(w.shape)} on {w.device}")


def _check_dy(name, x, dy):
    """The backward's extra conditions: dy like x, and a width the LN
    backward kernel holds in registers."""
    if x.shape[-1] > _LN_MAX_COLS:
        raise ValueError(f"{name}: width {x.shape[-1]} is above "
                         f"{_LN_MAX_COLS}")
    if (dy.dtype != x.dtype or dy.device != x.device or dy.shape != x.shape
            or not dy.is_contiguous()):
        raise ValueError(f"{name}: dy must be a contiguous {x.dtype} tensor "
                         f"of shape {tuple(x.shape)} on {x.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


class _Launcher:
    """The library's entry points for one sub-layer call on one device."""

    def __init__(self, x):
        self.lib, _ = build()
        self.x = x
        self.bf16 = int(x.dtype == torch.bfloat16)
        self.stream = torch.cuda.current_stream(x.device).cuda_stream

    def f32(self, *shape):
        return torch.empty(*shape, device=self.x.device, dtype=torch.float32)

    def like(self, *shape):
        return torch.empty(*shape, device=self.x.device, dtype=self.x.dtype)

    def ln_stats(self, x2, eps=EPS):
        rows, d = x2.shape
        mu, rstd = self.f32(rows), self.f32(rows)
        _raise_on(self.lib.mia_vit_ln_stats(
            x2.data_ptr(), self.bf16, mu.data_ptr(), rstd.data_ptr(), rows,
            d, eps, self.stream), "vit_ln_stats")
        return mu, rstd

    def gemm(self, a, b, m, n, k, *, a_trans=False, b_trans=False,
             epi=EPI_F32, bias=None, resid=None, aux=None, out=None,
             out2=None):
        """out (m, n) = A @ B with the epilogue on the tensor cores, in x's
        dtype (fp32 in 3xTF32, bf16 as it is). A is (m, k), or (k, m) when
        ``a_trans``; B is (k, n), or (n, k) when ``b_trans``. With
        ``epi=EPI_F32`` and no ``out`` the product is split along k into
        fixed chunks whose fp32 partials are summed here in order, so that a
        product with few output tiles still fills the card and two runs
        give the same bits. ``EPI_BIAS_GELU`` writes the GELU of the fp32
        acc + bias, rounded once; ``EPI_BIAS_F32_GELU`` writes acc + bias to
        ``out`` (fp32) and its GELU to ``out2``."""
        tiles = -(-m // _GEMM_TILE) * -(-n // _GEMM_TILE)
        partials = out is None
        splits = 1
        if partials:
            if epi != EPI_F32:
                raise ValueError("gemm: only the fp32 epilogue allocates")
            splits = max(1, min(-(-_TARGET_BLOCKS // tiles), k // 1024))
            out = self.f32(splits, m, n)
        # its 16-byte copies need 16-byte aligned operands
        a, b = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (a, b))
        chunk = -(-k // splits)
        chunk = -(-chunk // _GEMM_TC_BK) * _GEMM_TC_BK
        _raise_on(self.lib.mia_vit_gemm_tc(
            self.bf16, a.data_ptr(), int(a_trans), m if a_trans else k,
            b.data_ptr(), int(b_trans), k if b_trans else n, m, n, k, chunk,
            epi, _ptr(bias), _ptr(resid), _ptr(aux), n,
            out.data_ptr(), _ptr(out2), n, self.stream), "vit_gemm_tc")
        return out.sum(dim=0) if partials else out

    def ln_apply(self, x2, mu, rstd, g, b):
        """h = LN(x) (rows, d) in x's dtype from the row statistics."""
        rows, d = x2.shape
        h = self.like(rows, d)
        _raise_on(self.lib.mia_vit_ln_apply(
            x2.data_ptr(), self.bf16, mu.data_ptr(), rstd.data_ptr(),
            g.data_ptr(), b.data_ptr(), h.data_ptr(), rows, d, self.stream),
            "vit_ln_apply")
        return h

    def colsum(self, t2):
        """fp32 sums over the rows of a (rows, cols) tensor, per-block
        partials summed here in order."""
        rows, cols = t2.shape
        splits = -(-rows // _COLSUM_ROWS)
        part = self.f32(splits, cols)
        _raise_on(self.lib.mia_vit_colsum(
            t2.data_ptr(), int(t2.dtype == torch.bfloat16), rows, cols,
            _COLSUM_ROWS, part.data_ptr(), self.stream), "vit_colsum")
        return part.sum(dim=0)


def _check_attn(name, x, wqkv, bqkv, wo, bo, g, b, heads,
                dtypes=(torch.float32, torch.bfloat16)):
    d = x.shape[-1]
    _check(name, x, dict(wqkv=wqkv, bqkv=bqkv, wo=wo, bo=bo, ln_g=g, ln_b=b),
           [(d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,)], dtypes)
    if heads < 1 or d % heads or d // heads not in HEAD_DIMS:
        raise ValueError(f"{name}: head width {d}/{heads} is not one of "
                         f"{HEAD_DIMS}")


def _attn_core(run, qkv, bsz, seq, d, heads, do=None):
    """Each head's output o (B*L, d) in x's dtype through the tensor-core
    core, q, k and v read in place from qkv (B*L, 3d). With ``do`` (the
    backward's recompute, fp32) also the per-row logsumexp (log2 units)
    and D = do . o, both (B, heads, L)."""
    o = run.like(bsz * seq, d)
    lse = dsum = None
    if do is not None:
        lse, dsum = run.f32(bsz, heads, seq), run.f32(bsz, heads, seq)
    _raise_on(run.lib.mia_vit_attn_core_tc(
        run.bf16, qkv.data_ptr(), o.data_ptr(), _ptr(lse), _ptr(do),
        _ptr(dsum), bsz, seq, heads, d // heads, (d // heads) ** -0.5,
        run.stream), "vit_attn core")
    return o if do is None else (o, lse, dsum)


def attn_block_fwd(x, wqkv, bqkv, wo, bo, g, b, heads):
    """``x + proj(MHA(LN(x)))``: (B, L, d) in x's dtype (fp32 or bf16).
    Weights in x's dtype, (in, out) layout; the head width must be one of
    ``HEAD_DIMS``. LN(x) once, both products on the tensor-core GEMM and
    the heads through the tensor-core core."""
    if _on_cpu(x):
        return attn_block_plain(x, wqkv, bqkv, wo, bo, g, b, heads)
    _check_attn("attn_block_fwd", x, wqkv, bqkv, wo, bo, g, b, heads)
    bsz, seq, d = x.shape
    rows = bsz * seq
    run = _Launcher(x)
    x2 = x.view(rows, d)
    mu, rstd = run.ln_stats(x2)
    h = run.ln_apply(x2, mu, rstd, g, b)
    qkv = run.gemm(h, wqkv, rows, 3 * d, d, epi=EPI_BIAS, bias=bqkv,
                   out=run.like(rows, 3 * d))
    o = _attn_core(run, qkv, bsz, seq, d, heads)
    y = run.gemm(o, wo, rows, d, d, epi=EPI_BIAS_RESID, bias=bo, resid=x2,
                 out=run.like(bsz, seq, d))
    launches["vit_attn_fwd"] += 1
    return y


def mlp_block_fwd(x, w1, b1, w2, b2, g, b):
    """``x + fc2(gelu_tanh(fc1(LN(x))))``: (B, L, d) in x's dtype (fp32 or
    bf16), the TPU kernel's sequence and rounding points: LN(x) once in x's
    dtype, fc1 with the bias and GELU on its fp32 sum rounded to x's dtype,
    fc2 with its bias rounded before the residual add. Both products on the
    tensor-core GEMM."""
    if _on_cpu(x):
        return mlp_block_plain(x, w1, b1, w2, b2, g, b)
    d, hidden = x.shape[-1], w1.shape[-1]
    _check("mlp_block_fwd", x,
           dict(w1=w1, b1=b1, w2=w2, b2=b2, ln_g=g, ln_b=b),
           [(d, hidden), (hidden,), (hidden, d), (d,), (d,), (d,)])
    rows = x.numel() // d
    run = _Launcher(x)
    x2 = x.view(rows, d)
    mu, rstd = run.ln_stats(x2)
    h = run.ln_apply(x2, mu, rstd, g, b)
    hid = run.gemm(h, w1, rows, hidden, d, epi=EPI_BIAS_GELU, bias=b1,
                   out=run.like(rows, hidden))
    del h  # the caching allocator reuses it in stream order
    y = run.gemm(hid, w2, rows, d, hidden, epi=EPI_BIAS_RESID, bias=b2,
                 resid=x2, out=run.like(*x.shape))
    launches["vit_mlp_fwd"] += 1
    return y


def attn_block_bwd(x, wqkv, bqkv, wo, bo, g, b, heads, dy):
    """Adjoint of :func:`attn_block_fwd`, fp32: the outputs of
    :func:`attn_block_bwd_plain`. Recomputes LN, q/k/v and each head's
    output from x; two flash-style passes (over query tiles for dK and dV,
    over key tiles for dQ) with no atomics. Every product runs on the
    tensor cores in 3xTF32."""
    if _on_cpu(x):
        return attn_block_bwd_plain(x, wqkv, bqkv, wo, bo, g, b, heads, dy)
    _check_attn("attn_block_bwd", x, wqkv, bqkv, wo, bo, g, b, heads,
                (torch.float32,))
    _check_dy("attn_block_bwd", x, dy)
    bsz, seq, d = x.shape
    rows = bsz * seq
    run = _Launcher(x)
    x2, dy2 = x.view(rows, d), dy.view(rows, d)
    mu, rstd = run.ln_stats(x2)
    h = run.ln_apply(x2, mu, rstd, g, b)
    qkv = run.gemm(h, wqkv, rows, 3 * d, d, epi=EPI_BIAS, bias=bqkv,
                   out=run.f32(rows, 3 * d))
    do = run.gemm(dy2, wo, rows, d, d, b_trans=True, epi=EPI_STORE,
                  out=run.f32(rows, d))
    o, lse, dsum = _attn_core(run, qkv, bsz, seq, d, heads, do)
    dqkv = run.f32(rows, 3 * d)
    _raise_on(run.lib.mia_vit_attn_bwd(
        qkv.data_ptr(), do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
        dqkv.data_ptr(), bsz, seq, heads, d // heads, (d // heads) ** -0.5,
        run.stream), "vit_attn_bwd core")
    dwo = run.gemm(o, dy2, d, d, rows, a_trans=True)
    dwqkv = run.gemm(h, dqkv, d, 3 * d, rows, a_trans=True)
    dh = run.gemm(dqkv, wqkv, rows, d, 3 * d, b_trans=True, epi=EPI_STORE,
                  out=run.f32(rows, d))
    dx, dg, db = _ln_bwd(run, x2, dy2, dh, mu, rstd, g)
    out = (dx.view(x.shape), dwqkv, run.colsum(dqkv), dwo, run.colsum(dy2),
           dg, db)
    launches["vit_attn_bwd"] += 1
    return out


def mlp_block_bwd(x, w1, b1, w2, b2, g, b, dy):
    """Adjoint of :func:`mlp_block_fwd`, fp32: the outputs of
    :func:`mlp_block_bwd_plain`. The fp32 pre-activation is recomputed
    once, its GELU written beside it by the same epilogue for dW2 and its
    derivative applied where dhpre is formed. Every product runs on the
    tensor cores in 3xTF32."""
    if _on_cpu(x):
        return mlp_block_bwd_plain(x, w1, b1, w2, b2, g, b, dy)
    d, hidden = x.shape[-1], w1.shape[-1]
    _check("mlp_block_bwd", x,
           dict(w1=w1, b1=b1, w2=w2, b2=b2, ln_g=g, ln_b=b),
           [(d, hidden), (hidden,), (hidden, d), (d,), (d,), (d,)],
           (torch.float32,))
    _check_dy("mlp_block_bwd", x, dy)
    rows = x.numel() // d
    run = _Launcher(x)
    x2, dy2 = x.view(rows, d), dy.view(rows, d)
    mu, rstd = run.ln_stats(x2)
    h = run.ln_apply(x2, mu, rstd, g, b)
    hpre, hid = run.f32(rows, hidden), run.f32(rows, hidden)
    run.gemm(h, w1, rows, hidden, d, epi=EPI_BIAS_F32_GELU, bias=b1,
             out=hpre, out2=hid)
    dw2 = run.gemm(hid, dy2, hidden, d, rows, a_trans=True)
    del hid  # the caching allocator reuses it in stream order
    dhpre = run.gemm(dy2, w2, rows, hidden, d, b_trans=True, epi=EPI_DGELU,
                     aux=hpre, out=run.f32(rows, hidden))
    del hpre
    dw1 = run.gemm(h, dhpre, d, hidden, rows, a_trans=True)
    dh = run.gemm(dhpre, w1, rows, d, hidden, b_trans=True, epi=EPI_STORE,
                  out=run.f32(rows, d))
    dx, dg, db = _ln_bwd(run, x2, dy2, dh, mu, rstd, g)
    out = (dx.view(x.shape), dw1, run.colsum(dhpre), dw2, run.colsum(dy2),
           dg, db)
    launches["vit_mlp_bwd"] += 1
    return out


def _ln_bwd(run, x2, dy2, dh, mu, rstd, g):
    """dx = dy + LN's backward of dh, and dg, db from per-block partials."""
    rows, d = x2.shape
    blocks = -(-rows // _LN_BWD_ROWS)
    dx = run.like(rows, d)
    dg_part, db_part = run.f32(blocks, d), run.f32(blocks, d)
    _raise_on(run.lib.mia_vit_ln_bwd(
        x2.data_ptr(), dy2.data_ptr(), dh.data_ptr(), mu.data_ptr(),
        rstd.data_ptr(), g.data_ptr(), dx.data_ptr(), dg_part.data_ptr(),
        db_part.data_ptr(), rows, d, _LN_BWD_ROWS, run.stream), "vit_ln_bwd")
    return dx, dg_part.sum(dim=0), db_part.sum(dim=0)


# --------------------------------------------------------------------------
# Autograd
# --------------------------------------------------------------------------


class AttnBlockFn(torch.autograd.Function):
    """The attention sub-layer with its backward, as the JAX package's
    ``fused_attn_block`` custom VJP: ``attn_block_fwd`` /
    ``attn_block_bwd`` (their plain versions when ``plain``). It saves the
    sub-layer's inputs only."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, g, b, heads, plain):
        fwd = attn_block_plain if plain else attn_block_fwd
        ctx.save_for_backward(x, wqkv, bqkv, wo, bo, g, b)
        ctx.heads, ctx.plain = heads, plain
        return fwd(x, wqkv, bqkv, wo, bo, g, b, heads)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        bwd = attn_block_bwd_plain if ctx.plain else attn_block_bwd
        dx, *wg = bwd(*saved, ctx.heads, dy.to(saved[0].dtype).contiguous())
        return (dx, *(w.to(p.dtype) for w, p in zip(wg, saved[1:])), None,
                None)


class MlpBlockFn(torch.autograd.Function):
    """The MLP sub-layer with its backward (``fused_mlp_block``'s VJP):
    ``mlp_block_fwd`` / ``mlp_block_bwd`` (plain versions when ``plain``)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, g, b, plain):
        fwd = mlp_block_plain if plain else mlp_block_fwd
        ctx.save_for_backward(x, w1, b1, w2, b2, g, b)
        ctx.plain = plain
        return fwd(x, w1, b1, w2, b2, g, b)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        bwd = mlp_block_bwd_plain if ctx.plain else mlp_block_bwd
        dx, *wg = bwd(*saved, dy.to(saved[0].dtype).contiguous())
        return (dx, *(w.to(p.dtype) for w, p in zip(wg, saved[1:])), None)


def fused_attn_block(x, wqkv, bqkv, wo, bo, ln_g, ln_b, heads,
                     plain: bool = False):
    """The JAX signature without ``g_batch`` and ``interpret``: the kernels
    on a CUDA tensor, their plain versions on a CPU tensor or when
    ``plain``; differentiable."""
    return AttnBlockFn.apply(x.contiguous(), wqkv.contiguous(),
                             bqkv.contiguous(), wo.contiguous(),
                             bo.contiguous(), ln_g.contiguous(),
                             ln_b.contiguous(), heads, plain)


def fused_mlp_block(x, w1, b1, w2, b2, ln_g, ln_b, plain: bool = False):
    """As :func:`fused_attn_block`, for the MLP sub-layer."""
    return MlpBlockFn.apply(x.contiguous(), w1.contiguous(), b1.contiguous(),
                            w2.contiguous(), b2.contiguous(),
                            ln_g.contiguous(), ln_b.contiguous(), plain)


def work(kind: str, bsz: int, seq: int, d: int, heads: int = 1,
         hidden: int = 0) -> tuple[float, float]:
    """Floating-point operations that one sub-layer call needs (a
    multiply-add is two), counted from the shapes, as ``(products, other)``:
    the matrix products, and the rest (4 per score for the softmax: max,
    exp, sum, scale; the GELU and its derivative). A backward that keeps
    only the inputs must recompute the forward's products once; what the
    kernels compute beyond that is not counted (the attention backward's
    two passes recompute the scores three times and dp twice: 9 products
    of L x L x d where the function needs 6)."""
    rows = bsz * seq
    scores = bsz * heads * seq * seq
    if kind == "attn_fwd":
        return 2 * rows * d * 4 * d + 4 * rows * seq * d, 4 * scores
    if kind == "mlp_fwd":
        return 4 * rows * d * hidden, 10 * rows * hidden
    if kind == "attn_bwd":
        # qkv, do, dWo, dWqkv, dh products; scores and p.v recomputed, then
        # dV, dp, dQ, dK; the softmax recomputed (4 per score) and its
        # backward, ds = p (dp - D) scale (3 per score)
        return (2 * rows * d * (3 * d + d + d + 3 * d + 3 * d)
                + 2 * bsz * seq * seq * d * 6, 7 * scores)
    if kind == "mlp_bwd":
        return 2 * rows * d * hidden * 5, 20 * rows * hidden
    raise ValueError(kind)


def flops(kind: str, bsz: int, seq: int, d: int, heads: int = 1,
          hidden: int = 0) -> float:
    """All of :func:`work`'s operations, products and the rest."""
    return float(sum(work(kind, bsz, seq, d, heads, hidden)))
