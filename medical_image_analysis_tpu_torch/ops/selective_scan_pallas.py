"""The general selective scan (Mamba S6): CUDA kernels and their autograd.

Counterpart of ``medical_image_analysis_tpu/ops/selective_scan_pallas.py``
(``selective_scan_pallas``, ``selective_scan_dirs`` and the custom VJP
``_selective_scan_core`` around them); the module keeps the JAX module's
name so that a reader finds the counterpart.

- ``selective_scan_fwd`` (kernel ``selective_scan_fwd_kernel``, replacing
  the Pallas ``_fwd_kernel``): y in u's dtype.
- ``selective_scan_bwd`` (kernel ``selective_scan_bwd_kernel``, replacing
  ``_bwd_kernel``): du, ddelta, dA, dB, dC, dD, d delta_bias.

Both work on the kernels' folded layout: rows = batch x groups, and row r
takes the parameters of group ``r % G`` (A (G, Dc, N), D and delta_bias
(G, Dc), fp32), so that grouped B/C (:func:`selective_scan_pallas`) and K
directions with their own parameters (:func:`selective_scan_dirs`) run in
one launch. The kernels are in ``csrc/selective_scan.cu``, whose header
says what bounds them on the H100 and how their design answers that. The
TPU's chunk and block tiling (``chunk``, ``block_d``, ``interpret``,
``scan_impl``) has no counterpart here.

The kernels are built for d_state 1, 4, 8, 16 and 32 (:data:`STATES`); the
wrappers take any other: a d_state below 32 is padded up to the next built
width with zero states (A, B and C 0), whose gradients are dropped, and one
past 32 runs in groups of at most 32 states (:func:`state_groups`), whose
``y`` are added (the D skip in the first group alone); in the backward du,
ddelta and ddelta_bias add over the groups, and dA, dB and dC are each
group's own. The groups run the fp32 kernels (bf16 sources widen exactly)
and round their sums once. Like the JAX module, no d_state is refused.

Each wrapper launches its kernel on a CUDA tensor, or raises (dtype, shape,
layout, or a launch error), and runs its plain version
(``ops/selective_scan.py``: ``selective_scan_fwd_plain``,
``selective_scan_bwd_plain``) on a CPU tensor; there is no fallback between
the two. ``launches`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library
from .selective_scan import selective_scan_bwd_plain, selective_scan_fwd_plain

KERNEL_SOURCE = "medical_image_analysis_tpu_torch/csrc/selective_scan.cu"
launches = {"selective_scan_fwd": 0, "selective_scan_bwd": 0}

STATES = (1, 4, 8, 16, 32)  # the d_state widths the kernels are built for
_MAX_STATE = STATES[-1]  # states a launch takes; more run in groups
_THREADS = 64  # channels per block of the forward's scans and the backward
_CHUNK = 8  # rows per chunk of the backward kernel (its carries)
_FWD_BLOCKS = 12  # the forward's resident blocks an SM (its cap)
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build() -> tuple[ctypes.CDLL, str]:
    """Build (or reuse) the kernels' library; returns ``(lib, nvcc log)``."""
    lib, log = load_library("selective_scan")
    lib.mia_selective_scan_fwd.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _I, _P,
    ]
    lib.mia_selective_scan_fwd.restype = _I
    lib.mia_selective_scan_bwd.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _I, _P,
    ]
    lib.mia_selective_scan_bwd.restype = _I
    lib.mia_selective_scan_bwd_blocks_per_sm.argtypes = [
        _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.mia_selective_scan_bwd_blocks_per_sm.restype = _I
    lib.mia_selective_scan_fwd_blocks_per_sm.argtypes = [
        _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.mia_selective_scan_fwd_blocks_per_sm.restype = _I
    return lib, log


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _on_cpu(u):
    if u.device.type == "cpu":
        return True
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {u.device}")
    return False


def _check(u, delta, A, B, C, D, delta_bias, dy=None):
    """Raise on what the kernels do not take; returns (rows, L, Dc, N, G,
    strides of B and C)."""
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"selective_scan: u dtype {u.dtype} is not f32/bf16")
    if u.ndim != 3 or not u.is_contiguous():
        raise ValueError(f"selective_scan: u must be a contiguous (rows, L, D) "
                         f"tensor; got {tuple(u.shape)}")
    rows, seq_len, d_in = u.shape
    for name, t in (("delta", delta), ("dy", dy)):
        if t is not None and (t.shape != u.shape or t.dtype != u.dtype
                              or t.device != u.device
                              or not t.is_contiguous()):
            raise ValueError(f"selective_scan: {name} must match u (shape, "
                             f"dtype, device) and be contiguous")
    if A.ndim != 3 or A.shape[1] != d_in:
        raise ValueError(f"selective_scan: A must be (G, {d_in}, N); got "
                         f"{tuple(A.shape)}")
    groups, _, n = A.shape
    if n not in STATES:
        raise ValueError(f"selective_scan: a launch takes d_state in "
                         f"{STATES}, not {n} (state_groups pads and splits)")
    if rows % groups:
        raise ValueError(f"selective_scan: {rows} rows for {groups} groups")
    for name, t, shape in (("A", A, (groups, d_in, n)),
                           ("D", D, (groups, d_in)),
                           ("delta_bias", delta_bias, (groups, d_in))):
        if (t.dtype != torch.float32 or t.device != u.device
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"selective_scan: {name} must be a contiguous fp32 tensor of "
                f"shape {shape} on {u.device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    strides = []
    for name, t in (("B", B), ("C", C)):
        if (t.dtype != u.dtype or t.device != u.device
                or tuple(t.shape) != (rows, seq_len, n) or t.stride(2) != 1):
            raise ValueError(
                f"selective_scan: {name} must be a {u.dtype} tensor of shape "
                f"{(rows, seq_len, n)} on {u.device} with unit stride over "
                f"N; got {t.dtype} {tuple(t.shape)} strides {t.stride()}")
        strides += [t.stride(0), t.stride(1)]
    return rows, seq_len, d_in, n, groups, strides


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def fwd_grid_blocks(rows: int, d_in: int) -> int:
    """Blocks of the forward kernel's grid: ``_THREADS`` channels of one
    row a block."""
    return rows * -(-d_in // _THREADS)


def selective_scan_fwd(u, delta, A, B, C, D, delta_bias, delta_softplus=False):
    """The S6 scan on the folded layout: y (rows, L, Dc) in u's dtype.

    u, delta (rows, L, Dc) contiguous; B, C (rows, L, N) in u's dtype with
    unit stride over N (a slice of x_dbl is read in place); A (G, Dc, N),
    D and delta_bias (G, Dc) fp32, contiguous.

    One pass over L, a thread a (row, channel) with its N states: the
    decays by the special-function unit's exp2, the rows staged 4 at a
    time through 4 buffers, ``_FWD_BLOCKS`` blocks an SM
    (:func:`fwd_occupancy`; ``csrc/selective_scan.cu``, "the forward").
    No workspace and no atomics: two calls give the same bits.
    """
    if _on_cpu(u):
        return selective_scan_fwd_plain(u, delta, A, B, C, D, delta_bias,
                                        delta_softplus)
    n = A.shape[-1]
    if n in STATES:
        return _fwd_launch(u, delta, A, B, C, D, delta_bias, delta_softplus)
    if n <= _MAX_STATE:
        a, b, c, _ = _state_groups(A, B, C)[0]
        return _fwd_launch(u, delta, a, b, c, D, delta_bias, delta_softplus)
    # groups of states: the fp32 kernels on the (exactly widened) sources,
    # y added in fp32 and rounded once, as the plain version rounds it
    u32, dt32, b32, c32 = (x.float() for x in (u, delta, B, C))
    y = None
    for i, (a, b, c, _) in enumerate(_state_groups(A, b32, c32)):
        y_g = _fwd_launch(u32, dt32, a, b, c, D if i == 0 else
                          torch.zeros_like(D), delta_bias, delta_softplus)
        y = y_g if y is None else y + y_g
    return y.to(u.dtype)


def state_width(n: int) -> int:
    """The built width a group of ``n`` <= 32 states runs at: the next of
    :data:`STATES`."""
    for w in STATES:
        if n <= w:
            return w
    raise ValueError(f"selective_scan: a group holds at most {_MAX_STATE} "
                     f"states, not {n}")


def state_groups(n: int) -> list[tuple[int, int]]:
    """The state ranges ``[s0, s1)`` that launches take for d_state ``n``:
    32 at a time, the last range the rest (``n`` = 40: 0-32, 32-40)."""
    return [(s0, min(s0 + _MAX_STATE, n)) for s0 in range(0, n, _MAX_STATE)]


def _widen(x, w):
    """``x`` (..., k) with zero states appended up to ``w``; a slice of
    unit stride over its last axis as it is where ``k == w``."""
    k = x.shape[-1]
    if k == w:
        return x
    return torch.nn.functional.pad(x, (0, w - k))


def _state_groups(A, B, C):
    """(A, B, C) of each state group of :func:`state_groups`, widened to
    :func:`state_width` with zero states (A 0, B 0, C 0: a pad state stays
    0 and adds nothing to y), and the group's width before widening."""
    out = []
    for s0, s1 in state_groups(A.shape[-1]):
        w = state_width(s1 - s0)
        out.append((_widen(A[..., s0:s1], w).contiguous(),
                    _widen(B[..., s0:s1], w), _widen(C[..., s0:s1], w),
                    s1 - s0))
    return out


def _fwd_launch(u, delta, A, B, C, D, delta_bias, delta_softplus):
    """One launch of the forward kernel at a built width."""
    rows, seq_len, d_in, n, groups, st = _check(u, delta, A, B, C, D,
                                                delta_bias)
    y = torch.empty_like(u)
    lib, _ = build()
    err = lib.mia_selective_scan_fwd(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), y.data_ptr(),
        int(u.dtype == torch.bfloat16), rows, seq_len, d_in, n, groups, *st,
        int(delta_softplus), torch.cuda.current_stream(u.device).cuda_stream,
    )
    _raise_on(err, "selective_scan_fwd")
    launches["selective_scan_fwd"] += 1
    return y


def selective_scan_bwd(u, delta, A, B, C, D, delta_bias, dy,
                       delta_softplus=False):
    """Adjoint of :func:`selective_scan_fwd`; the outputs of
    ``selective_scan_bwd_plain``: du, ddelta in u's dtype; dA (G, Dc, N);
    dB, dC (rows, L, N) in B's dtype; dD, ddelta_bias (G, Dc) fp32. The
    kernel writes per-row sums of the parameter gradients and per-block
    sums of dB and dC; they are summed here in a fixed order.

    The kernel's walks over L are bound by latency, so it is built for
    occupancy (:func:`bwd_occupancy`: 6 blocks of ``_THREADS`` threads an
    SM at d_state 16): each thread keeps its channel's rows in registers
    and reads only its own column of the rebuilt states, and the sums over
    channels are warp shuffles. ``carries`` (rows, ceil(L / ``_CHUNK``),
    N, Dc) fp32, the states it writes at chunk starts, is freed on
    return."""
    if _on_cpu(u):
        return selective_scan_bwd_plain(u, delta, A, B, C, D, delta_bias, dy,
                                        delta_softplus)
    n = A.shape[-1]
    if n in STATES:
        return _bwd_launch(u, delta, A, B, C, D, delta_bias, dy,
                           delta_softplus)
    if n <= _MAX_STATE:  # the pad states' gradients dropped
        a, b, c, k = _state_groups(A, B, C)[0]
        g = _bwd_launch(u, delta, a, b, c, D, delta_bias, dy, delta_softplus)
        return (g[0], g[1], g[2][..., :k], g[3][..., :k], g[4][..., :k],
                g[5], g[6])
    # per group (the fp32 kernels, as the forward): dA, dB and dC its own
    # states; du, ddelta and ddelta_bias summed over the groups; dD from
    # the group that adds the D skip
    u32, dt32, b32, c32, dy32 = (x.float() for x in (u, delta, B, C, dy))
    du = ddelta = ddb = None
    d_a, d_b, d_c = [], [], []
    for i, (a, b, c, k) in enumerate(_state_groups(A, b32, c32)):
        g = _bwd_launch(u32, dt32, a, b, c, D if i == 0 else
                        torch.zeros_like(D), delta_bias, dy32, delta_softplus)
        if i == 0:
            du, ddelta, d_d, ddb = g[0], g[1], g[5], g[6]
        else:
            du, ddelta, ddb = du + g[0], ddelta + g[1], ddb + g[6]
        d_a.append(g[2][..., :k])
        d_b.append(g[3][..., :k])
        d_c.append(g[4][..., :k])
    return (du.to(u.dtype), ddelta.to(u.dtype), torch.cat(d_a, -1),
            torch.cat(d_b, -1).to(B.dtype), torch.cat(d_c, -1).to(C.dtype),
            d_d, ddb)


def _bwd_launch(u, delta, A, B, C, D, delta_bias, dy, delta_softplus):
    """One launch of the backward kernel at a built width."""
    rows, seq_len, d_in, n, groups, st = _check(u, delta, A, B, C, D,
                                                delta_bias, dy)
    nblk = -(-d_in // _THREADS)

    def f32(*shape):
        return torch.empty(*shape, device=u.device, dtype=torch.float32)

    carries = f32(rows, -(-seq_len // _CHUNK), n, d_in)
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    d_b, d_c = f32(nblk, rows, seq_len, n), f32(nblk, rows, seq_len, n)
    d_a, d_d, ddb = f32(rows, d_in, n), f32(rows, d_in), f32(rows, d_in)
    lib, _ = build()
    err = lib.mia_selective_scan_bwd(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), dy.data_ptr(),
        carries.data_ptr(), du.data_ptr(), ddelta.data_ptr(), d_b.data_ptr(),
        d_c.data_ptr(), d_a.data_ptr(), d_d.data_ptr(), ddb.data_ptr(),
        int(u.dtype == torch.bfloat16), rows, seq_len, d_in, n, groups, *st,
        int(delta_softplus), torch.cuda.current_stream(u.device).cuda_stream,
    )
    _raise_on(err, "selective_scan_bwd")
    launches["selective_scan_bwd"] += 1
    del carries

    def per_group(x):
        return x.reshape(rows // groups, groups, *x.shape[1:]).sum(dim=0)

    return (du, ddelta, per_group(d_a), d_b.sum(dim=0).to(B.dtype),
            d_c.sum(dim=0).to(C.dtype), per_group(d_d), per_group(ddb))


def bwd_occupancy(n: int, dtype: torch.dtype) -> tuple[int, int]:
    """The backward kernel's resident blocks an SM on the current card, and
    its shared memory a block in bytes, for d_state ``n`` and source dtype
    ``dtype`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = state_width(min(n, _MAX_STATE))
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"selective_scan: no backward kernel for {dtype}")
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    lib, _ = build()
    err = lib.mia_selective_scan_bwd_blocks_per_sm(
        n, int(dtype == torch.bfloat16), ctypes.byref(blocks),
        ctypes.byref(smem))
    _raise_on(err, "selective_scan_bwd occupancy")
    return blocks.value, smem.value


def fwd_occupancy(n: int, dtype: torch.dtype) -> tuple[int, int]:
    """The forward kernel's resident blocks an SM on the current card, and
    its shared memory a block in bytes, for d_state ``n`` and source dtype
    ``dtype`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = state_width(min(n, _MAX_STATE))
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"selective_scan: no forward kernel for {dtype}")
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    lib, _ = build()
    err = lib.mia_selective_scan_fwd_blocks_per_sm(
        n, int(dtype == torch.bfloat16), ctypes.byref(blocks),
        ctypes.byref(smem))
    _raise_on(err, "selective_scan_fwd occupancy")
    return blocks.value, smem.value


class SelectiveScanFn(torch.autograd.Function):
    """The folded scan with its backward, as the JAX package's
    ``_selective_scan_core`` custom VJP: ``selective_scan_fwd`` /
    ``selective_scan_bwd`` (or their plain versions when ``plain``). It
    saves its inputs; the kernels are deterministic, so a checkpointed
    block may run it again."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, delta_softplus, plain):
        fwd = selective_scan_fwd_plain if plain else selective_scan_fwd
        y = fwd(u, delta, A, B, C, D, delta_bias, delta_softplus)
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias)
        ctx.flags = (delta_softplus, plain)
        return y

    @staticmethod
    def backward(ctx, dy):
        u, delta, A, B, C, D, delta_bias = ctx.saved_tensors
        delta_softplus, plain = ctx.flags
        bwd = selective_scan_bwd_plain if plain else selective_scan_bwd
        grads = bwd(u, delta, A, B, C, D, delta_bias,
                    dy.to(u.dtype).contiguous(), delta_softplus)
        return (*grads, None, None)


def _vec(x, groups, d, device):
    """A (G * d,) or (G, d) parameter, or None, as (G, d) fp32."""
    if x is None:
        return torch.zeros(groups, d, device=device)
    return x.float().reshape(groups, d).contiguous()


def selective_scan_pallas(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor | None = None,
    delta_bias: torch.Tensor | None = None,
    delta_softplus: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """Selective scan through the kernels, with ``selective_scan_ref``'s
    signature, differentiable.

    u, delta (batch, L, D); A (D, N); B, C (batch, L, N), or (batch, L, G,
    N) with G dividing D: the groups fold into the rows (one launch covers
    them) and channel block g of D takes group g of B and C. ``plain``
    runs the plain versions, forward and backward, on any device (for
    comparisons). Returns y (batch, L, D) in u's dtype.
    """
    batch, seq_len, d_total = u.shape
    n = A.shape[1]
    groups = 1 if B.ndim == 3 else B.shape[2]
    dg = d_total // groups
    a_g = A.float().reshape(groups, dg, n).contiguous()
    d_g = _vec(D, groups, dg, u.device)
    db_g = _vec(delta_bias, groups, dg, u.device)
    if groups == 1:
        y = SelectiveScanFn.apply(u.contiguous(), delta.contiguous(), a_g, B,
                                  C, d_g, db_g, delta_softplus, plain)
        return y

    def fold(x, width):  # (batch, L, G, width) -> (batch * G, L, width)
        x = x.reshape(batch, seq_len, groups, width).transpose(1, 2)
        return x.reshape(batch * groups, seq_len, width)

    y = SelectiveScanFn.apply(fold(u, dg), fold(delta, dg), a_g, fold(B, n),
                              fold(C, n), d_g, db_g, delta_softplus, plain)
    y = y.reshape(batch, groups, seq_len, dg).transpose(1, 2)
    return y.reshape(batch, seq_len, d_total)


def selective_scan_dirs(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor | None = None,
    delta_bias: torch.Tensor | None = None,
    delta_softplus: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """K directions with their own inputs and parameters in one launch, the
    direction folded into the rows.

    u, delta (batch, K, L, D); A (K, D, N); B, C (batch, K, L, N) (slices
    of a (batch, K, L, R+2N) x_dbl are read in place); D, delta_bias
    (K, D). Returns y (batch, K, L, D) in u's dtype, each direction in its
    own scan order.
    """
    batch, k, seq_len, d = u.shape
    n = A.shape[-1]
    y = SelectiveScanFn.apply(
        u.reshape(batch * k, seq_len, d).contiguous(),
        delta.reshape(batch * k, seq_len, d).contiguous(),
        A.float().contiguous(), B.reshape(batch * k, seq_len, n),
        C.reshape(batch * k, seq_len, n), _vec(D, k, d, u.device),
        _vec(delta_bias, k, d, u.device), delta_softplus, plain)
    return y.reshape(batch, k, seq_len, d)


# --------------------------------------------------------------------------
# Work counts for the bound
# --------------------------------------------------------------------------


def flops(kind: str, rows: int, seq_len: int, d: int, n: int) -> float:
    """Operations that one call needs, counted per (row, step, channel), a
    multiply-add two and an exp, a softplus or a sigmoid one. Forward: the
    bias and softplus 2, dt*u 1, per state the decay exp(dt*A) 2, the
    update 3 and the readout 2, the D skip 2. A backward that keeps only
    the inputs must rebuild the states once (the forward without its
    readout and D skip) and run the adjoint: the sigmoid 1, per state P 2,
    dloga 2, dA 2, ddt 2, the B sum 2, the next P 1 and the dB and dC sums
    4, then du and ddelta 5. What the kernel computes beyond that is not
    counted: its first walk, which writes the carries, and the decay it
    takes again in the adjoint."""
    if kind == "fwd":
        return float(rows) * seq_len * d * (7 * n + 5)
    return float(rows) * seq_len * d * ((5 * n + 3) + 1 + 15 * n + 5)
