"""Fused multi-direction Mamba layer: CUDA kernels and their plain versions.

Counterpart of ``medical_image_analysis_tpu/ops/mamba_fused.py``
(``mamba_fused_dirs`` and its custom VJP). The forward runs in two
launches:

- ``xdbl_fwd``: per direction, ``x_dbl = silu(conv(x_dir) + b) @ Wx^T``
  in fp32 (kernel ``mamba_xdbl_kernel``, replacing the Pallas
  ``_xdbl_kernel``): a product on the tensor cores in 3xTF32 over tiles
  of :func:`xdbl_tile`'s rows of one image's source, both directions that
  read the source a block (or one, where the grid would leave SMs idle),
  with the conv + SiLU computed as the operand is staged. Where even one
  direction a block leaves SMs idle (ARM-B up to 12 images) D is split
  over blocks, and ``mamba_xdbl_sum_kernel`` adds their partials in a
  fixed order (one launch count a call).
- ``scan_fwd``: conv + SiLU again, ``dt = softplus(x_dbl[:, :R] @ W_dt +
  bias)``, the S6 scan with fp32 state and ``y = C.h + D.u`` written in
  SOURCE order in the source dtype (replacing the Pallas
  ``_fused_fwd_kernel``). A scan over chunks of :func:`fwd_chunk` scan
  rows: where ``B*K*ceil(D/32)`` blocks give every SM a block (vssm_tiny,
  ARM-B from 2 images on) the chunk is all of L and ``mamba_scan_kernel``
  runs alone from a zero state; else (an ARM-B layer serving one image)
  the scan runs in parallel over L: ``mamba_scan_sums_kernel`` and
  ``mamba_scan_carry_kernel``, the bodies of the backward's first two
  kernels without the adjoint, give the state entering each chunk, and
  ``mamba_scan_kernel`` walks every chunk from it (one launch count a
  call).

The backward (:class:`MambaFusedFn`) runs ``scan_bwd``, the scan's
adjoint (kernels ``mamba_scan_bwd_sums_kernel``,
``mamba_scan_bwd_carry_kernel`` and ``mamba_scan_bwd_grad_kernel``,
together replacing the Pallas ``_fused_bwd_kernel``) as a scan over chunks
of ``_BWD_CHUNK`` scan rows that runs in parallel over L, and closes the
x_proj and conv transposes in plain PyTorch (:func:`_close_bwd`), as the
JAX package leaves them to XLA. ``scan_bwd_carries`` runs its first two
kernels alone, for tests of the state and adjoint entering every chunk
(:func:`mamba_carries_plain` on the CPU).

The kernels are in ``csrc/mamba_fused.cu``, whose header says what bounds
each on the H100 and how its design answers that. Directions are
[row, row-rev, col, col-rev]: direction k reads ``xc`` when k >= 2 and
scans it back to front when k is odd.

The scan kernels are built for d_state 4, 16, 17 and 32
(``_STATE_WIDTHS``; 17 is MambaPEFT's ``additional_scan`` width on 16) and
the kernels' conv for 1 to 4 taps. Every N from 1 to 32 runs through them:
:func:`state_width` names the width a call runs at, and the scan wrappers
pad x_dbl's B and C columns and A with zero states up to it and drop the
padded states' gradients (all 0); each wrapper raises past 32 states or 4
taps. :func:`mamba_fused_dirs` takes any d_state and any number of taps,
as the JAX function does: past 32 states it runs groups of at most 32 and
adds their y, and past 4 taps it runs the conv + SiLU in PyTorch ahead of
the kernels' no-conv mode (:func:`_wide_dirs`).

Each wrapper runs its kernel on a CUDA tensor and its plain version
(``xdbl_plain``, ``scan_plain``, ``scan_bwd_plain``) on a CPU tensor;
there is no fallback between the two. ``launches`` counts calls of a
wrapper that launched its kernels (the backward's three count once).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import load_library
from .selective_scan import softplus

KERNEL_SOURCE = "medical_image_analysis_tpu_torch/csrc/mamba_fused.cu"
launches = {"mamba_xdbl": 0, "mamba_scan": 0, "mamba_scan_bwd": 0}

# d_state widths the scan kernels are built for (csrc/mamba_fused.cu's
# MIA_DISPATCH): 17 is additional_scan's default width on 16; any other N
# up to _MAX_STATE runs at the next of them (state_width), its extra states
# zero in A, B and C. A launch takes at most _MAX_STATE states and
# _MAX_TAPS taps; mamba_fused_dirs runs wider layers in pieces.
_STATE_WIDTHS = (4, 16, 17, 32)
_MAX_STATE = 32
_MAX_TAPS = 4
# x_dbl's tiles: source rows a tile (xdbl_rows: 64 MW for MW = 1, 2), the
# n8 tiles of C a warp takes that the kernel is built for at 64 rows
# (kXdblTiles; 128 rows take the first), the kernel's resident blocks an
# SM by its __launch_bounds__ (kXdblBlocks), and its slices of D.
_XDBL_ROWS = (64, 128)
_XDBL_TILES = (5, 6, 7, 10)
_XDBL_BLOCKS = 2
_XDBL_SLICE = 32  # D a slice of the kernel's walk (kXdblSlice)
_BWD_THREADS = 64  # threads a block of the backward's sums and grad kernels
_BWD_LANES = 2  # lanes of a channel there, d_state / _BWD_LANES states each
_BWD_CHANNELS = _BWD_THREADS // _BWD_LANES  # channels a block (dxdbl part)
_BWD_CHUNK = 64  # scan rows a chunk of the backward (a slot of its workspace)
_CARRY_THREADS = 128  # chains a block of the backward's carry kernel
# Scan rows a chunk of the forward when fwd_chunk cuts L (kFwdCut: the
# fastest of 8, 16, 32 and 64 at ARM-B, B=1, on an H100; PERF.md), the
# scan kernel's resident blocks an SM by its __launch_bounds__, and the
# SMs of an H100 (the default card of fwd_chunk's choice).
_FWD_CUT = 16
_FWD_BLOCKS = 8
_H100_SMS = 132
# The forward's kernels in the order of mia_mamba_scan_blocks_per_sm's
# index: chunk summaries, carries, scan.
FWD_KERNELS = ("mamba_scan_sums_kernel", "mamba_scan_carry_kernel",
               "mamba_scan_kernel")
# The backward's kernels in the order of mia_mamba_scan_bwd_blocks_per_sm's
# index: chunk summaries, carries, gradients.
BWD_KERNELS = ("mamba_scan_bwd_sums_kernel", "mamba_scan_bwd_carry_kernel",
               "mamba_scan_bwd_grad_kernel")
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build() -> tuple[ctypes.CDLL, str]:
    """Build (or reuse) the kernels' library; returns ``(lib, nvcc log)``."""
    lib, log = load_library("mamba_fused")
    lib.mia_mamba_xdbl.argtypes = [
        _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _P,
    ]
    lib.mia_mamba_xdbl.restype = _I
    lib.mia_mamba_xdbl_blocks_per_sm.argtypes = [
        _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.mia_mamba_xdbl_blocks_per_sm.restype = _I
    lib.mia_mamba_scan.argtypes = [
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ]
    lib.mia_mamba_scan.restype = _I
    lib.mia_mamba_scan_blocks_per_sm.argtypes = [
        _I, _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.mia_mamba_scan_blocks_per_sm.restype = _I
    lib.mia_mamba_scan_bwd.argtypes = [
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ]
    lib.mia_mamba_scan_bwd.restype = _I
    lib.mia_mamba_scan_bwd_carries.argtypes = [
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ]
    lib.mia_mamba_scan_bwd_carries.restype = _I
    lib.mia_mamba_scan_bwd_blocks_per_sm.argtypes = [
        _I, _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.mia_mamba_scan_bwd_blocks_per_sm.restype = _I
    return lib, log


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' compute dtype for sources of ``dtype``: fp32,
    or fp64 for fp64 sources (a float64 yardstick of the fp32 paths; the
    kernels take fp32 and bf16 only)."""
    return torch.promote_types(dtype, torch.float32)


def _scan_order(xr, xc, k_dirs):
    """(B, K, L, D) sources in each direction's scan order, in
    :func:`compute_dtype`."""
    seqs = []
    for k in range(k_dirs):
        src = xc if xc is not None and k >= 2 else xr
        seqs.append(src.flip(1) if k % 2 else src)
    return torch.stack(seqs, dim=1).to(compute_dtype(xr.dtype))


def _conv_silu(x, conv_w, conv_b):
    """Causal depthwise conv + bias + SiLU over (B, K, L, D), fp32."""
    taps, seq_len = conv_w.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, taps - 1, 0))
    acc = torch.zeros_like(x)
    for j in range(taps):
        acc = acc + conv_w[None, :, j, None, :] * xp[:, :, j : j + seq_len]
    acc = acc + conv_b[None, :, None, :]
    return acc * torch.sigmoid(acc)


def _u(xr, xc, conv_w, conv_b, k_dirs, use_conv):
    x = _scan_order(xr, xc, k_dirs)
    return _conv_silu(x, conv_w, conv_b) if use_conv else x


def xdbl_plain(xr, xc, conv_w, conv_b, x_proj_w, use_conv=True):
    """Plain version of ``xdbl_fwd``: (B*K, L, R+2N) fp32, scan order."""
    k_dirs = x_proj_w.shape[0]
    u = _u(xr, xc, conv_w, conv_b, k_dirs, use_conv)
    b, _, seq_len, _ = u.shape
    x_dbl = torch.einsum("bkld,kcd->bklc", u, x_proj_w)
    return x_dbl.reshape(b * k_dirs, seq_len, -1)


def scan_plain(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A, D,
               delta_softplus=True, use_conv=True):
    """Plain version of ``scan_fwd``: (B, K, L, D) in source order."""
    k_dirs, d_in, n = A.shape
    rank = dt_proj_w.shape[2]
    u = _u(xr, xc, conv_w, conv_b, k_dirs, use_conv)
    b, _, seq_len, _ = u.shape
    x_dbl = xdbl.reshape(b, k_dirs, seq_len, -1)
    dt = torch.einsum("bklr,kdr->bkld", x_dbl[..., :rank], dt_proj_w)
    dt = dt + dt_bias[None, :, None, :]
    if delta_softplus:
        dt = softplus(dt)
    bmat = x_dbl[..., rank : rank + n]
    cmat = x_dbl[..., rank + n : rank + 2 * n]
    h = u.new_zeros(b, k_dirs, d_in, n)
    ys = []
    for t in range(seq_len):
        a = torch.exp(dt[:, :, t, :, None] * A[None])
        h = a * h + (dt[:, :, t] * u[:, :, t])[..., None] * bmat[:, :, t, None, :]
        ys.append(torch.sum(cmat[:, :, t, None, :] * h, dim=-1))
    y = torch.stack(ys, dim=2) + u * D[None, :, None, :]
    return _flip_reversed(y).to(xr.dtype)


def _flip_reversed(t):
    """(B, K, L, ...) scan order <-> source order (odd directions flip)."""
    return torch.cat([t[:, k : k + 1].flip(2) if k % 2 else t[:, k : k + 1]
                      for k in range(t.shape[1])], dim=1)


def _bwd_rows(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A, dy,
              delta_softplus, use_conv):
    """The backward's per-row terms in scan order, fp32, each (B, K, L,
    ...): u, silu'(pre), dt, softplus'(dt_raw), x_dbl, B, C and dy."""
    k_dirs, _, n = A.shape
    rank = dt_proj_w.shape[2]
    x = _scan_order(xr, xc, k_dirs)
    b, _, seq_len, _ = x.shape
    if use_conv:
        taps = conv_w.shape[1]
        xp = F.pad(x, (0, 0, taps - 1, 0))
        pre = conv_b[None, :, None, :].expand_as(x)
        for j in range(taps):
            pre = pre + conv_w[None, :, j, None, :] * xp[:, :, j : j + seq_len]
        sig = torch.sigmoid(pre)
        u = pre * sig
        dsilu = sig * (1.0 + pre * (1.0 - sig))
    else:
        u, dsilu = x, torch.ones_like(x)
    x_dbl = xdbl.reshape(b, k_dirs, seq_len, -1)
    dt_raw = torch.einsum("bklr,kdr->bkld", x_dbl[..., :rank], dt_proj_w)
    dt_raw = dt_raw + dt_bias[None, :, None, :]
    if delta_softplus:
        dt, sg = softplus(dt_raw), torch.sigmoid(dt_raw)
    else:
        dt, sg = dt_raw, torch.ones_like(dt_raw)
    bmat = x_dbl[..., rank : rank + n]
    cmat = x_dbl[..., rank + n : rank + 2 * n]
    return u, dsilu, dt, sg, x_dbl, bmat, cmat, _flip_reversed(dy.to(u.dtype))


def _walk_states(A, dt, dtu, bmat):
    """The forward walk: hs[t] is the state after scan row t, (B, K, D, N)."""
    h = dt.new_zeros(*dt.shape[:2], dt.shape[3], A.shape[2])
    hs = []
    for t in range(dt.shape[2]):
        a = torch.exp(dt[:, :, t, :, None] * A[None])
        h = a * h + dtu[:, :, t, :, None] * bmat[:, :, t, None, :]
        hs.append(h)
    return hs


def scan_bwd_plain(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A, D,
                   dy, delta_softplus=True, use_conv=True):
    """Plain version of ``scan_bwd``: the adjoint of ``scan_plain`` as an
    explicit reverse loop over L (the body of ``_fused_bwd_kernel``).

    Returns fp32 ``(du, u, dsilu, dxdbl, dA, dD, ddt_bias, ddt_proj_w)``:
    du, u, dsilu (B*K, L, D) and dxdbl (B*K, L, R+2N) in scan order; dA
    (B*K, D, N); dD, ddt_bias (B*K, D); ddt_proj_w (B*K, D, R). du is the
    gradient w.r.t. u = silu(conv(x)) through the scan and the D skip only;
    the x_proj path reaches u through dxdbl.
    """
    k_dirs = A.shape[0]
    rank = dt_proj_w.shape[2]
    u, dsilu, dt, sg, x_dbl, bmat, cmat, dy = _bwd_rows(
        xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A, dy,
        delta_softplus, use_conv)
    b, _, seq_len, _ = u.shape
    dtu = dt * u
    hs = _walk_states(A, dt, dtu, bmat)  # hs[t]: the state after row t

    g = torch.zeros_like(hs[0])
    d_a = torch.zeros_like(g)
    du, ddt, dbm, dcm = [], [], [], []
    for t in range(seq_len - 1, -1, -1):
        dyt = dy[:, :, t]
        p = cmat[:, :, t, None, :] * dyt[..., None] + g
        h_prev = hs[t - 1] if t > 0 else torch.zeros_like(g)
        a = torch.exp(dt[:, :, t, :, None] * A[None])
        dloga = p * h_prev * a
        d_a = d_a + dloga * dt[:, :, t, :, None]
        gb = torch.sum(p * bmat[:, :, t, None, :], dim=-1)
        ddt_t = (torch.sum(dloga * A[None], dim=-1) + gb * u[:, :, t])
        ddt.append(ddt_t * sg[:, :, t])
        du.append(dt[:, :, t] * gb + dyt * D[None])
        dbm.append(torch.sum(p * dtu[:, :, t, :, None], dim=2))
        dcm.append(torch.sum(hs[t] * dyt[..., None], dim=2))
        g = a * p

    def seq(rows):  # reversed list of (B, K, ...) -> (B, K, L, ...)
        return torch.stack(rows[::-1], dim=2)

    ddt = seq(ddt)
    dxdbl = torch.cat([
        torch.einsum("bkld,kdr->bklr", ddt, dt_proj_w), seq(dbm), seq(dcm),
    ], dim=-1)
    ddtw = torch.einsum("bkld,bklr->bkdr", ddt, x_dbl[..., :rank])

    def rows(t):
        return t.reshape(b * k_dirs, *t.shape[2:])

    return (rows(seq(du)), rows(u), rows(dsilu), rows(dxdbl), rows(d_a),
            rows(torch.sum(dy * u, dim=2)), rows(torch.sum(ddt, dim=2)),
            rows(ddtw))


def mamba_carries_plain(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A,
                        D, dy, delta_softplus=True, use_conv=True,
                        chunk=_BWD_CHUNK):
    """Plain version of ``scan_bwd_carries``, from the sequential walks of
    ``scan_bwd_plain``. Each direction's scan rows are cut into chunks of
    ``chunk`` rows (the last one ragged); for every chunk, the state
    entering its first row, and the adjoint entering its last row from the
    rows after it (the adjoint that leaves the next chunk's first row; 0
    for the last chunk). Returns fp32 ``(h_in, g_in)``, each (B*K,
    nchunks, N, D). ``D`` is unused: the states and adjoints do not depend
    on the skip."""
    del D
    k_dirs, d_in, n = A.shape
    u, _, dt, _, _, bmat, cmat, dy = _bwd_rows(
        xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A, dy,
        delta_softplus, use_conv)
    b, _, seq_len, _ = u.shape
    hs = _walk_states(A, dt, dt * u, bmat)
    g = torch.zeros_like(hs[0])
    g_enter = [g] * seq_len  # the adjoint entering row t from row t + 1
    for t in range(seq_len - 1, -1, -1):
        g_enter[t] = g
        p = cmat[:, :, t, None, :] * dy[:, :, t, :, None] + g
        g = torch.exp(dt[:, :, t, :, None] * A[None]) * p
    starts = range(0, seq_len, chunk)
    h_in = torch.stack([hs[t0 - 1] if t0 else torch.zeros_like(g)
                        for t0 in starts], dim=2)
    g_in = torch.stack([g_enter[min(t0 + chunk, seq_len) - 1]
                        for t0 in starts], dim=2)

    def slots(x):  # (B, K, nchunks, D, N) -> (B*K, nchunks, N, D)
        return x.transpose(3, 4).reshape(b * k_dirs, len(starts), n, d_in)

    return slots(h_in), slots(g_in)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def state_groups(n: int) -> list[tuple[int, int]]:
    """The state ranges ``[s0, s1)`` that :func:`mamba_fused_dirs` runs
    d_state ``n`` in: 32 at a time, the last range the rest."""
    return [(s0, min(s0 + _MAX_STATE, n)) for s0 in range(0, n, _MAX_STATE)]


def state_width(n: int) -> int:
    """The d_state the scan kernels run d_state ``n`` at: ``n`` where they
    are built for it (``_STATE_WIDTHS``), else the next width they are
    built for. Raises outside 1 to ``_MAX_STATE``."""
    if not 1 <= n <= _MAX_STATE:
        raise ValueError(f"mamba_fused: d_state={n} unsupported "
                         f"(1 <= d_state <= {_MAX_STATE})")
    return next(w for w in _STATE_WIDTHS if w >= n)


def widen_states(t, rank: int, n: int, width: int):
    """x_dbl's columns ``[dt | B | C]`` at d_state ``n`` -> ``width``: B
    and C each followed by ``width - n`` zeros. A padded state has B = C =
    0, so its h stays 0 and adds nothing to y, whatever its A."""
    if width == n:
        return t
    dt, bm, cm = torch.split(t, [rank, n, n], dim=-1)
    z = t.new_zeros(*t.shape[:-1], width - n)
    return torch.cat([dt, bm, z, cm, z], dim=-1)


def narrow_states(t, rank: int, n: int, width: int):
    """The inverse of :func:`widen_states`: the padded states' columns
    dropped (their gradients are 0)."""
    if width == n:
        return t
    return torch.cat([t[..., : rank + n],
                      t[..., rank + width : rank + width + n]], dim=-1)


def _pad_a(A, width: int):
    """A (K, D, N) -> (K, D, width), the padded states' A 0."""
    return A if A.shape[-1] == width else F.pad(A, (0, width - A.shape[-1]))


def _check_widths(name: str, n: int, taps: int) -> None:
    if not 1 <= n <= _MAX_STATE or not 1 <= taps <= _MAX_TAPS:
        raise ValueError(f"{name}: d_state={n}, taps={taps} unsupported "
                         f"(1 <= d_state <= {_MAX_STATE}, taps <= {_MAX_TAPS})")


def _on_cpu(xr):
    if xr.device.type == "cpu":
        return True
    if xr.device.type != "cuda":
        raise ValueError(f"mamba_fused: unsupported device {xr.device}")
    return False


def _check_sources(xr, xc, k_dirs, d_in):
    if xr.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mamba_fused: source dtype {xr.dtype} is not f32/bf16")
    if xr.ndim != 3 or xr.shape[2] != d_in or not xr.is_contiguous():
        raise ValueError(f"mamba_fused: xr must be a contiguous (B, L, {d_in}) "
                         f"tensor; got {tuple(xr.shape)}")
    if k_dirs not in (1, 2, 4):
        raise ValueError(f"mamba_fused: K={k_dirs} directions, expected 1, 2 or 4")
    if (xc is not None) != (k_dirs == 4):
        raise ValueError("mamba_fused: xc is required for K=4 and only then")
    if xc is not None and (
        xc.shape != xr.shape or xc.dtype != xr.dtype
        or xc.device != xr.device or not xc.is_contiguous()
    ):
        raise ValueError("mamba_fused: xc must match xr (shape, dtype, "
                         "device) and be contiguous")


def _check_f32(device, **tensors):
    for name, (t, shape) in tensors.items():
        if (t.dtype != torch.float32 or t.device != device
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"mamba_fused: {name} must be a contiguous fp32 tensor of "
                f"shape {shape} on {device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def xdbl_fwd(xr, xc, conv_w, conv_b, x_proj_w, use_conv=True):
    """``x_dbl`` for every direction: (B*K, L, R+2N) fp32, scan order.

    conv_w (K, taps, D), conv_b (K, D) and x_proj_w (K, R+2N, D) are fp32.
    The kernel's tile is :func:`xdbl_tile`'s choice for the card.
    """
    if _on_cpu(xr):
        return xdbl_plain(xr, xc, conv_w, conv_b, x_proj_w, use_conv)
    k_dirs, c, d_in = x_proj_w.shape
    _check_sources(xr, xc, k_dirs, d_in)
    b, seq_len, _ = xr.shape
    taps = conv_w.shape[1]
    if not 1 <= taps <= _MAX_TAPS:
        raise ValueError(f"mamba_xdbl: taps={taps} unsupported "
                         f"(taps <= {_MAX_TAPS})")
    _check_f32(
        xr.device, conv_w=(conv_w, (k_dirs, taps, d_in)),
        conv_b=(conv_b, (k_dirs, d_in)), x_proj_w=(x_proj_w, (k_dirs, c, d_in)),
    )
    out = torch.empty(b * k_dirs, seq_len, c, device=xr.device,
                      dtype=torch.float32)
    sms = torch.cuda.get_device_properties(xr.device).multi_processor_count
    rows, dirs, splits = xdbl_tile(b, k_dirs, seq_len, d_in, c, sms)
    # the partial sums of the ranges of D, added up by the second kernel
    part = None if splits == 1 else torch.empty(
        splits, *out.shape, device=xr.device, dtype=torch.float32)
    lib, _ = build()
    err = lib.mia_mamba_xdbl(
        xr.data_ptr(), None if xc is None else xc.data_ptr(),
        int(xr.dtype == torch.bfloat16), conv_w.data_ptr(), conv_b.data_ptr(),
        x_proj_w.data_ptr(), None if part is None else part.data_ptr(),
        out.data_ptr(), b, k_dirs, seq_len, d_in, c, taps, int(use_conv),
        rows, xdbl_nt(rows, dirs, c), dirs, splits,
        torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(err, "mamba_xdbl")
    launches["mamba_xdbl"] += 1
    return out


def xdbl_nt(rows: int, dirs: int, c: int) -> int:
    """n8 tiles of C a warp of ``mamba_xdbl_kernel`` takes, the kernel's
    instantiation for a call: the fewest of those it is built for
    (``kXdblTiles``; at 128 rows only the first) that hold a warp's share
    of C, else the most (more columns take more blocks along z). With one
    direction a block, its two halves of warps split C."""
    if rows == _XDBL_ROWS[1]:
        return _XDBL_TILES[0]
    halves = 2 if dirs == 1 else 1
    tiles = -(-c // 8)
    need = -(-tiles // halves)
    return next((t for t in _XDBL_TILES if need <= t), _XDBL_TILES[-1])


def xdbl_block_cols(rows: int, dirs: int, c: int) -> int:
    """Columns of C a block of ``mamba_xdbl_kernel`` takes (zeros past C):
    ``xdbl_nt``'s n8 tiles, twice with one direction a block."""
    return 8 * xdbl_nt(rows, dirs, c) * (2 if dirs == 1 else 1)


def xdbl_grid_blocks(b: int, k_dirs: int, seq_len: int, c: int, rows: int,
                     dirs: int, splits: int = 1) -> int:
    """Blocks of ``mamba_xdbl_kernel``'s grid for (B, K, L, C) in tiles of
    ``rows`` source rows, ``dirs`` directions a block and ``splits`` ranges
    of D: a tile of one image's source, ``dirs`` of its directions,
    ``xdbl_block_cols`` columns of C and one range of D."""
    cols = xdbl_block_cols(rows, dirs, c)
    return (-(-seq_len // rows) * b * (k_dirs // dirs) * -(-c // cols)
            * splits)


def xdbl_tile(b: int, k_dirs: int, seq_len: int, d_in: int, c: int,
              sms: int = _H100_SMS) -> tuple[int, int, int]:
    """``(rows, dirs, splits)`` of ``xdbl_fwd``'s kernel for (B, K, L, D, C)
    on a card of ``sms`` SMs: source rows a tile, directions a block and
    ranges of D a tile, in that order of decision.

    - Directions: both of a source a block (where K > 1), which stages its
      rows once for two products, unless that grid of 64-row tiles leaves
      SMs idle (ARM-B, vssm_tiny stage 3 at its validation's 64 images),
      or such a block cannot hold all of C (ARM-L's C=96: two blocks of
      columns would stage the rows twice all the same, and compute 160
      columns for 96).
    - Ranges of D: while the grid holds fewer blocks than three quarters
      of the card's ``_XDBL_BLOCKS`` an SM, doubled, each keeping 3 of its
      32-wide slices or more; their partials are summed by a second kernel.
    - Rows: 128 where a 128-row block holds all of C (40 columns with two
      directions, 80 with one), takes fewer tiles of L than 64 rows do, and
      its grid, with its ranges of D, reaches three quarters of
      ``_XDBL_BLOCKS`` an SM (vssm_tiny stage 0; ARM-B from 4 images);
      else 64 (ARM-B at one image, where 128 rows leave the card short).

    On an H100 the pick was the fastest of the tiles swept (64 and 128 rows,
    one and two directions, 1, 2, 4 and 8 ranges) at every main-path shape
    but vssm_tiny stage 3 at 64 images, where 64x2x2 was 2% faster; at
    ARM-L's 12 images 64x1x2 took 0.099 ms where 64x2x2 took 0.187
    (``tools/time_xdbl.py --sweep``)."""
    full = 3 * _XDBL_BLOCKS * sms  # four times the grid that fills the card
    dirs = 1 if k_dirs == 1 else 2
    if dirs == 2 and (xdbl_grid_blocks(b, k_dirs, seq_len, c, 64, 2) < sms
                      or xdbl_block_cols(64, 2, c) < c):
        dirs = 1
    slices = -(-d_in // _XDBL_SLICE)

    def split(rows):
        splits = 1
        while (4 * xdbl_grid_blocks(b, k_dirs, seq_len, c, rows, dirs, splits)
               < full and 2 * splits <= slices // 3):
            splits *= 2
        return splits

    rows = 64
    if (xdbl_block_cols(128, dirs, c) >= c
            and -(-seq_len // 128) < -(-seq_len // 64)
            and 4 * xdbl_grid_blocks(b, k_dirs, seq_len, c, 128, dirs,
                                     split(128)) >= full):
        rows = 128
    return rows, dirs, split(rows)


def xdbl_occupancy(rows: int, dirs: int, dtype: torch.dtype, use_conv: bool,
                   taps: int, c: int) -> tuple[int, int]:
    """``mamba_xdbl_kernel``'s resident blocks an SM on the current card and
    its shared memory a block in bytes, at ``rows`` and ``dirs``
    (:func:`xdbl_tile`), source dtype ``dtype``, a conv of ``taps`` taps
    or none, and C = ``c``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mamba_fused: source dtype {dtype} is not f32/bf16")
    lib, _ = build()
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.mia_mamba_xdbl_blocks_per_sm(
        rows, xdbl_nt(rows, dirs, c), dirs, int(dtype == torch.bfloat16),
        int(use_conv), taps, ctypes.byref(blocks), ctypes.byref(smem))
    _raise_on(err, "mamba_xdbl_kernel occupancy")
    return blocks.value, smem.value


def fwd_chunk(b: int, k_dirs: int, seq_len: int, d_in: int,
              sms: int = _H100_SMS) -> int:
    """Scan rows a chunk of ``scan_fwd`` for (B, K, L, D) on a card of
    ``sms`` SMs. Where the ``B*K*ceil(D/32)`` blocks of one chunk a
    direction give every SM a block, L: one kernel, no workspace. The cut
    path walks every row twice (summaries, then the scan), so it wins only
    where one pass leaves SMs idle: at ARM-B from B=2 on one pass was the
    faster, at B=1 (96 blocks) chunks of ``_FWD_CUT`` rows."""
    blocks = b * k_dirs * -(-d_in // _BWD_CHANNELS)
    if blocks >= sms or seq_len <= _FWD_CUT:
        return seq_len
    return _FWD_CUT


def _fwd_workspace(device, bk, seq_len, d_in, n, chunk):
    """The forward's fp32 workspace for chunks of ``chunk`` scan rows, a
    slot a (b*k, chunk) (``csrc/mamba_fused.cu``): ``sums`` (B*K, nchunks,
    1 + N, D), S then H (the state entering the chunk once the carry kernel
    ran); None for one chunk."""
    nchunks = -(-seq_len // chunk)
    if nchunks == 1:
        return None
    return torch.empty(bk, nchunks, 1 + n, d_in, device=device,
                       dtype=torch.float32)


def scan_fwd(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A, D,
             delta_softplus=True, use_conv=True):
    """Conv + dt_proj + selective scan + D skip: (B, K, L, D) in source order.

    xdbl (B*K, L, R+2N) from :func:`xdbl_fwd`; conv_w (K, taps, D),
    conv_b (K, D), dt_proj_w (K, D, R), dt_bias (K, D), A (K, D, N) and
    D (K, D) are fp32. The output has the sources' dtype. The scan runs in
    chunks of :func:`fwd_chunk`'s choice for the card, at
    :func:`state_width`'s width (x_dbl and A padded here where that is
    wider than N).
    """
    if _on_cpu(xr):
        return scan_plain(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias,
                          A, D, delta_softplus, use_conv)
    k_dirs, d_in, n = A.shape
    rank = dt_proj_w.shape[2]
    taps = conv_w.shape[1]
    _check_sources(xr, xc, k_dirs, d_in)
    b, seq_len, _ = xr.shape
    _check_widths("mamba_scan", n, taps)
    _check_f32(
        xr.device, xdbl=(xdbl, (b * k_dirs, seq_len, rank + 2 * n)),
        conv_w=(conv_w, (k_dirs, taps, d_in)), conv_b=(conv_b, (k_dirs, d_in)),
        dt_proj_w=(dt_proj_w, (k_dirs, d_in, rank)),
        dt_bias=(dt_bias, (k_dirs, d_in)), A=(A, (k_dirs, d_in, n)),
        D=(D, (k_dirs, d_in)),
    )
    width = state_width(n)
    xdbl = widen_states(xdbl, rank, n, width)
    A, n = _pad_a(A, width), width
    sms = torch.cuda.get_device_properties(xr.device).multi_processor_count
    chunk = fwd_chunk(b, k_dirs, seq_len, d_in, sms)
    sums = _fwd_workspace(xr.device, b * k_dirs, seq_len, d_in, n, chunk)
    y = torch.empty(b, k_dirs, seq_len, d_in, device=xr.device, dtype=xr.dtype)
    lib, _ = build()
    err = lib.mia_mamba_scan(
        xr.data_ptr(), None if xc is None else xc.data_ptr(),
        int(xr.dtype == torch.bfloat16), xdbl.data_ptr(), conv_w.data_ptr(),
        conv_b.data_ptr(), dt_proj_w.data_ptr(), dt_bias.data_ptr(),
        A.data_ptr(), D.data_ptr(), None if sums is None else sums.data_ptr(),
        y.data_ptr(), b, k_dirs, seq_len, d_in, n, rank, taps, int(use_conv),
        int(delta_softplus), int(chunk < seq_len),
        torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(err, "mamba_scan")
    launches["mamba_scan"] += 1
    return y


def fwd_grid_blocks(b: int, k_dirs: int, seq_len: int, d_in: int, n: int,
                    chunk: int) -> dict:
    """Blocks of each forward kernel's grid for (B, K, L, D, N) in chunks
    of ``chunk`` scan rows (0 for a kernel that one chunk does not run), at
    :func:`state_width`'s width."""
    nchunks = -(-seq_len // min(chunk, seq_len))
    blocks = nchunks * -(-d_in // _BWD_CHANNELS) * b * k_dirs
    cut = nchunks > 1
    chains = b * k_dirs * state_width(n) * d_in
    return dict(zip(FWD_KERNELS, (
        blocks if cut else 0,
        -(-chains // _CARRY_THREADS) if cut else 0, blocks)))


def fwd_occupancy(n: int, rank: int, dtype: torch.dtype) -> dict:
    """Each forward kernel's resident blocks an SM on the current card and
    its shared memory a block in bytes, ``{name: (blocks, bytes)}``, for
    d_state ``n`` (run at :func:`state_width`'s width), dt rank ``rank``
    and source dtype ``dtype``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mamba_fused: source dtype {dtype} is not f32/bf16")
    n = state_width(n)
    lib, _ = build()
    out = {}
    for i, name in enumerate(FWD_KERNELS):
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        err = lib.mia_mamba_scan_blocks_per_sm(
            i, n, rank, int(dtype == torch.bfloat16), ctypes.byref(blocks),
            ctypes.byref(smem))
        _raise_on(err, f"{name} occupancy")
        out[name] = (blocks.value, smem.value)
    return out


def _check_bwd(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A, D, dy,
               name):
    """Raise on what the backward's kernels do not take; returns (B, K, L,
    D, N, R, taps)."""
    k_dirs, d_in, n = A.shape
    rank = dt_proj_w.shape[2]
    taps = conv_w.shape[1]
    _check_sources(xr, xc, k_dirs, d_in)
    b, seq_len, _ = xr.shape
    _check_widths(name, n, taps)
    _check_f32(
        xr.device, xdbl=(xdbl, (b * k_dirs, seq_len, rank + 2 * n)),
        conv_w=(conv_w, (k_dirs, taps, d_in)), conv_b=(conv_b, (k_dirs, d_in)),
        dt_proj_w=(dt_proj_w, (k_dirs, d_in, rank)),
        dt_bias=(dt_bias, (k_dirs, d_in)), A=(A, (k_dirs, d_in, n)),
        D=(D, (k_dirs, d_in)),
    )
    if (dy.dtype != xr.dtype or dy.device != xr.device
            or tuple(dy.shape) != (b, k_dirs, seq_len, d_in)
            or not dy.is_contiguous()):
        raise ValueError(
            f"{name}: dy must be a contiguous {xr.dtype} tensor of shape "
            f"{(b, k_dirs, seq_len, d_in)} on {xr.device}; got "
            f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    return b, k_dirs, seq_len, d_in, n, rank, taps


def _bwd_workspaces(device, bk, seq_len, d_in, n, rank):
    """The backward's fp32 workspaces, a slot a chunk of ``_BWD_CHUNK``
    scan rows (``csrc/mamba_fused.cu``): ``sums`` (B*K, nchunks, 1 + 2N,
    D), S then H then G (the carries once kernel 2 ran), and the weight
    gradients' per-(b*k, chunk) partials dA (B*K, nchunks, D, N), dD and
    d dt_bias (B*K, nchunks, D) and dW_dt (B*K, nchunks, D, R)."""
    nchunks = -(-seq_len // _BWD_CHUNK)

    def f32(*shape):
        return torch.empty(*shape, device=device, dtype=torch.float32)

    return dict(sums=f32(bk, nchunks, 1 + 2 * n, d_in),
                dA=f32(bk, nchunks, d_in, n), dD=f32(bk, nchunks, d_in),
                ddb=f32(bk, nchunks, d_in), ddtw=f32(bk, nchunks, d_in, rank))


def _bwd_pointers(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A):
    return (xr.data_ptr(), None if xc is None else xc.data_ptr(),
            int(xr.dtype == torch.bfloat16), xdbl.data_ptr(),
            conv_w.data_ptr(), conv_b.data_ptr(), dt_proj_w.data_ptr(),
            dt_bias.data_ptr(), A.data_ptr())


def scan_bwd(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A, D, dy,
             delta_softplus=True, use_conv=True):
    """Adjoint of :func:`scan_fwd`; the outputs of :func:`scan_bwd_plain`.

    dy (B, K, L, D) in source order and the sources' dtype. The kernels
    write per-block partials of dxdbl and per-(b*k, chunk) ones of the
    weight gradients, summed here in a fixed order. They run at
    :func:`state_width`'s width; the padded states' columns of dxdbl and
    dA (all 0) are dropped.
    """
    if _on_cpu(xr):
        return scan_bwd_plain(xr, xc, xdbl, conv_w, conv_b, dt_proj_w,
                              dt_bias, A, D, dy, delta_softplus, use_conv)
    b, k_dirs, seq_len, d_in, n0, rank, taps = _check_bwd(
        xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A, D, dy,
        "mamba_scan_bwd")
    n = state_width(n0)
    xdbl, A = widen_states(xdbl, rank, n0, n), _pad_a(A, n)
    bk = b * k_dirs
    nblk = -(-d_in // _BWD_CHANNELS)
    w = _bwd_workspaces(xr.device, bk, seq_len, d_in, n, rank)

    def f32(*shape):
        return torch.empty(*shape, device=xr.device, dtype=torch.float32)

    du, u, ds = (f32(bk, seq_len, d_in) for _ in range(3))
    part = f32(bk, nblk, seq_len, rank + 2 * n)
    lib, _ = build()
    err = lib.mia_mamba_scan_bwd(
        *_bwd_pointers(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A),
        D.data_ptr(), dy.data_ptr(), w["sums"].data_ptr(), du.data_ptr(),
        u.data_ptr(), ds.data_ptr(), part.data_ptr(), w["dA"].data_ptr(),
        w["dD"].data_ptr(), w["ddb"].data_ptr(), w["ddtw"].data_ptr(),
        b, k_dirs, seq_len, d_in, n, rank, taps, int(use_conv),
        int(delta_softplus), torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(err, "mamba_scan_bwd")
    launches["mamba_scan_bwd"] += 1
    # each workspace is freed before the next sum is allocated, so that the
    # call holds no more than while its kernels ran
    del w["sums"]
    dxdbl = narrow_states(part.sum(dim=1), rank, n0, n)
    del part
    d_a = w.pop("dA").sum(dim=1)[..., :n0]
    return (du, u, ds, dxdbl, d_a,
            *(w.pop(name).sum(dim=1) for name in ("dD", "ddb", "ddtw")))


def scan_bwd_carries(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A, D,
                     dy, delta_softplus=True, use_conv=True):
    """The backward's summaries and carries kernels alone: ``(h_in,
    g_in)`` as :func:`mamba_carries_plain` gives them, chunks of
    ``_BWD_CHUNK`` scan rows. Not counted in ``launches``: no main path
    calls it."""
    if _on_cpu(xr):
        return mamba_carries_plain(xr, xc, xdbl, conv_w, conv_b, dt_proj_w,
                                   dt_bias, A, D, dy, delta_softplus,
                                   use_conv)
    b, k_dirs, seq_len, d_in, n0, rank, taps = _check_bwd(
        xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A, D, dy,
        "mamba_scan_bwd_carries")
    n = state_width(n0)
    xdbl, A = widen_states(xdbl, rank, n0, n), _pad_a(A, n)
    sums = _bwd_workspaces(xr.device, b * k_dirs, seq_len, d_in, n,
                           rank)["sums"]
    lib, _ = build()
    err = lib.mia_mamba_scan_bwd_carries(
        *_bwd_pointers(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A),
        dy.data_ptr(), sums.data_ptr(), b, k_dirs, seq_len, d_in, n, rank,
        taps, int(use_conv), int(delta_softplus),
        torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(err, "mamba_scan_bwd_carries")
    return sums[:, :, 1 : 1 + n0], sums[:, :, 1 + n : 1 + n + n0]


def bwd_grid_blocks(b: int, k_dirs: int, seq_len: int, d_in: int,
                    n: int) -> dict:
    """Blocks of each backward kernel's grid for (B, K, L, D, N), at
    :func:`state_width`'s width."""
    blocks = -(-seq_len // _BWD_CHUNK) * -(-d_in // _BWD_CHANNELS) * b * k_dirs
    chains = b * k_dirs * state_width(n) * d_in
    return dict(zip(BWD_KERNELS, (
        blocks, -(-chains // _CARRY_THREADS), blocks)))


def bwd_occupancy(n: int, rank: int, dtype: torch.dtype) -> dict:
    """Each backward kernel's resident blocks an SM on the current card and
    its shared memory a block in bytes, ``{name: (blocks, bytes)}``, for
    d_state ``n`` (run at :func:`state_width`'s width), dt rank ``rank``
    and source dtype ``dtype``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mamba_fused: source dtype {dtype} is not f32/bf16")
    n = state_width(n)
    lib, _ = build()
    out = {}
    for i, name in enumerate(BWD_KERNELS):
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        err = lib.mia_mamba_scan_bwd_blocks_per_sm(
            i, n, rank, int(dtype == torch.bfloat16), ctypes.byref(blocks),
            ctypes.byref(smem))
        _raise_on(err, f"{name} occupancy")
        out[name] = (blocks.value, smem.value)
    return out


def _close_bwd(xr, xc, conv_w, x_proj_w, use_conv, du, u, dsilu, dxdbl,
               d_a, d_d, ddb, ddtw):
    """The part of ``_core_bwd`` that the JAX package leaves to XLA
    (``ops/mamba_fused.py:563-671``): the x_proj and conv transposes and
    the sums over the batch. Plain PyTorch, in fp32.

    Returns the grads of (xr, xc, conv_w, conv_b, x_proj_w, dt_proj_w,
    dt_bias, A, D).
    """
    k_dirs = x_proj_w.shape[0]
    b, seq_len, d_in = xr.shape

    def dirs(t):  # (B*K, ...) -> (B, K, ...)
        return t.reshape(b, k_dirs, *t.shape[1:])

    du, u, dsilu, dxdbl = map(dirs, (du, u, dsilu, dxdbl))
    # du_total: the scan path plus the x_proj path, both w.r.t. u
    du_total = du + torch.einsum("bklc,kcd->bkld", dxdbl, x_proj_w)
    if use_conv:
        taps = conv_w.shape[1]
        dpre = du_total * dsilu
        # transposed causal conv: dx[t] = sum_j w[j] dpre[t + taps-1-j]
        dpre_pad = F.pad(dpre, (0, 0, 0, taps - 1))
        dx = sum(conv_w[None, :, j, None, :]
                 * dpre_pad[:, :, taps - 1 - j : taps - 1 - j + seq_len]
                 for j in range(taps))
        x_pad = F.pad(_scan_order(xr, xc, k_dirs), (0, 0, taps - 1, 0))
        dconv_w = torch.stack([
            torch.einsum("bkld,bkld->kd", dpre, x_pad[:, :, j : j + seq_len])
            for j in range(taps)
        ], dim=1)
        dconv_b = dpre.sum(dim=(0, 2))
    else:
        dx = du_total
        dconv_w = torch.zeros_like(conv_w)
        dconv_b = torch.zeros(k_dirs, d_in, device=xr.device,
                              dtype=conv_w.dtype)
    dwx = torch.einsum("bklc,bkld->kcd", dxdbl, u)
    dx = _flip_reversed(dx)  # source order
    dxr = dx[:, : min(k_dirs, 2)].sum(dim=1).to(xr.dtype)
    dxc = None if xc is None else dx[:, 2:].sum(dim=1).to(xc.dtype)
    return (dxr, dxc, dconv_w, dconv_b, dwx, dirs(ddtw).sum(0),
            dirs(ddb).sum(0), dirs(d_a).sum(0), dirs(d_d).sum(0))


class MambaFusedFn(torch.autograd.Function):
    """``y_dirs`` of the fused layer with its backward, as the JAX
    package's ``_mamba_fused_core`` custom VJP.

    Forward: ``xdbl_fwd`` + ``scan_fwd`` (or their plain versions when
    ``plain``); it saves its inputs and x_dbl, and is deterministic, so a
    checkpointed block may run it again. Backward: ``scan_bwd`` (or
    ``scan_bwd_plain``) + :func:`_close_bwd`. Weights are fp32 and
    contiguous (see :func:`mamba_fused_dirs`).
    """

    @staticmethod
    def forward(ctx, xr, xc, conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias,
                A, D, delta_softplus, use_conv, plain):
        fwd_x, fwd_s = (xdbl_plain, scan_plain) if plain else (xdbl_fwd,
                                                                scan_fwd)
        x_dbl = fwd_x(xr, xc, conv_w, conv_b, x_proj_w, use_conv)
        y = fwd_s(xr, xc, x_dbl, conv_w, conv_b, dt_proj_w, dt_bias, A, D,
                  delta_softplus, use_conv)
        ctx.save_for_backward(xr, xc, conv_w, conv_b, x_proj_w, dt_proj_w,
                              dt_bias, A, D, x_dbl)
        ctx.flags = (delta_softplus, use_conv, plain)
        return y

    @staticmethod
    def backward(ctx, dy):
        (xr, xc, conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A, D,
         x_dbl) = ctx.saved_tensors
        delta_softplus, use_conv, plain = ctx.flags
        bwd = scan_bwd_plain if plain else scan_bwd
        outs = bwd(xr, xc, x_dbl, conv_w, conv_b, dt_proj_w, dt_bias, A, D,
                   dy.contiguous(), delta_softplus, use_conv)
        grads = _close_bwd(xr, xc, conv_w, x_proj_w, use_conv, *outs)
        return (*grads, None, None, None)


def mamba_fused_dirs(
    xr: torch.Tensor,
    xc: torch.Tensor | None,
    conv_w: torch.Tensor | None,
    conv_b: torch.Tensor | None,
    x_proj_w: torch.Tensor,
    dt_proj_w: torch.Tensor,
    dt_bias: torch.Tensor,
    A: torch.Tensor,
    D: torch.Tensor,
    delta_softplus: bool = True,
    use_conv: bool = True,
    plain: bool = False,
) -> torch.Tensor:
    """Fused multi-direction Mamba inner function, differentiable.

    Args:
      xr: (B, L, D) row-major scan source; xc: (B, L, D) column-major
          source, or None (then K = x_proj_w.shape[0] must be 1 or 2).
      conv_w: (K, taps, D) or None (no conv); conv_b: (K, D) or None.
      x_proj_w: (K, R+2N, D); dt_proj_w: (K, D, R); dt_bias: (K, D).
      A: (K, D, N) (negative reals); D: (K, D).
      plain: run the plain versions, forward and backward, on any device
          (for comparisons); otherwise the kernels run on CUDA tensors.
    Returns:
      y_dirs (B, K, L, D) in **source** order for every direction, in
      the sources' dtype.

    The weights are taken in fp32, or in fp64 with fp64 sources (which
    only the plain versions take).
    """
    k_dirs, _, d_in = x_proj_w.shape
    xr = xr.contiguous()
    xc = None if xc is None else xc.contiguous()
    wd = dict(device=xr.device, dtype=compute_dtype(xr.dtype))
    if conv_w is None:
        use_conv = False
        conv_w = torch.zeros(k_dirs, _MAX_TAPS, d_in, **wd)
    if conv_b is None:
        conv_b = torch.zeros(k_dirs, d_in, **wd)

    def prep(t):
        return t.to(wd["dtype"]).contiguous()

    conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A, D = map(
        prep, (conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A, D)
    )
    wide = (A.shape[-1] > _MAX_STATE
            or (use_conv and conv_w.shape[1] > _MAX_TAPS))
    if wide and not plain:
        return _wide_dirs(xr, xc, conv_w, conv_b, x_proj_w, dt_proj_w,
                          dt_bias, A, D, delta_softplus, use_conv)
    return MambaFusedFn.apply(xr, xc, conv_w, conv_b, x_proj_w, dt_proj_w,
                              dt_bias, A, D, delta_softplus, use_conv, plain)


def _wide_dirs(xr, xc, conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A, D,
               delta_softplus, use_conv):
    """The layer past the kernels' widths, through the same kernels (and
    their autograd), in fp32 (bf16 sources are widened exactly and y is
    rounded once, at the end):

    - more than ``_MAX_TAPS`` taps: the causal conv + SiLU of each
      direction in plain PyTorch (:func:`_conv_silu`), then each direction
      alone (K = 1, its scan order) in the kernels' no-conv mode, its y
      flipped back to source order where it scans back to front;
    - more than ``_MAX_STATE`` states: groups of at most 32
      (:func:`state_groups`), each with its x_proj rows ``[dt | B_g |
      C_g]``, its A and the D skip in the first group alone; their y are
      added. Autograd adds the dt rows' gradients over the groups and puts
      each group's B and C rows' back in place.
    """
    k_dirs, c, _ = x_proj_w.shape
    n = A.shape[-1]
    out_dtype = xr.dtype
    xr = xr.float()
    xc = None if xc is None else xc.float()
    if use_conv and conv_w.shape[1] > _MAX_TAPS:
        u = _conv_silu(_scan_order(xr, xc, k_dirs), conv_w, conv_b)
        ys = []
        for k in range(k_dirs):
            y = mamba_fused_dirs(u[:, k], None, None, None,
                                 x_proj_w[k : k + 1], dt_proj_w[k : k + 1],
                                 dt_bias[k : k + 1], A[k : k + 1],
                                 D[k : k + 1], delta_softplus,
                                 use_conv=False)
            ys.append(y.flip(2) if k % 2 else y)
        return torch.cat(ys, dim=1).to(out_dtype)
    rank = c - 2 * n
    y = None
    for i, (s0, s1) in enumerate(state_groups(n)):
        w = torch.cat([x_proj_w[:, :rank], x_proj_w[:, rank + s0 : rank + s1],
                       x_proj_w[:, rank + n + s0 : rank + n + s1]], dim=1)
        y_g = MambaFusedFn.apply(
            xr, xc, conv_w, conv_b, w.contiguous(), dt_proj_w, dt_bias,
            A[..., s0:s1].contiguous(), D if i == 0 else torch.zeros_like(D),
            delta_softplus, use_conv, False)
        y = y_g if y is None else y + y_g
    return y.to(out_dtype)
