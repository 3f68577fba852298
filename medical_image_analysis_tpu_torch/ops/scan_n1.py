"""The d_state=1 four-direction VMamba scan: CUDA kernels and plain versions.

Counterpart of ``medical_image_analysis_tpu/ops/scan_n1.py``
(``scan_n1_sources``, ``scan_n1_dirs`` and the custom VJP around them).
At N=1 the selective scan is a per-channel linear recurrence with scalar
B and C per row::

    dt[t,d] = softplus(x_dbl[t,:R] . W_dt[d,:] + bias[d])
    h[t,d]  = exp(dt[t,d] * A[d]) * h[t-1,d] + dt[t,d] * B[t] * u[t,d]
    y[t,d]  = C[t] * h[t,d] + D[d] * u[t,d]

Directions are in reference order [row, col, row-rev, col-rev]: direction
k reads ``xr`` when k is even and ``xc`` when it is odd, and scans it back
to front when k >= 2. The two directions of a source sum into one output.

- ``x_dbl = x @ Wx^T`` is plain ``torch.einsum`` OUTSIDE the autograd
  Function, as the JAX package leaves it to XLA, so its pullback (dWx and
  the x_proj path of du) comes from autograd. ``Wx`` is rounded to the
  source dtype and the product is summed in fp32.
- ``scan_n1_fwd`` (kernels ``scan_n1_fwd_sums_kernel``,
  ``scan_n1_fwd_carry_kernel`` and ``scan_n1_fwd_kernel``, together
  replacing the Pallas ``_fwd_kernel``): in-kernel dt_proj, the scan of all
  four directions and the sum per source, (2, B, L, D) in the source
  dtype. As the TPU kernel's aliased accumulation does, each direction is
  rounded to the source dtype and the pair is added in that dtype. It runs
  as a scan over chunks of ``_CHUNK`` rows in parallel over L (the
  summaries of every piece of ``_PIECE`` rows, their carries as the
  backward's carry kernel walks them without the adjoint, then the scan
  from each piece's carried state), or as one pass of the scan kernel over
  L, whichever :func:`fwd_chunk` picks from the grid.
- ``scan_n1_bwd`` (kernels ``scan_n1_bwd_sums_kernel``,
  ``scan_n1_bwd_carry_kernel`` and ``scan_n1_bwd_grad_kernel``, together
  replacing ``_bwd_kernel``): du, dx_dbl, dA, dD, d dt_bias, dW_dt, as a
  scan over chunks of ``_CHUNK`` rows that runs in parallel over L; the
  closure is plain PyTorch. ``scan_n1_bwd_carries`` runs its first two
  kernels alone, for tests of the state and adjoint entering each piece
  of ``_PIECE`` rows.

The kernels are in ``csrc/scan_n1.cu``, whose header says what bounds them
on the H100 and how their design answers that. Each wrapper runs its
kernel on a CUDA tensor and its plain version (``scan_n1_fwd_plain``,
``scan_n1_bwd_plain``) on a CPU tensor; there is no fallback between the
two. ``launches`` counts calls of a wrapper that launched its kernels
(the forward's and the backward's three kernels count once). The TPU's
batch packing into 8 sublanes, its padding and its layout pins have no
counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library
from .selective_scan import softplus

KERNEL_SOURCE = "medical_image_analysis_tpu_torch/csrc/scan_n1.cu"
launches = {"scan_n1_fwd": 0, "scan_n1_bwd": 0}

_THREADS = 64  # channels per block of the scan kernels
_CHUNK = 32  # source rows a chunk of the backward and of the cut forward
_PIECE = 16  # rows a piece of a chunk (a slot of the summaries and carries)
_CARRY_THREADS = 128  # chains per block of the carry kernels
_FWD_BLOCKS = 6  # the forward kernels' resident blocks an SM (their cap)
# One pass at most this many rows (8 chunks: a walk of 16 tiles a block),
# whatever the grid (the sweep in PERF.md).
_ONE_PASS_ROWS = 256
_H100_SMS = 132
# The kernels of each direction in the order of the index of
# mia_scan_n1_{fwd,bwd}_blocks_per_sm: piece summaries, carries, then the
# scan or the gradients.
FWD_KERNELS = ("scan_n1_fwd_sums_kernel", "scan_n1_fwd_carry_kernel",
               "scan_n1_fwd_kernel")
BWD_KERNELS = ("scan_n1_bwd_sums_kernel", "scan_n1_bwd_carry_kernel",
               "scan_n1_bwd_grad_kernel")
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build() -> tuple[ctypes.CDLL, str]:
    """Build (or reuse) the kernels' library; returns ``(lib, nvcc log)``."""
    lib, log = load_library("scan_n1")
    lib.mia_scan_n1_fwd.argtypes = [
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
    ]
    lib.mia_scan_n1_fwd.restype = _I
    lib.mia_scan_n1_bwd.argtypes = [
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _P,
    ]
    lib.mia_scan_n1_bwd.restype = _I
    lib.mia_scan_n1_bwd_carries.argtypes = [
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
    ]
    lib.mia_scan_n1_bwd_carries.restype = _I
    lib.mia_scan_n1_fwd_blocks_per_sm.argtypes = [
        _I, _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.mia_scan_n1_fwd_blocks_per_sm.restype = _I
    lib.mia_scan_n1_bwd_blocks_per_sm.argtypes = [
        _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.mia_scan_n1_bwd_blocks_per_sm.restype = _I
    return lib, log


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def _scan_order(t):
    """(4, B, L, ...) source order <-> each direction's scan order."""
    return torch.cat([t[:2], t[2:].flip(2)])


def _dirs(xr, xc, x_dbl, dt_proj_w, dt_bias):
    """fp32 u, x_dbl, dt and softplus'(dt_raw), (4, B, L, ...) scan order."""
    rank = dt_proj_w.shape[2]
    u = _scan_order(torch.stack([xr, xc, xr, xc]).float())
    xd = _scan_order(x_dbl.float())
    dt_raw = torch.einsum("kblr,kdr->kbld", xd[..., :rank], dt_proj_w)
    dt_raw = dt_raw + dt_bias[:, None, None, :]
    return u, xd, softplus(dt_raw), torch.sigmoid(dt_raw)


def _states(a, bx):
    """h[t] = a[t] h[t-1] + bx[t] over dim 2 of (4, B, L, D), from 0."""
    h = torch.zeros_like(a[:, :, 0])
    hs = []
    for t in range(a.shape[2]):
        h = a[:, :, t] * h + bx[:, :, t]
        hs.append(h)
    return torch.stack(hs, dim=2)


def _dir_outputs(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D):
    """Every direction's y, (4, B, L, D) fp32 in source order."""
    rank = dt_proj_w.shape[2]
    u, xd, dt, _ = _dirs(xr, xc, x_dbl, dt_proj_w, dt_bias)
    a = torch.exp(dt * A[:, None, None, :])
    hs = _states(a, dt * u * xd[..., rank : rank + 1])
    y = xd[..., rank + 1 : rank + 2] * hs + D[:, None, None, :] * u
    return _scan_order(y)


def scan_n1_fwd_plain(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D):
    """Plain version of ``scan_n1_fwd``: (2, B, L, D) in the sources' dtype,
    ``y[s]`` directions s and s+2 each rounded to that dtype and added in
    it (``scan_n1.py:140-147``)."""
    y = _dir_outputs(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D).to(xr.dtype)
    return y[:2] + y[2:]


def _dys(dy):
    """dy of each direction, (4, B, L, D) fp32 in scan order."""
    return _scan_order(torch.stack([dy[0], dy[1], dy[0], dy[1]]).float())


def _adjoints(a, dh):
    """The adjoint chain over dim 2 of (4, B, L, D), last row first:
    p[t] = dh[t] + a[t+1] p[t+1]."""
    p = torch.zeros_like(dh[:, :, 0])
    ps = []
    for t in range(dh.shape[2] - 1, -1, -1):
        p = dh[:, :, t] + (a[:, :, t + 1] * p if ps else p)
        ps.append(p)
    return torch.stack(ps[::-1], dim=2)


def scan_n1_bwd_plain(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D, dy):
    """Plain version of ``scan_n1_bwd``: the adjoint of
    ``scan_n1_fwd_plain`` with the adjoint chain as an explicit reverse
    loop over L (the body of ``_bwd_kernel``).

    Returns fp32 ``(du, dxdbl, dA, dD, ddt_bias, ddt_proj_w)``: du
    (2, B, L, D), the gradient w.r.t. the sources through the scan and the
    D skip of both directions (the x_proj path reaches them through
    dxdbl); dxdbl (4, B, L, R+2) in source order; dA, dD, ddt_bias (4, D);
    ddt_proj_w (4, D, R).
    """
    rank = dt_proj_w.shape[2]
    u, xd, dt, sg = _dirs(xr, xc, x_dbl, dt_proj_w, dt_bias)
    bm, cm = xd[..., rank : rank + 1], xd[..., rank + 1 : rank + 2]
    a = torch.exp(dt * A[:, None, None, :])
    dtu = dt * u
    hs = _states(a, dtu * bm)
    dyk = _dys(dy)
    ps = _adjoints(a, cm * dyk)
    hprev = torch.cat([torch.zeros_like(hs[:, :, :1]), hs[:, :, :-1]], dim=2)
    dloga = ps * hprev * a
    ddt = (dloga * A[:, None, None, :] + ps * u * bm) * sg
    du = _scan_order(dt * bm * ps + dyk * D[:, None, None, :])
    dxdbl = torch.cat([
        torch.einsum("kbld,kdr->kblr", ddt, dt_proj_w),
        torch.sum(ps * dtu, dim=-1, keepdim=True),
        torch.sum(hs * dyk, dim=-1, keepdim=True),
    ], dim=-1)
    return (du[:2] + du[2:], _scan_order(dxdbl),
            torch.sum(dloga * dt, dim=(1, 2)), torch.sum(dyk * u, dim=(1, 2)),
            torch.sum(ddt, dim=(1, 2)),
            torch.einsum("kbld,kblr->kdr", ddt, xd[..., :rank]))


def scan_n1_carries_plain(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D, dy,
                          chunk=_CHUNK, piece=_PIECE):
    """Plain version of ``scan_n1_bwd_carries``, from the sequential walks
    of ``scan_n1_bwd_plain``. Each chunk of ``chunk`` source rows is cut
    into ``chunk // piece`` pieces of ``piece`` rows in each direction's
    scan order (piece j of chunk c at slot ``c * (chunk // piece) + j``);
    for every direction and slot, the state entering the piece's first row
    and the adjoint entering its last row from the row after it, in scan
    order (0 at the ends). A piece past the last chunk's rows is empty and
    passes them through: the state after the chunk, the adjoint entering
    its last row. Returns fp32 ``(h_in, g_in)``, each (4, B, slots, D).
    ``D`` is unused: the states and adjoints do not depend on the skip."""
    del D
    rank = dt_proj_w.shape[2]
    u, xd, dt, _ = _dirs(xr, xc, x_dbl, dt_proj_w, dt_bias)
    a = torch.exp(dt * A[:, None, None, :])
    hs = _states(a, dt * u * xd[..., rank : rank + 1])
    ps = _adjoints(a, xd[..., rank + 1 : rank + 2] * _dys(dy))
    zero = torch.zeros_like(hs[:, :, :1])
    # in scan order: the state entering row i (i = L: after the last row),
    # and the adjoint a[i+1] p[i+1] entering row i
    h_before = torch.cat([zero, hs], dim=2)
    g_after = torch.cat([(a * ps)[:, :, 1:], zero], dim=2)
    seq_len = xr.shape[1]
    per = chunk // piece
    c = torch.arange(-(-seq_len // chunk), device=xr.device)
    c = c.repeat_interleave(per)
    j = torch.arange(per, device=xr.device).repeat(len(c) // per)
    nt = (seq_len - c * chunk).clamp(max=chunk)
    h_in, g_in = [], []
    for dirs, first in ((slice(0, 2), c * chunk),  # scan row of a chunk's
                        (slice(2, 4), seq_len - c * chunk - nt)):  # start
        h_in.append(h_before[dirs][:, :, first + torch.minimum(j * piece,
                                                               nt)])
        g_in.append(g_after[dirs][:, :, first + torch.minimum(
            (j + 1) * piece, nt) - 1])
    return torch.cat(h_in), torch.cat(g_in)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _on_cpu(xr):
    if xr.device.type == "cpu":
        return True
    if xr.device.type != "cuda":
        raise ValueError(f"scan_n1: unsupported device {xr.device}")
    return False


def _check(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D):
    """Raise on what the kernels do not take; returns (B, L, D, R)."""
    if xr.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scan_n1: source dtype {xr.dtype} is not f32/bf16")
    if xr.ndim != 3 or not xr.is_contiguous():
        raise ValueError(f"scan_n1: xr must be a contiguous (B, L, D) tensor; "
                         f"got {tuple(xr.shape)}")
    if (xc.shape != xr.shape or xc.dtype != xr.dtype
            or xc.device != xr.device or not xc.is_contiguous()):
        raise ValueError("scan_n1: xc must match xr (shape, dtype, device) "
                         "and be contiguous")
    b, seq_len, d_in = xr.shape
    rank = dt_proj_w.shape[-1]
    for name, t, shape in (
        ("x_dbl", x_dbl, (4, b, seq_len, rank + 2)),
        ("dt_proj_w", dt_proj_w, (4, d_in, rank)),
        ("dt_bias", dt_bias, (4, d_in)), ("A", A, (4, d_in)),
        ("D", D, (4, d_in)),
    ):
        if (t.dtype != torch.float32 or t.device != xr.device
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"scan_n1: {name} must be a contiguous fp32 tensor of shape "
                f"{shape} on {xr.device}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    return b, seq_len, d_in, rank


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def fwd_chunk(b: int, seq_len: int, d_in: int, sms: int = _H100_SMS) -> int:
    """Source rows a chunk of ``scan_n1_fwd`` for (B, L, D) on a card of
    ``sms`` SMs: L (one pass of the scan kernel, no workspace) where L is
    at most ``_ONE_PASS_ROWS`` or the one-pass grid of ``2 B ceil(D/64)``
    blocks gives every SM a block, else ``_CHUNK`` (summaries, carries,
    then the scan a chunk a block). The cut regime stages every row twice
    and computes its terms twice, so it wins only where one pass leaves
    SMs idle through a long walk: vssm1_base's stage 0 at up to 12 images,
    stage 1 at 4."""
    blocks = 2 * b * -(-d_in // _THREADS)
    if seq_len <= _ONE_PASS_ROWS or blocks >= sms:
        return seq_len
    return _CHUNK


def _workspaces(xr, b, seq_len, d_in, planes=(3, 2)):
    """The chunked scan's (sums, carries): fp32 (planes[0], 4, B, slots, D)
    and (planes[1], 4, B, slots, D), a slot a piece of ``_PIECE`` rows of a
    chunk (``csrc/scan_n1.cu``): (P, H, G) and (h_in, g_in) for the
    backward, (P, H) and h_in for the forward."""
    slots = -(-seq_len // _CHUNK) * (_CHUNK // _PIECE)
    return tuple(torch.empty(n, 4, b, slots, d_in, device=xr.device,
                             dtype=torch.float32) for n in planes)


def scan_n1_fwd(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D):
    """dt_proj + the four-direction N=1 scan + D skip, summed per source.

    xr, xc (B, L, D) sources (fp32 or bf16); x_dbl (4, B, L, R+2) fp32 in
    source order; dt_proj_w (4, D, R), dt_bias, A, D (4, D) fp32. Returns
    (2, B, L, D) in the sources' dtype: [row source, column source]. The
    scan runs in chunks of :func:`fwd_chunk`'s choice for the card.
    """
    if _on_cpu(xr):
        return scan_n1_fwd_plain(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D)
    b, seq_len, d_in, rank = _check(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D)
    sms = torch.cuda.get_device_properties(xr.device).multi_processor_count
    cut = fwd_chunk(b, seq_len, d_in, sms) < seq_len
    sums, carries = (_workspaces(xr, b, seq_len, d_in, (2, 1)) if cut
                     else (None, None))
    y = torch.empty(2, b, seq_len, d_in, device=xr.device, dtype=xr.dtype)
    lib, _ = build()
    err = lib.mia_scan_n1_fwd(
        xr.data_ptr(), xc.data_ptr(), int(xr.dtype == torch.bfloat16),
        x_dbl.data_ptr(), dt_proj_w.data_ptr(), dt_bias.data_ptr(),
        A.data_ptr(), D.data_ptr(), None if sums is None else sums.data_ptr(),
        None if carries is None else carries.data_ptr(), y.data_ptr(), b,
        seq_len, d_in, rank, torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(err, "scan_n1_fwd")
    launches["scan_n1_fwd"] += 1
    return y


def fwd_grid_blocks(b: int, seq_len: int, d_in: int, chunk: int) -> dict:
    """Blocks of each forward kernel's grid for (B, L, D) in chunks of
    ``chunk`` rows (0 for a kernel that one pass does not run)."""
    nblk = -(-d_in // _THREADS)
    if chunk >= seq_len:
        return dict(zip(FWD_KERNELS, (0, 0, nblk * b * 2)))
    chunks = -(-seq_len // _CHUNK) * nblk
    return dict(zip(FWD_KERNELS, (chunks * b * 2,
                                  -(-4 * b * d_in // _CARRY_THREADS),
                                  chunks * b * 2)))


def _check_dy(xr, dy, name):
    b, seq_len, d_in = xr.shape
    if (dy.dtype != xr.dtype or dy.device != xr.device
            or tuple(dy.shape) != (2, b, seq_len, d_in)
            or not dy.is_contiguous()):
        raise ValueError(
            f"{name}: dy must be a contiguous {xr.dtype} tensor of shape "
            f"{(2, b, seq_len, d_in)} on {xr.device}; got {dy.dtype} "
            f"{tuple(dy.shape)} on {dy.device}")


def scan_n1_bwd(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D, dy):
    """Adjoint of :func:`scan_n1_fwd`; the outputs of
    :func:`scan_n1_bwd_plain`. dy (2, B, L, D) in the sources' dtype. The
    kernels write per-block partials of dxdbl and per-(chunk, image) ones
    of the weight gradients, summed here in a fixed order."""
    if _on_cpu(xr):
        return scan_n1_bwd_plain(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D, dy)
    b, seq_len, d_in, rank = _check(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D)
    _check_dy(xr, dy, "scan_n1_bwd")
    nblk = -(-d_in // _THREADS)
    nchunks = -(-seq_len // _CHUNK)

    def f32(*shape):
        return torch.empty(*shape, device=xr.device, dtype=torch.float32)

    sums, carries = _workspaces(xr, b, seq_len, d_in)
    du = f32(2, b, seq_len, d_in)
    part = f32(nblk, 4, b, seq_len, rank + 2)
    d_a, d_d, ddb = (f32(nchunks, b, 4, d_in) for _ in range(3))
    ddtw = f32(nchunks, b, 4, rank, d_in)
    lib, _ = build()
    err = lib.mia_scan_n1_bwd(
        xr.data_ptr(), xc.data_ptr(), int(xr.dtype == torch.bfloat16),
        x_dbl.data_ptr(), dt_proj_w.data_ptr(), dt_bias.data_ptr(),
        A.data_ptr(), D.data_ptr(), dy.data_ptr(), sums.data_ptr(),
        carries.data_ptr(), du.data_ptr(), part.data_ptr(), d_a.data_ptr(),
        d_d.data_ptr(), ddb.data_ptr(), ddtw.data_ptr(), b, seq_len, d_in,
        rank, torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(err, "scan_n1_bwd")
    launches["scan_n1_bwd"] += 1

    def per_chunk_and_image(x):
        return x.reshape(nchunks * b, *x.shape[2:]).sum(dim=0)

    return (du, part.sum(dim=0), per_chunk_and_image(d_a),
            per_chunk_and_image(d_d), per_chunk_and_image(ddb),
            per_chunk_and_image(ddtw).transpose(1, 2).contiguous())


def scan_n1_bwd_carries(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D, dy):
    """The backward's summaries and carries kernels alone: ``(h_in,
    g_in)`` as :func:`scan_n1_carries_plain` gives them, pieces of
    ``_PIECE`` rows of chunks of ``_CHUNK`` rows. Not counted in
    ``launches``: no main path calls it."""
    if _on_cpu(xr):
        return scan_n1_carries_plain(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D,
                                     dy)
    b, seq_len, d_in, rank = _check(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D)
    _check_dy(xr, dy, "scan_n1_bwd_carries")
    sums, carries = _workspaces(xr, b, seq_len, d_in)
    lib, _ = build()
    err = lib.mia_scan_n1_bwd_carries(
        xr.data_ptr(), xc.data_ptr(), int(xr.dtype == torch.bfloat16),
        x_dbl.data_ptr(), dt_proj_w.data_ptr(), dt_bias.data_ptr(),
        A.data_ptr(), dy.data_ptr(), sums.data_ptr(), carries.data_ptr(), b,
        seq_len, d_in, rank, torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(err, "scan_n1_bwd_carries")
    return carries[0], carries[1]


def bwd_grid_blocks(b: int, seq_len: int, d_in: int) -> dict:
    """Blocks of each backward kernel's grid for (B, L, D)."""
    chunks = -(-seq_len // _CHUNK) * -(-d_in // _THREADS)
    return dict(zip(BWD_KERNELS, (chunks * b * 4,
                                  -(-4 * b * d_in // _CARRY_THREADS),
                                  chunks * b * 2)))


def _occupancy(query, kernels, rank, dtype, *flags) -> dict:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scan_n1: source dtype {dtype} is not f32/bf16")
    fn = getattr(build()[0], query)
    out = {}
    for i, name in enumerate(kernels):
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        err = fn(i, rank, int(dtype == torch.bfloat16), *flags,
                 ctypes.byref(blocks), ctypes.byref(smem))
        _raise_on(err, f"{name} occupancy")
        out[name] = (blocks.value, smem.value)
    return out


def fwd_occupancy(rank: int, dtype: torch.dtype, cut: bool = True) -> dict:
    """Each forward kernel's resident blocks an SM on the current card and
    its shared memory a block in bytes, ``{name: (blocks, bytes)}``, for
    dt rank ``rank``, source dtype ``dtype`` and the regime (``cut``: in
    chunks, where the scan kernel keeps its forward direction's outputs in
    shared memory; else one pass)
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return _occupancy("mia_scan_n1_fwd_blocks_per_sm", FWD_KERNELS, rank,
                      dtype, int(cut))


def bwd_occupancy(rank: int, dtype: torch.dtype) -> dict:
    """The same as :func:`fwd_occupancy` for the backward's kernels."""
    return _occupancy("mia_scan_n1_bwd_blocks_per_sm", BWD_KERNELS, rank,
                      dtype)


class ScanN1Fn(torch.autograd.Function):
    """The scan of both sources with its backward, as the JAX package's
    ``_scan2_core`` custom VJP: ``scan_n1_fwd`` / ``scan_n1_bwd`` (or
    their plain versions when ``plain``). It saves its inputs; the kernels
    are deterministic."""

    @staticmethod
    def forward(ctx, xr, xc, x_dbl, dt_proj_w, dt_bias, A, D, plain):
        fwd = scan_n1_fwd_plain if plain else scan_n1_fwd
        y = fwd(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D)
        ctx.save_for_backward(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D)
        ctx.plain = plain
        return y

    @staticmethod
    def backward(ctx, dy):
        xr, xc, x_dbl, dt_proj_w, dt_bias, A, D = ctx.saved_tensors
        bwd = scan_n1_bwd_plain if ctx.plain else scan_n1_bwd
        du, dxdbl, d_a, d_d, ddb, ddtw = bwd(
            xr, xc, x_dbl, dt_proj_w, dt_bias, A, D,
            dy.to(xr.dtype).contiguous())
        return (du[0].to(xr.dtype), du[1].to(xc.dtype), dxdbl, ddtw, ddb,
                d_a, d_d, None)


def _x_dbl(xr, xc, x_proj_w):
    """(4, B, L, R+2) fp32 in source order: x_proj in the source dtype's
    rounding of the weight, summed in fp32 (``scan_n1.py:724-737``), also
    under autocast (which would run the products in its own dtype)."""
    wx = x_proj_w.to(xr.dtype).float()
    with torch.autocast(xr.device.type, enabled=False):
        rows = torch.einsum("bld,jcd->jblc", xr.float(), wx[0::2])  # k = 0, 2
        cols = torch.einsum("bld,jcd->jblc", xc.float(), wx[1::2])  # k = 1, 3
    return torch.stack([rows[0], cols[0], rows[1], cols[1]])


def _weights(dt_proj_w, dt_bias, A, D):
    return (dt_proj_w.float().contiguous(), dt_bias.float().contiguous(),
            A.reshape(4, -1).float().contiguous(), D.float().contiguous())


def scan_n1_sources(
    xr: torch.Tensor,
    xc: torch.Tensor,
    x_proj_w: torch.Tensor,
    dt_proj_w: torch.Tensor,
    dt_bias: torch.Tensor,
    A: torch.Tensor,
    D: torch.Tensor,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Four-direction d_state=1 scan with the direction pairs summed.

    Args (parameter order [row, col, row-rev, col-rev]):
      xr, xc: (B, L, D) row-major / column-major sources (fp32 or bf16).
      x_proj_w: (4, R+2, D); dt_proj_w: (4, D, R); dt_bias: (4, D);
      A: (4, D, 1) or (4, D); D: (4, D).
      plain: run the plain versions, forward and backward, on any device
          (for comparisons); otherwise the kernels run on CUDA tensors.
    Returns:
      (y_row, y_col), each (B, L, D) in the sources' dtype; y_col is in
      column-major order (the caller transposes it back).
    """
    xr, xc = xr.contiguous(), xc.contiguous()
    y = ScanN1Fn.apply(xr, xc, _x_dbl(xr, xc, x_proj_w),
                       *_weights(dt_proj_w, dt_bias, A, D), plain)
    return y[0], y[1]


def scan_n1_dirs(xr, xc, x_proj_w, dt_proj_w, dt_bias, A, D) -> torch.Tensor:
    """Every direction's y, (B, 4, L, D) in source order and the sources'
    dtype: the per-direction form of :func:`scan_n1_sources`, plain
    PyTorch, differentiable by autograd."""
    y = _dir_outputs(xr, xc, _x_dbl(xr, xc, x_proj_w),
                     *_weights(dt_proj_w, dt_bias, A, D))
    return y.transpose(0, 1).to(xr.dtype)
