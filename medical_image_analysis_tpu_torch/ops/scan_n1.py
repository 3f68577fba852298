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
- ``scan_n1_fwd`` (kernel ``scan_n1_fwd_kernel``, replacing the Pallas
  ``_fwd_kernel``): in-kernel dt_proj, the scan of all four directions and
  the sum per source, (2, B, L, D) in the source dtype. As the TPU kernel's
  aliased accumulation does, each direction is rounded to the source dtype
  and the pair is added in that dtype.
- ``scan_n1_bwd`` (kernel ``scan_n1_bwd_kernel``, replacing ``_bwd_kernel``):
  du, dx_dbl, dA, dD, d dt_bias, dW_dt; the closure is plain PyTorch.

The kernels are in ``csrc/scan_n1.cu``, whose header says what bounds them
on the H100 and how their design answers that. Each wrapper runs its
kernel on a CUDA tensor and its plain version (``scan_n1_fwd_plain``,
``scan_n1_bwd_plain``) on a CPU tensor; there is no fallback between the
two. ``launches`` counts kernel launches per wrapper. The TPU's batch
packing into 8 sublanes, its padding and its layout pins have no
counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library
from .selective_scan import softplus

KERNEL_SOURCE = "medical_image_analysis_tpu_torch/csrc/scan_n1.cu"
launches = {"scan_n1_fwd": 0, "scan_n1_bwd": 0}

_THREADS = 64  # channels per block of both kernels
_CHUNK = 16  # rows per chunk of the backward kernel (its carries)
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build() -> tuple[ctypes.CDLL, str]:
    """Build (or reuse) the kernels' library; returns ``(lib, nvcc log)``."""
    lib, log = load_library("scan_n1")
    lib.mia_scan_n1_fwd.argtypes = [
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
    ]
    lib.mia_scan_n1_fwd.restype = _I
    lib.mia_scan_n1_bwd.argtypes = [
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _P,
    ]
    lib.mia_scan_n1_bwd.restype = _I
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
    dyk = _scan_order(torch.stack([dy[0], dy[1], dy[0], dy[1]]).float())
    # the adjoint chain, last row first: p[t] = C[t] dy[t] + a[t+1] p[t+1]
    dh = cm * dyk
    p = torch.zeros_like(dh[:, :, 0])
    ps = []
    for t in range(dh.shape[2] - 1, -1, -1):
        p = dh[:, :, t] + (a[:, :, t + 1] * p if ps else p)
        ps.append(p)
    ps = torch.stack(ps[::-1], dim=2)
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


def scan_n1_fwd(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D):
    """dt_proj + the four-direction N=1 scan + D skip, summed per source.

    xr, xc (B, L, D) sources (fp32 or bf16); x_dbl (4, B, L, R+2) fp32 in
    source order; dt_proj_w (4, D, R), dt_bias, A, D (4, D) fp32. Returns
    (2, B, L, D) in the sources' dtype: [row source, column source].
    """
    if _on_cpu(xr):
        return scan_n1_fwd_plain(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D)
    b, seq_len, d_in, rank = _check(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D)
    y = torch.empty(2, b, seq_len, d_in, device=xr.device, dtype=xr.dtype)
    lib, _ = build()
    err = lib.mia_scan_n1_fwd(
        xr.data_ptr(), xc.data_ptr(), int(xr.dtype == torch.bfloat16),
        x_dbl.data_ptr(), dt_proj_w.data_ptr(), dt_bias.data_ptr(),
        A.data_ptr(), D.data_ptr(), y.data_ptr(), b, seq_len, d_in, rank,
        torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(err, "scan_n1_fwd")
    launches["scan_n1_fwd"] += 1
    return y


def scan_n1_bwd(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D, dy):
    """Adjoint of :func:`scan_n1_fwd`; the outputs of
    :func:`scan_n1_bwd_plain`. dy (2, B, L, D) in the sources' dtype. The
    kernel writes per-block partials of dxdbl and per-image ones of the
    weight gradients, summed here."""
    if _on_cpu(xr):
        return scan_n1_bwd_plain(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D, dy)
    b, seq_len, d_in, rank = _check(xr, xc, x_dbl, dt_proj_w, dt_bias, A, D)
    if (dy.dtype != xr.dtype or dy.device != xr.device
            or tuple(dy.shape) != (2, b, seq_len, d_in)
            or not dy.is_contiguous()):
        raise ValueError(
            f"scan_n1_bwd: dy must be a contiguous {xr.dtype} tensor of shape "
            f"{(2, b, seq_len, d_in)} on {xr.device}; got {dy.dtype} "
            f"{tuple(dy.shape)} on {dy.device}")
    nblk = -(-d_in // _THREADS)

    def f32(*shape):
        return torch.empty(*shape, device=xr.device, dtype=torch.float32)

    carries = f32(2, b, -(-seq_len // _CHUNK), d_in)
    du = f32(2, b, seq_len, d_in)
    part = f32(nblk, 4, b, seq_len, rank + 2)
    d_a, d_d, ddb = (f32(b, 4, d_in) for _ in range(3))
    ddtw = f32(b, 4, d_in, rank)
    lib, _ = build()
    err = lib.mia_scan_n1_bwd(
        xr.data_ptr(), xc.data_ptr(), int(xr.dtype == torch.bfloat16),
        x_dbl.data_ptr(), dt_proj_w.data_ptr(), dt_bias.data_ptr(),
        A.data_ptr(), D.data_ptr(), dy.data_ptr(), carries.data_ptr(),
        du.data_ptr(), part.data_ptr(), d_a.data_ptr(), d_d.data_ptr(),
        ddb.data_ptr(), ddtw.data_ptr(), b, seq_len, d_in, rank,
        torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(err, "scan_n1_bwd")
    launches["scan_n1_bwd"] += 1
    return (du, part.sum(dim=0), d_a.sum(dim=0), d_d.sum(dim=0),
            ddb.sum(dim=0), ddtw.sum(dim=0))


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
    rounding of the weight, summed in fp32 (``scan_n1.py:724-737``)."""
    wx = x_proj_w.to(xr.dtype).float()
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
