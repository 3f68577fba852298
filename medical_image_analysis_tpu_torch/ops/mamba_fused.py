"""Fused multi-direction Mamba forward: two CUDA kernels and their plain versions.

Counterpart of ``medical_image_analysis_tpu/ops/mamba_fused.py``
(``mamba_fused_dirs``, forward only). The layer runs in two launches:

- ``xdbl_fwd``: per direction, ``x_dbl = silu(conv(x_dir) + b) @ Wx^T``
  in fp32 (kernel ``mamba_xdbl_kernel``, replacing the Pallas
  ``_xdbl_kernel``).
- ``scan_fwd``: conv + SiLU again, ``dt = softplus(x_dbl[:, :R] @ W_dt +
  bias)``, the S6 scan with fp32 state and ``y = C.h + D.u`` written in
  SOURCE order in the source dtype (kernel ``mamba_scan_kernel``,
  replacing the Pallas ``_fused_fwd_kernel``).

The kernels are in ``csrc/mamba_fused.cu``, whose header says what bounds
each on the H100 and how its design answers that. Directions are
[row, row-rev, col, col-rev]: direction k reads ``xc`` when k >= 2 and
scans it back to front when k is odd.

Each wrapper runs its kernel on a CUDA tensor and its plain version
(``xdbl_plain``, ``scan_plain``) on a CPU tensor; there is no fallback
between the two. ``launches`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import load_library
from .selective_scan import softplus

KERNEL_SOURCE = "medical_image_analysis_tpu_torch/csrc/mamba_fused.cu"
launches = {"mamba_xdbl": 0, "mamba_scan": 0}

_SCAN_STATES = (4, 16)  # d_state values the scan kernel is built for
_MAX_TAPS = 4
_XDBL_MAX_ROWS = 8
_XDBL_SMEM_FLOATS = 12288  # 48 KiB of staged conv output per block
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build() -> tuple[ctypes.CDLL, str]:
    """Build (or reuse) the kernels' library; returns ``(lib, nvcc log)``."""
    lib, log = load_library("mamba_fused")
    lib.mia_mamba_xdbl.argtypes = [
        _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ]
    lib.mia_mamba_xdbl.restype = _I
    lib.mia_mamba_scan.argtypes = [
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ]
    lib.mia_mamba_scan.restype = _I
    return lib, log


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def _scan_order(xr, xc, k_dirs):
    """(B, K, L, D) fp32 sources in each direction's scan order."""
    seqs = []
    for k in range(k_dirs):
        src = xc if xc is not None and k >= 2 else xr
        seqs.append(src.flip(1) if k % 2 else src)
    return torch.stack(seqs, dim=1).float()


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
    y = torch.cat([y[:, k : k + 1].flip(2) if k % 2 else y[:, k : k + 1]
                   for k in range(k_dirs)], dim=1)
    return y.to(xr.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


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
    """
    if _on_cpu(xr):
        return xdbl_plain(xr, xc, conv_w, conv_b, x_proj_w, use_conv)
    k_dirs, c, d_in = x_proj_w.shape
    _check_sources(xr, xc, k_dirs, d_in)
    b, seq_len, _ = xr.shape
    taps = conv_w.shape[1]
    if not 1 <= taps <= _MAX_TAPS or d_in > _XDBL_SMEM_FLOATS:
        raise ValueError(f"mamba_xdbl: taps={taps}, D={d_in} unsupported")
    _check_f32(
        xr.device, conv_w=(conv_w, (k_dirs, taps, d_in)),
        conv_b=(conv_b, (k_dirs, d_in)), x_proj_w=(x_proj_w, (k_dirs, c, d_in)),
    )
    out = torch.empty(b * k_dirs, seq_len, c, device=xr.device,
                      dtype=torch.float32)
    rows = max(1, min(_XDBL_MAX_ROWS, _XDBL_SMEM_FLOATS // d_in))
    lib, _ = build()
    err = lib.mia_mamba_xdbl(
        xr.data_ptr(), None if xc is None else xc.data_ptr(),
        int(xr.dtype == torch.bfloat16), conv_w.data_ptr(), conv_b.data_ptr(),
        x_proj_w.data_ptr(), out.data_ptr(), b, k_dirs, seq_len, d_in, c,
        taps, int(use_conv), rows,
        torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(err, "mamba_xdbl")
    launches["mamba_xdbl"] += 1
    return out


def scan_fwd(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias, A, D,
             delta_softplus=True, use_conv=True):
    """Conv + dt_proj + selective scan + D skip: (B, K, L, D) in source order.

    xdbl (B*K, L, R+2N) from :func:`xdbl_fwd`; conv_w (K, taps, D),
    conv_b (K, D), dt_proj_w (K, D, R), dt_bias (K, D), A (K, D, N) and
    D (K, D) are fp32. The output has the sources' dtype.
    """
    if _on_cpu(xr):
        return scan_plain(xr, xc, xdbl, conv_w, conv_b, dt_proj_w, dt_bias,
                          A, D, delta_softplus, use_conv)
    k_dirs, d_in, n = A.shape
    rank = dt_proj_w.shape[2]
    taps = conv_w.shape[1]
    _check_sources(xr, xc, k_dirs, d_in)
    b, seq_len, _ = xr.shape
    if n not in _SCAN_STATES or not 1 <= taps <= _MAX_TAPS:
        raise ValueError(f"mamba_scan: d_state={n}, taps={taps} unsupported "
                         f"(d_state in {_SCAN_STATES}, taps <= {_MAX_TAPS})")
    _check_f32(
        xr.device, xdbl=(xdbl, (b * k_dirs, seq_len, rank + 2 * n)),
        conv_w=(conv_w, (k_dirs, taps, d_in)), conv_b=(conv_b, (k_dirs, d_in)),
        dt_proj_w=(dt_proj_w, (k_dirs, d_in, rank)),
        dt_bias=(dt_bias, (k_dirs, d_in)), A=(A, (k_dirs, d_in, n)),
        D=(D, (k_dirs, d_in)),
    )
    y = torch.empty(b, k_dirs, seq_len, d_in, device=xr.device, dtype=xr.dtype)
    lib, _ = build()
    err = lib.mia_mamba_scan(
        xr.data_ptr(), None if xc is None else xc.data_ptr(),
        int(xr.dtype == torch.bfloat16), xdbl.data_ptr(), conv_w.data_ptr(),
        conv_b.data_ptr(), dt_proj_w.data_ptr(), dt_bias.data_ptr(),
        A.data_ptr(), D.data_ptr(), y.data_ptr(), b, k_dirs, seq_len, d_in,
        n, rank, taps, int(use_conv), int(delta_softplus),
        torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _raise_on(err, "mamba_scan")
    launches["mamba_scan"] += 1
    return y


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
    """Fused multi-direction Mamba inner function (forward).

    Args:
      xr: (B, L, D) row-major scan source; xc: (B, L, D) column-major
          source, or None (then K = x_proj_w.shape[0] must be 1 or 2).
      conv_w: (K, taps, D) or None (no conv); conv_b: (K, D) or None.
      x_proj_w: (K, R+2N, D); dt_proj_w: (K, D, R); dt_bias: (K, D).
      A: (K, D, N) (negative reals); D: (K, D).
      plain: run the plain versions on any device (for comparisons);
          otherwise the kernels run on CUDA tensors.
    Returns:
      y_dirs (B, K, L, D) in **source** order for every direction, in
      the sources' dtype.
    """
    k_dirs, _, d_in = x_proj_w.shape
    xr = xr.contiguous()
    xc = None if xc is None else xc.contiguous()
    f32 = dict(device=xr.device, dtype=torch.float32)
    if conv_w is None:
        use_conv = False
        conv_w = torch.zeros(k_dirs, _MAX_TAPS, d_in, **f32)
    if conv_b is None:
        conv_b = torch.zeros(k_dirs, d_in, **f32)

    def prep(t):
        return t.to(torch.float32).contiguous()

    conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A, D = map(
        prep, (conv_w, conv_b, x_proj_w, dt_proj_w, dt_bias, A, D)
    )
    if plain:
        x_dbl = xdbl_plain(xr, xc, conv_w, conv_b, x_proj_w, use_conv)
        return scan_plain(xr, xc, x_dbl, conv_w, conv_b, dt_proj_w, dt_bias,
                          A, D, delta_softplus, use_conv)
    x_dbl = xdbl_fwd(xr, xc, conv_w, conv_b, x_proj_w, use_conv)
    return scan_fwd(xr, xc, x_dbl, conv_w, conv_b, dt_proj_w, dt_bias, A, D,
                    delta_softplus, use_conv)
