"""Selective scan (Mamba S6 recurrence): plain PyTorch versions and dispatcher.

Counterpart of ``medical_image_analysis_tpu/ops/selective_scan.py``
(``selective_scan_ref``, ``selective_scan``). Per batch b, channel d,
state n, time t:

    dt[t]   = softplus(delta[t] + delta_bias)          (optional)
    a[t]    = exp(dt[t] * A[d, n])
    h[t]    = a[t] * h[t-1] + dt[t] * B[t, n] * u[t]
    y[t, d] = sum_n C[t, n] * h[t, d, n] + D[d] * u[t, d]

The recurrence runs in fp32 as a sequential loop over L (the JAX oracle
uses an associative scan; both compute the same first-order recurrence).

``selective_scan_fwd_plain`` and ``selective_scan_bwd_plain`` are the
plain versions of the CUDA kernels of ``ops/selective_scan_pallas.py``, on
the kernels' folded layout: rows = batch x groups, and row r takes the
parameters of group ``r % G``. They return exactly what the two TPU kernels
return (``selective_scan_pallas.py:_fwd_kernel``, ``_bwd_kernel``) and
step over L, so that no (rows, L, D, N) tensor is ever made: at vssm_tiny's
stage 0 and B=128 one would hold 19.7 GB in fp32.
"""

from __future__ import annotations

import torch

BWD_CHUNK = 64  # rows of states the plain backward rebuilds at once


def softplus(x: torch.Tensor) -> torch.Tensor:
    """logaddexp(x, 0), the form ``jax.nn.softplus`` computes."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _broadcast_groups(x: torch.Tensor, d: int) -> torch.Tensor:
    """(batch, L, G, N) -> (batch, L, D, N) by repeating each group D/G times."""
    if x.ndim == 3:  # (batch, L, N): single group
        x = x[:, :, None, :]
    b, l, g, n = x.shape
    if g == d:
        return x
    if d % g:
        raise ValueError(f"channels {d} not divisible by groups {g}")
    return x[:, :, :, None, :].expand(b, l, g, d // g, n).reshape(b, l, d, n)


def selective_scan_ref(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor | None = None,
    delta_bias: torch.Tensor | None = None,
    delta_softplus: bool = False,
    return_last_state: bool = False,
):
    """Plain selective scan.

    Args:
      u:     (batch, L, D) input sequence.
      delta: (batch, L, D) timestep.
      A:     (D, N) state matrix (typically ``-exp(A_log)``).
      B, C:  (batch, L, N) or (batch, L, G, N).
      D:     (D,) skip weight or None.
      delta_bias: (D,) or None.
    Returns:
      y (batch, L, D) in u.dtype, and h[L-1] (batch, D, N) fp32 when
      ``return_last_state``.
    """
    in_dtype = u.dtype
    d = u.shape[-1]
    u = u.float()
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, None, :]
    if delta_softplus:
        delta = softplus(delta)
    A = A.float()
    Bm = _broadcast_groups(B.float(), d)  # (batch, L, D, N)
    Cm = _broadcast_groups(C.float(), d)

    a = torch.exp(delta[..., None] * A[None, None])  # (batch, L, D, N)
    bx = (delta * u)[..., None] * Bm
    h = torch.zeros_like(a[:, 0])
    ys = []
    for t in range(u.shape[1]):
        h = a[:, t] * h + bx[:, t]
        ys.append(torch.sum(Cm[:, t] * h, dim=-1))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D.float()[None, None, :] * u
    y = y.to(in_dtype)
    if return_last_state:
        return y, h
    return y


# --------------------------------------------------------------------------
# Plain versions of the kernels (folded layout)
# --------------------------------------------------------------------------


def _per_row(p: torch.Tensor, rows: int) -> torch.Tensor:
    """(G, ...) group parameters -> (rows, ...), row r taking group r % G."""
    return p.float().repeat(rows // p.shape[0], *([1] * (p.ndim - 1)))


class _Steps:
    """One row t of the scan's inputs at a time, in fp32: dt (through
    softplus when asked), softplus'(dt_raw) (ones without it), u, B, C."""

    def __init__(self, u, delta, B, C, delta_bias, delta_softplus):
        self.u, self.delta, self.B, self.C = u, delta, B, C
        self.bias = _per_row(delta_bias, u.shape[0])
        self.softplus = delta_softplus

    def __call__(self, t: int):
        raw = self.delta[:, t].float() + self.bias
        if self.softplus:
            dt, sg = softplus(raw), torch.sigmoid(raw)
        else:
            dt, sg = raw, torch.ones_like(raw)
        return (dt, sg, self.u[:, t].float(), self.B[:, t].float(),
                self.C[:, t].float())


def selective_scan_fwd_plain(u, delta, A, B, C, D, delta_bias,
                             delta_softplus=False):
    """Plain version of the forward kernel.

    u, delta (rows, L, Dc); A (G, Dc, N); B, C (rows, L, N); D,
    delta_bias (G, Dc); G divides rows. Returns y (rows, L, Dc) in u's
    dtype, with an fp32 state, as ``_fwd_kernel`` computes it.
    """
    rows, seq_len, _ = u.shape
    a_r, d_r = _per_row(A, rows), _per_row(D, rows)
    step = _Steps(u, delta, B, C, delta_bias, delta_softplus)
    h = u.new_zeros(a_r.shape, dtype=torch.float32)
    ys = []
    for t in range(seq_len):
        dt, _, ut, bt, ct = step(t)
        h = torch.exp(dt[..., None] * a_r) * h + (dt * ut)[..., None] * bt[:, None]
        ys.append(torch.sum(ct[:, None] * h, dim=-1) + ut * d_r)
    return torch.stack(ys, dim=1).to(u.dtype)


def selective_scan_bwd_plain(u, delta, A, B, C, D, delta_bias, dy,
                             delta_softplus=False):
    """Plain version of the backward kernel: the adjoint
    ``P[t] = C[t] dy[t] + a[t+1] P[t+1]`` as an explicit reverse loop.

    The forward states are rebuilt ``BWD_CHUNK`` rows at a time from
    carries saved every ``BWD_CHUNK`` rows. Returns ``(du, ddelta, dA, dB,
    dC, dD, ddelta_bias)``: du in u's dtype, ddelta in delta's, dB and dC
    (rows, L, N) in B's and C's, and dA (G, Dc, N), dD and ddelta_bias
    (G, Dc) in fp32, summed over the rows of each group (``_bwd_kernel``
    and ``_core_bwd``'s sums).
    """
    rows, seq_len, _ = u.shape
    groups = A.shape[0]
    a_r, d_r = _per_row(A, rows), _per_row(D, rows)
    step = _Steps(u, delta, B, C, delta_bias, delta_softplus)
    h = u.new_zeros(a_r.shape, dtype=torch.float32)
    carries = []
    for t in range(seq_len):
        if t % BWD_CHUNK == 0:
            carries.append(h)
        dt, _, ut, bt, _ = step(t)
        h = torch.exp(dt[..., None] * a_r) * h + (dt * ut)[..., None] * bt[:, None]

    du, ddelta = torch.empty_like(u), torch.empty_like(delta)
    f32 = dict(device=u.device, dtype=torch.float32)
    d_b = torch.empty(rows, seq_len, a_r.shape[-1], **f32)
    d_c = torch.empty_like(d_b)
    d_a, d_d = torch.zeros_like(h), torch.zeros_like(d_r)
    ddb = torch.zeros_like(d_r)
    g = torch.zeros_like(h)  # a[t+1] P[t+1], carried back
    for c in range(len(carries) - 1, -1, -1):
        t0 = c * BWD_CHUNK
        hs, ins = [carries[c]], []  # hs[i]: the state before row t0 + i
        for t in range(t0, min(seq_len, t0 + BWD_CHUNK)):
            dt, sg, ut, bt, ct = step(t)
            a = torch.exp(dt[..., None] * a_r)
            hs.append(a * hs[-1] + (dt * ut)[..., None] * bt[:, None])
            ins.append((dt, sg, ut, bt, ct, a))
        for i in range(len(ins) - 1, -1, -1):
            t = t0 + i
            dt, sg, ut, bt, ct, a = ins[i]
            dyt = dy[:, t].float()
            p = ct[:, None] * dyt[..., None] + g
            dloga = p * hs[i] * a  # the gradient w.r.t. dt * A
            gb = torch.sum(p * bt[:, None], dim=-1)
            ddt = (torch.sum(dloga * a_r, dim=-1) + gb * ut) * sg
            du[:, t] = dt * gb + dyt * d_r
            ddelta[:, t] = ddt
            d_b[:, t] = torch.sum(p * (dt * ut)[..., None], dim=1)
            d_c[:, t] = torch.sum(hs[i + 1] * dyt[..., None], dim=1)
            d_a += dloga * dt[..., None]
            d_d += dyt * ut
            ddb += ddt
            g = a * p

    def per_group(x):
        return x.reshape(rows // groups, groups, *x.shape[1:]).sum(dim=0)

    return (du, ddelta, per_group(d_a), d_b.to(B.dtype), d_c.to(C.dtype),
            per_group(d_d), per_group(ddb))


def selective_scan(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor | None = None,
    delta_bias: torch.Tensor | None = None,
    delta_softplus: bool = False,
    backend: str = "auto",
) -> torch.Tensor:
    """Selective scan dispatcher: the CUDA kernels or the plain reference.

    ``backend``: "auto" (the kernels for a CUDA tensor, ``selective_scan_ref``
    for a CPU tensor, as the JAX ``auto`` takes Pallas on the TPU),
    "pallas" (the kernels' route, :func:`.selective_scan_pallas.
    selective_scan_pallas`) or "ref".
    """
    if backend == "auto":
        backend = "pallas" if u.device.type == "cuda" else "ref"
    if backend == "pallas":
        from .selective_scan_pallas import selective_scan_pallas

        return selective_scan_pallas(u, delta, A, B, C, D, delta_bias,
                                     delta_softplus)
    if backend != "ref":
        raise ValueError(f"selective_scan: unknown backend {backend!r}")
    return selective_scan_ref(u, delta, A, B, C, D, delta_bias,
                              delta_softplus=delta_softplus)
