"""Selective scan (Mamba S6 recurrence), plain PyTorch oracle.

Counterpart of ``medical_image_analysis_tpu/ops/selective_scan.py:
selective_scan_ref``. Per batch b, channel d, state n, time t:

    dt[t]   = softplus(delta[t] + delta_bias)          (optional)
    a[t]    = exp(dt[t] * A[d, n])
    h[t]    = a[t] * h[t-1] + dt[t] * B[t, n] * u[t]
    y[t, d] = sum_n C[t, n] * h[t, d, n] + D[d] * u[t, d]

The recurrence runs in fp32 as a sequential loop over L (the JAX oracle
uses an associative scan; both compute the same first-order recurrence).
"""

from __future__ import annotations

import torch


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
