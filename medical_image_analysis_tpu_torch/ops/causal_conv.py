"""Causal depthwise 1D convolution (the Mamba short conv), plain PyTorch.

Counterpart of ``medical_image_analysis_tpu/ops/causal_conv.py``. The
kernel width is tiny (4), so the conv is a sum of shifted slices over a
time-major ``(B, L, D)`` layout; :func:`causal_conv1d_update` is its
single-token decode step over a ``(B, K-1, D)`` state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    activation: str | None = "silu",
) -> torch.Tensor:
    """y[t] = sum_k w[k] * x[t - K + 1 + k], with zero left-padding.

    Args:
      x: (B, L, D).
      weight: (K, D) depthwise taps, tap K-1 multiplies x[t].
      bias: (D,) or None.
    """
    if activation not in ("silu", None):
        raise ValueError(f"unknown activation {activation}")
    k = weight.shape[0]
    seq_len = x.shape[1]
    pads = F.pad(x, (0, 0, k - 1, 0))
    y = None
    for i in range(k):
        term = pads[:, i : i + seq_len, :] * weight[i][None, None, :]
        y = term if y is None else y + term
    if bias is not None:
        y = y + bias[None, None, :]
    if activation == "silu":
        y = F.silu(y)
    return y


def causal_conv1d_update(
    x_t: torch.Tensor,
    conv_state: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    activation: str | None = "silu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step: ``y`` from the window ``conv_state + [x_t]``.

    Args:
      x_t: (B, D) the current input.
      conv_state: (B, K-1, D) the previous inputs, oldest first.
      weight: (K, D) depthwise taps.
    Returns:
      (y_t (B, D), new conv_state (B, K-1, D)).
    """
    if activation not in ("silu", None):
        raise ValueError(f"unknown activation {activation}")
    k = weight.shape[0]
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, K, D)
    y = torch.sum(window * weight[None], dim=1)
    if bias is not None:
        y = y + bias[None, :]
    if activation == "silu":
        y = F.silu(y)
    return y, window[:, 1:k, :]
