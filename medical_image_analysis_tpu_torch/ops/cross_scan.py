"""2D cross scan / merge: the four directional sequences of VMamba, and
the bidirectional 1D pair.

Counterpart of ``medical_image_analysis_tpu/ops/cross_scan.py``. Images
are channels-last ``(B, H, W, C)`` and sequences ``(B, K, L, C)``, with
directions k=0 row-major, k=1 column-major, k=2 reversed row-major, k=3
reversed column-major. Pure layout (transpose, flip, reshape): autograd
gives the exact adjoints.
"""

from __future__ import annotations

import torch


def cross_scan(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 4, H*W, C) directional sequences."""
    b, h, w, c = x.shape
    row = x.reshape(b, h * w, c)
    col = x.transpose(1, 2).reshape(b, h * w, c)
    return torch.stack([row, col, row.flip(1), col.flip(1)], dim=1)


def cross_merge(ys: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 4, H*W, C) -> (B, H*W, C), summing the four directions."""
    b, k, l, c = ys.shape
    if k != 4 or l != h * w:
        raise ValueError(f"cross_merge: got {tuple(ys.shape)} for {h}x{w}")
    row = ys[:, 0] + ys[:, 2].flip(1)
    col = ys[:, 1] + ys[:, 3].flip(1)
    col = col.reshape(b, w, h, c).transpose(1, 2).reshape(b, l, c)
    return row + col


def cross_scan_1d(x: torch.Tensor) -> torch.Tensor:
    """(B, L, C) -> (B, 2, L, C): the sequence forward and reversed."""
    return torch.stack([x, x.flip(1)], dim=1)


def cross_merge_1d(ys: torch.Tensor) -> torch.Tensor:
    """(B, 2, L, C) -> (B, L, C): the forward sequence plus the reversed
    one flipped back."""
    return ys[:, 0] + ys[:, 1].flip(1)
