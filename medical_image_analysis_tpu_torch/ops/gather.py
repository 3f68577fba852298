"""Gathers whose backward is itself a gather, for permutation-structured
token selection (MAE masking and unshuffling).

Counterpart of ``medical_image_analysis_tpu/ops/gather.py``. MAE's
indices are injective by construction (``ids_keep`` is a prefix of a
shuffle permutation, ``ids_restore`` a full permutation), so the gradient
of ``y = x[ids]`` is a gather through the inverse map::

    dx = pad(dy, zeros)[inv]

where ``inv`` maps each input row to the output row that read it, or to a
zero row if none did. It is plain indexing on any device: no scatter-add,
so the gradient is the same in every run. The JAX package leaves these to
XLA, and they need no kernel.
"""

from __future__ import annotations

import torch


def take_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, ids[..., None], axis=1)`` for (B, L, D) x and
    (B, K) ids; autograd's own backward (a scatter)."""
    return torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))


class InjectiveGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids, inv):
        ctx.save_for_backward(inv)
        ctx.seq = x.shape[1]
        return take_rows(x, ids)

    @staticmethod
    def backward(ctx, dy):
        (inv,) = ctx.saved_tensors
        b, k, d = dy.shape
        seq = ctx.seq
        if k < seq:
            dy = torch.cat([dy, dy.new_zeros(b, seq - k, d)], dim=1)
        # the clamp sends inv entries past K into the zero pad
        return take_rows(dy, inv.clamp(max=seq - 1)), None, None


def injective_gather(x: torch.Tensor, ids: torch.Tensor,
                     inv: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` (B, K) of x (B, L, D), all distinct per batch, with a
    gather for a backward. ``inv`` (B, L): inv[b, j] is the position of j
    in ids[b] if present, else any index >= K."""
    return InjectiveGather.apply(x, ids, inv)


def subset_gather(x: torch.Tensor, ids_keep: torch.Tensor,
                  ids_restore: torch.Tensor) -> torch.Tensor:
    """Keep rows ``ids_keep`` of x (MAE mask selection). With ids_keep =
    ids_shuffle[:, :K] and ids_restore = argsort(ids_shuffle),
    ids_restore[b, j] < K iff row j was kept, and is then its position in
    ids_keep: the inverse map the backward needs."""
    return injective_gather(x, ids_keep, ids_restore)


def perm_gather(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Full-permutation gather (the MAE decoder's unshuffle); the inverse
    permutation is an argsort."""
    return injective_gather(x, perm, torch.argsort(perm, dim=1))
