"""Sequence-parallel selective scan: L sharded over a mesh axis.

Counterpart of ``medical_image_analysis_tpu/parallel/sp_scan.py``
(``selective_scan_sp``). For sequences too long for one card, each rank
holds ``L / S`` consecutive rows of the sequence (rank ``s`` of the axis the
``s``-th block), and the recurrence ``h[t] = a[t] h[t-1] + b[t]`` is
completed in two passes:

- pass 1: each rank scans its rows from a zero state and keeps its
  transition, ``A_s`` (the product of its decays) and ``B_s`` (its last
  state), each (batch, D, N);
- exchange: an ``all_gather`` of the pairs over the axis (O(batch D N)
  bytes, whatever L); every rank folds the ranks before it into the state
  entering its block, ``H = A_s H + B_s`` for s = 0 .. its index - 1;
- pass 2: the rank scans its rows again from that state.

The local scan is plain PyTorch, as the JAX package's is ``jnp`` (its
``_local_scan``, not the Pallas kernel): a loop over the rows in fp32.
"""

from __future__ import annotations

import torch

from ..ops.selective_scan import _broadcast_groups, softplus
from .mesh import Mesh, all_gather


def _local_scan(u, delta, A, B, C, D, delta_bias, delta_softplus, h0):
    """The scan of (batch, L, D) rows from state ``h0`` (batch, D, N):
    (y in u's dtype, the product of the decays, the last state)."""
    in_dtype = u.dtype
    d = u.shape[-1]
    u32 = u.float()
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()[None, None, :]
    if delta_softplus:
        dt = softplus(dt)
    a32 = A.float()
    bm = _broadcast_groups(B.float(), d)
    cm = _broadcast_groups(C.float(), d)
    h = h0
    cum = torch.ones_like(h0)
    ys = []
    for t in range(u.shape[1]):
        a = torch.exp(dt[:, t, :, None] * a32[None])
        h = a * h + (dt[:, t] * u32[:, t])[..., None] * bm[:, t]
        cum = cum * a
        ys.append(torch.sum(cm[:, t] * h, dim=-1))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D.float()[None, None, :] * u32
    return y.to(in_dtype), cum, h


def selective_scan_sp(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor | None,
    delta_bias: torch.Tensor | None,
    delta_softplus: bool,
    mesh: Mesh | None,
    axis: str = "data",
) -> torch.Tensor:
    """Selective scan with L sharded over ``axis`` of ``mesh``: u, delta
    (batch, L/S, D) and B, C (batch, L/S, N) or (batch, L/S, G, N) are this
    rank's block of rows; A (D, N), D and delta_bias (D,) are whole on every
    rank. Returns this rank's rows of y, in u's dtype (shapes as
    ``ops.selective_scan.selective_scan_ref``)."""
    batch, _, d = u.shape
    h0 = torch.zeros(batch, d, A.shape[-1], device=u.device,
                     dtype=torch.float32)
    args = (u, delta, A, B, C, D, delta_bias, delta_softplus)
    n_shards = 1 if mesh is None else mesh.size(axis)
    if n_shards == 1:
        return _local_scan(*args, h0)[0]
    _, cum_last, h_last = _local_scan(*args, h0)
    a_pairs = all_gather(cum_last[None], mesh, axis)  # (S, batch, D, N)
    b_pairs = all_gather(h_last[None], mesh, axis)
    h_in = h0
    for s in range(mesh.index(axis)):
        h_in = a_pairs[s] * h_in + b_pairs[s]
    return _local_scan(*args, h_in)[0]
