"""The reference's first training steps, and the readings taken of them.

:func:`follow` runs a family's plain forward and backward with
:class:`reference.common.AdamW` over the same weights and the same
batches that the program took, and reads what the program's side reads
(:func:`readings`): each step's loss, each trainable tensor's first
gradient as the optimizer takes it (its first moment after one step over
``1 - b1``), each tensor's gradient norm at every step, and each tensor's
change after the steps.
"""

from __future__ import annotations

import torch

from reference.common import AdamW, Products, exact_fp32


def follow(ref, cfg, weights: dict, batch_fn, steps: int,
           precision: str = "exact") -> dict:
    """``ref`` is a family's reference module (``param_specs``,
    ``trainable``, ``loss_and_grads``); ``batch_fn(i)`` the batch of step
    ``i``. The weights of trainable names are copied to fp32 leaves; the
    others are read as they are."""
    P = Products(precision)
    names = ref.trainable(cfg)
    w = dict(weights)
    for n in names:
        w[n] = weights[n].detach().float().clone().requires_grad_(True)
    start = {n: w[n].detach().clone() for n in names}
    opt = AdamW({n: w[n] for n in names}, cfg["optimizer"])
    out = {"loss": [], "grad_norms": [], "grad1": {}, "change": {}}
    with exact_fp32():
        for i in range(steps):
            for n in names:
                w[n].grad = None
            loss, grads = ref.loss_and_grads(cfg, P, w, batch_fn(i), names)
            grads = {n: torch.zeros_like(w[n]) if g is None else g
                     for n, g in grads.items()}
            out["loss"].append(float(loss))
            out["grad_norms"].append({n: float(torch.linalg.vector_norm(g))
                                      for n, g in grads.items()})
            opt.step(grads)
            if i == 0:
                out["grad1"] = {n: float(torch.linalg.vector_norm(opt.mu[n]))
                                / (1.0 - opt.b1) for n in names}
    out["change"] = {n: float(torch.linalg.vector_norm(
        w[n].detach() - start[n])) for n in names}
    return out
