"""The training step on one device: accumulation, AdamW, optional EMA.

Counterpart of ``medical_image_analysis_tpu/train/train_state.py`` without
the mesh, tensor parallelism and ZeRO (ROADMAP.md, queue 1, item 18).

- The trainable tensors are named (flax paths) and owned by the
  :class:`TrainState`; frozen tensors stay in the model with
  ``requires_grad=False``, so no gradient is computed for them. (The JAX
  step computes the frozen LLM's gradients and zeroes them in the
  optimizer.)
- ``grad_norm`` is the global norm of the averaged gradients of the
  trainable tensors, before clipping. The JAX step's ``grad_norm`` also
  counts the frozen gradients it computed.
- Accumulation splits the leading batch axis into ``accum_steps``
  contiguous micro-batches, sums their fp32 gradients and mean losses,
  and divides both by ``accum_steps`` (``_accum_value_and_grad``).
"""

from __future__ import annotations

from typing import Callable

import torch

from .optim import AdamW, global_norm


class TrainState:
    """step, trainable params, optimizer state and the EMA shadow.

    ``frozen`` names the run's other tensors, so that a saved state holds
    every tensor of the model, as the JAX package's does.
    """

    def __init__(self, params: dict[str, torch.Tensor], tx: AdamW,
                 ema: bool = False,
                 frozen: dict[str, torch.Tensor] | None = None):
        self.step = 0
        self.params = params
        self.frozen = frozen or {}
        self.tx = tx
        self.ema_params = (
            {n: p.detach().clone() for n, p in params.items()} if ema
            else None
        )

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "params": {n: p.detach() for n, p in self.params.items()},
            "frozen": {n: p.detach() for n, p in self.frozen.items()},
            "opt": self.tx.state_dict(),
            "ema": self.ema_params,
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a saved state in; the trainable and frozen names must be
        the saved ones (``KeyError``)."""
        for part, mine in (("params", self.params), ("frozen", self.frozen)):
            if state[part].keys() != mine.keys():
                diff = sorted(set(state[part]) ^ set(mine))
                raise KeyError(f"TrainState.load_state_dict: {part} differ "
                               f"from the saved state's: {diff[:5]}")
        self.step = int(state["step"])
        for n, p in self.params.items():
            p.copy_(state["params"][n])
        for n, p in self.frozen.items():
            p.copy_(state["frozen"][n])
        self.tx.load_state_dict(state["opt"])
        if self.ema_params is not None:
            for n, e in self.ema_params.items():
                e.copy_(state["ema"][n])


def accum_value_and_grad(loss_fn: Callable, params: dict[str, torch.Tensor],
                         batch: dict, accum_steps: int):
    """(mean loss, mean fp32 grads) over ``accum_steps`` micro-batches cut
    from the leading axis of every tensor in ``batch``."""
    names = list(params)
    tensors = [params[n] for n in names]
    if accum_steps <= 1:
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, tensors)
        return loss.detach(), dict(zip(names, grads))
    b = next(iter(batch.values())).shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} is not divisible by accum_steps "
                         f"{accum_steps}")
    mb = b // accum_steps
    loss_sum = torch.zeros((), device=tensors[0].device)
    g_sum = [torch.zeros_like(t, dtype=torch.float32) for t in tensors]
    for i in range(accum_steps):
        micro = {k: v[i * mb : (i + 1) * mb] for k, v in batch.items()}
        loss = loss_fn(micro)
        grads = torch.autograd.grad(loss, tensors)
        for acc, g in zip(g_sum, grads):
            acc.add_(g.float())
        loss_sum = loss_sum + loss.detach()
    inv = 1.0 / accum_steps
    return loss_sum * inv, {
        n: (g * inv).to(t.dtype) for n, g, t in zip(names, g_sum, tensors)
    }


def make_train_step(loss_fn: Callable, accum_steps: int = 1,
                    ema_decay: float = 0.0,
                    check: Callable | None = None):
    """``step(state, batch) -> {"loss", "grad_norm", "lr"}``, updating
    ``state`` in place. ``loss_fn(batch)`` is a scalar tensor; ``batch``
    maps names to tensors on the device. ``check(loss, grads)``, when
    given, sees the loss and the gradients before the update
    (``train.debug_nans``)."""

    def step(state: TrainState, batch: dict) -> dict:
        loss, grads = accum_value_and_grad(loss_fn, state.params, batch,
                                           accum_steps)
        if check is not None:
            check(loss, grads)
        gnorm = global_norm(grads.values())
        lr = state.tx.step(grads)
        if state.ema_params is not None and ema_decay > 0.0:
            with torch.no_grad():
                for n, e in state.ema_params.items():
                    p = state.params[n]
                    e.copy_((ema_decay * e.float()
                             + (1.0 - ema_decay) * p.float()).to(e.dtype))
        state.step += 1
        return {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step
