"""AdamW with global-norm clipping and a warmup-cosine schedule.

Counterpart of ``medical_image_analysis_tpu/train/optim.py``
(``make_adamw``, ``warmup_cosine``, ``scaled_lr``, ``no_decay_mask``),
holding to optax's arithmetic rather than ``torch.optim``'s:

- ``optax.clip_by_global_norm``: the update is scaled by ``max/norm``
  only when ``norm >= max`` (``t / norm * max``); torch's
  ``clip_grad_norm_`` scales by ``max/(norm+1e-6)`` whenever
  ``norm > max``.
- ``optax.adamw``: bias-corrected moments, ``eps`` outside the root,
  decoupled decay ``wd * param`` added to the Adam direction *before*
  the learning rate multiplies both, and the schedule read at the
  update count before this update, so the first update uses ``lr(0)``
  (0 under warmup).
- ``optax.masked`` over the trainable leaves: the optimizer holds only
  trainable tensors, so the clip norm is taken over them alone.

Parameters are named by their flax paths (``peft.lora.flax_path``, with
``kernel``/``scale``/``embedding`` leaves), so the no-decay patterns read
the names they were written for: a torch name would call a LayerNorm's
``scale`` "weight" and decay it.
"""

from __future__ import annotations

import math
import re
from typing import Callable

import torch

NO_DECAY_PATTERNS = (
    "bias", "scale", "pos_embed", "cls_token", "A_log", r"(^|/)D$",
    "logit_scale", "embedding", "ar_token", "mask_token",
)

Schedule = Callable[[int], float]


def no_decay_mask(names) -> dict[str, bool]:
    """flax path -> True where weight decay applies."""
    return {
        n: not any(re.search(pat, n) for pat in NO_DECAY_PATTERNS)
        for n in names
    }


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_lr: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule(0, base_lr, max(warmup, 1),
    max(total, warmup + 1), min_lr)``: linear from 0 at count 0 to
    ``base_lr`` at ``warmup``, then a half cosine to ``min_lr``."""
    warmup = max(warmup_steps, 1)
    decay_steps = max(total_steps, warmup_steps + 1) - warmup
    if decay_steps <= 0:
        raise ValueError(f"warmup_cosine: no decay steps (warmup {warmup}, "
                         f"total {total_steps})")
    alpha = 0.0 if base_lr == 0.0 else min_lr / base_lr

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1.0 - min(max(count, 0), warmup) / warmup
            return -base_lr * frac + base_lr
        c = min(count - warmup, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def scaled_lr(blr: float, global_batch: int) -> float:
    """blr * batch / 256."""
    return blr * global_batch / 256.0


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (fp32)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class AdamW:
    """optax ``chain(clip_by_global_norm, adamw)`` over named tensors.

    ``step(grads)`` updates the parameters in place and returns the
    learning rate it used. Decay applies where :func:`no_decay_mask`
    says so for the parameter's name. The state (``count``, ``mu``,
    ``nu``) is fp32 and lives on the parameters' device.
    """

    def __init__(self, params: dict[str, torch.Tensor], lr: Schedule,
                 weight_decay: float = 0.05, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: float | None = 1.0):
        self.params = params
        self.lr = lr
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = grad_clip
        self.decay = no_decay_mask(params)
        self.count = 0
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor]) -> float:
        if grads.keys() != self.params.keys():
            raise KeyError("AdamW.step: grads and params name different "
                           "tensors")
        if self.grad_clip:
            norm = global_norm(grads.values())
            # where(norm < max, g, g / norm * max), without a host sync
            scale = torch.where(norm < self.grad_clip,
                                torch.ones_like(norm),
                                self.grad_clip / norm)
            grads = {n: g.float() * scale for n, g in grads.items()}
        lr = self.lr(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for n, p in self.params.items():
            g = grads[n].float()
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay and self.decay[n]:
                upd = upd + self.weight_decay * p.float()
            p.add_((-lr * upd).to(p.dtype))
        return lr

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for n in self.params:
            self.mu[n].copy_(state["mu"][n])
            self.nu[n].copy_(state["nu"][n])


def make_adamw(params: dict[str, torch.Tensor], lr: Schedule,
               weight_decay: float = 0.05, b1: float = 0.9,
               b2: float = 0.999, grad_clip: float | None = 1.0) -> AdamW:
    """The JAX package's ``make_adamw`` over the trainable tensors
    ``params`` (flax-path names), with decay masked by name."""
    return AdamW(params, lr, weight_decay=weight_decay, b1=b1, b2=b2,
                 grad_clip=grad_clip)
