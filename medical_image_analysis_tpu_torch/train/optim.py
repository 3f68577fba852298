"""AdamW with global-norm clipping and a warmup-cosine schedule, and LARS.

Counterpart of ``medical_image_analysis_tpu/train/optim.py``
(``make_adamw`` with its ``layer_decay``, ``layer_decay_scales``,
``make_lars``, ``warmup_cosine``, ``scaled_lr``, ``no_decay_mask``),
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

- layer-wise decay (``make_adamw(layer_decay=(decay, num_layers))``):
  each update scaled by :func:`layer_decay_scales`' factor after AdamW, as
  the JAX chain's last transformation does;
- ``optax.lars`` (:class:`LARS`): decoupled weight decay on every tensor
  (optax's default ``weight_decay_mask=True``), the trust ratio
  ``coef * |p| / |u|`` (1 where either norm is 0), the learning rate, then
  a momentum trace.

Under ZeRO-1 (``train_state.make_train_step(zero_opt=True)``) an
optimizer keeps its state for this data rank's slice of each large tensor
(``shards``) and updates only that slice; the step gathers the rest.

Parameters are named by their flax paths (``peft.lora.flax_path``, with
``kernel``/``scale``/``embedding`` leaves), so the no-decay patterns read
the names they were written for: a torch name would call a LayerNorm's
``scale`` "weight" and decay it.
"""

from __future__ import annotations

import math
import re
from typing import Callable

import numpy as np
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


def layer_decay_scales(names, decay: float, num_layers: int) -> dict:
    """name -> ``decay ** (num_layers + 1 - layer)``, the layer index read
    from ``layers_7`` / ``block7`` / ``stage2_block1`` as ``7 + 1`` (0 where
    the name has none), as the JAX function reads flax paths."""
    out = {}
    for n in names:
        m = re.search(r"(?:layers?_|block)(\d+)", n)
        layer = int(m.group(1)) + 1 if m else 0
        out[n] = decay ** (num_layers + 1 - layer)
    return out


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (fp32)."""
    return torch.sqrt(sq_norm(tensors))


def sq_norm(tensors) -> torch.Tensor:
    """The sum of squares of every element (fp32)."""
    return sum(torch.sum(t.float() * t.float()) for t in tensors)


def _owned(t: torch.Tensor, shard) -> torch.Tensor:
    """The slice ``shard`` = (axis, start, length) of ``t`` (a view), or
    ``t`` where None."""
    return t if shard is None else t.narrow(*shard)


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
                 grad_clip: float | None = 1.0,
                 layer_scales: dict[str, float] | None = None,
                 shards: dict | None = None):
        self.params = params
        self.lr = lr
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = grad_clip
        self.layer_scales = layer_scales
        self.decay = no_decay_mask(params)
        self.count = 0
        # name -> (axis, start, length): the slice this rank updates (ZeRO)
        self.shards = shards or {}
        self.mu = {n: torch.zeros_like(_owned(p, self.shards.get(n)),
                                       dtype=torch.float32)
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(m) for n, m in self.mu.items()}

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor],
             norm: torch.Tensor | None = None) -> float:
        """Update the parameters (their owned slices) in place from
        ``grads``; ``norm``, when given, is the clip's global norm (the
        sharded step's, over every rank's tensors). Returns the learning
        rate used."""
        if grads.keys() != self.params.keys():
            raise KeyError("AdamW.step: grads and params name different "
                           "tensors")
        if self.grad_clip:
            if norm is None:
                norm = global_norm(grads.values())
            # where(norm < max, g, g / norm * max), without a host sync
            scale = torch.where(norm < self.grad_clip,
                                torch.ones_like(norm),
                                self.grad_clip / norm)
            grads = {n: g.float() * scale for n, g in grads.items()}
        lr = self.lr(self.count)
        self.count += 1
        # the bias corrections in fp32, as optax takes them: 1 - 0.999 in
        # fp32 is 1.3e-5 off 1e-3, which moves every update by 6e-6
        c1, c2 = (float(np.float32(1.0) - np.float32(b) ** np.float32(
            self.count)) for b in (self.b1, self.b2))
        for n, p_all in self.params.items():
            shard = self.shards.get(n)
            p = _owned(p_all, shard)
            g = _owned(grads[n], shard).float()
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay and self.decay[n]:
                upd = upd + self.weight_decay * p.float()
            upd = -lr * upd
            if self.layer_scales is not None:
                upd = upd * self.layer_scales[n]
            p.add_(upd.to(p.dtype))
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
               b2: float = 0.999, grad_clip: float | None = 1.0,
               layer_decay: tuple[float, int] | None = None,
               shards: dict | None = None) -> AdamW:
    """The JAX package's ``make_adamw`` over the trainable tensors
    ``params`` (flax-path names), with decay masked by name and, with
    ``layer_decay = (decay, num_layers)``, each update scaled by
    :func:`layer_decay_scales`. ``shards`` as :class:`AdamW`'s."""
    scales = (None if layer_decay is None
              else layer_decay_scales(params, *layer_decay))
    return AdamW(params, lr, weight_decay=weight_decay, b1=b1, b2=b2,
                 grad_clip=grad_clip, layer_scales=scales, shards=shards)


class LARS:
    """``optax.lars(lr, weight_decay, momentum=momentum)`` over named
    tensors: ``u = g + wd * p``; ``u *= coef * |p| / (|u| + eps)`` where
    both norms are non-zero; ``u *= -lr(count)``; the trace ``t = u +
    momentum * t`` is the update (``nesterov``: ``u + momentum * t``).
    ``lr`` is a schedule or a number."""

    def __init__(self, params: dict[str, torch.Tensor], lr,
                 weight_decay: float = 0.0, momentum: float = 0.9,
                 trust_coefficient: float = 0.001, eps: float = 0.0,
                 nesterov: bool = False):
        self.params = params
        self.lr = lr if callable(lr) else (lambda _count: lr)
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.trust_coefficient, self.eps = trust_coefficient, eps
        self.nesterov = nesterov
        self.count = 0
        self.trace = {n: torch.zeros_like(p, dtype=torch.float32)
                      for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor]) -> float:
        lr = self.lr(self.count)
        self.count += 1
        for n, p in self.params.items():
            u = grads[n].float() + self.weight_decay * p.float()
            p_norm = torch.linalg.vector_norm(p.float())
            u_norm = torch.linalg.vector_norm(u)
            ratio = self.trust_coefficient * p_norm / (u_norm + self.eps)
            u = u * torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(ratio), ratio)
            u = -lr * u
            t = self.trace[n]
            t.mul_(self.momentum).add_(u)
            step = u + self.momentum * t if self.nesterov else t
            p.add_(step.to(p.dtype))
        return lr

    def state_dict(self) -> dict:
        return {"count": self.count, "trace": self.trace}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for n in self.params:
            self.trace[n].copy_(state["trace"][n])


def make_lars(params: dict[str, torch.Tensor], lr, weight_decay: float = 0.0,
              momentum: float = 0.9) -> LARS:
    """The JAX package's ``make_lars`` over the tensors ``params``."""
    return LARS(params, lr, weight_decay=weight_decay, momentum=momentum)
